"""Packed bit arrays over 32-bit words, as int32 bit-pattern tensors.

The Othello bucket locator is two plain bit arrays; memory accounting in the
paper is in bits/key, so exactly ``ceil(m/32)`` words are stored and indexed
with shift/mask.
"""

from __future__ import annotations

import torch

from repro_torch.core.hashing import i32, u32


def alloc_bits(m: int, device="cpu") -> torch.Tensor:
    """Allocate an m-bit array (zeroed), packed into int32 words."""
    return torch.zeros(max(1, (int(m) + 31) // 32), dtype=torch.int32,
                       device=device)


def get_bit(words: torch.Tensor, idx) -> torch.Tensor:
    """Read bit(s) ``idx`` (any integer tensor) from packed ``words``."""
    idx = u32(idx)
    w = u32(words[idx >> 5])
    return (w >> (idx & 31)) & 1


def set_bit(words: torch.Tensor, idx: int, value: int) -> None:
    """In-place single-bit write (construction path)."""
    w, b = int(idx) >> 5, int(idx) & 31
    cur = int(u32(words[w]))
    cur = cur | (1 << b) if value else cur & ~(1 << b)
    words[w] = i32(cur)


def flip_bits(words: torch.Tensor, idxs) -> None:
    """In-place xor-flip of a set of distinct bit positions.

    Distinct positions make the per-word xor of their masks equal to
    their sum, so one ``index_add_`` replaces numpy's ``bitwise_xor.at``.
    """
    idxs = torch.as_tensor(idxs, dtype=torch.int64, device=words.device)
    flips = torch.zeros(words.shape[0], dtype=torch.int64, device=words.device)
    flips.index_add_(0, idxs >> 5, torch.ones_like(idxs) << (idxs & 31))
    words.copy_(i32(u32(words) ^ flips))


def pack_bits(node_bits: torch.Tensor) -> torch.Tensor:
    """A 0/1 tensor of m node bits -> packed int32 words."""
    m = int(node_bits.shape[0])
    words = torch.zeros(max(1, (m + 31) // 32), dtype=torch.int64,
                        device=node_bits.device)
    idx = torch.nonzero(node_bits).flatten()
    words.index_add_(0, idx >> 5, torch.ones_like(idx) << (idx & 31))
    return i32(words)


def nbits(words: torch.Tensor) -> int:
    return int(words.shape[0]) * 32
