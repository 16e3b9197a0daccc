"""Plain PyTorch versions of the port's kernels: the semantics contract.

Each CUDA kernel in ``csrc/`` is held bit for bit against the function of
the same name here: by ``chip_smoke.py`` on the card, and by the tests on
the CPU against ``repro.kernels.ref``.  ``repro_torch.kernels.ops`` calls
these for tensors that lie on the CPU, and only for those.

Lanes are int32 tensors holding uint32 bit patterns; the math runs in int64
masked to 32 bits (``repro_torch.core.hashing``).  The paged-attention
functions and ``fused_norm_matmul_ref`` keep ``repro.kernels.ref``'s
layouts and compute in float32.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import slots
from repro_torch.core.hashing import hash64_32, i32, slot_hash, u32


def ludo_lookup_ref(key_lo, key_hi, words_a, words_b, seeds, *, ma, mb, nb,
                    seed_a, seed_b, seed_ba, seed_bb):
    """Batched CN locator math: keys -> (bucket, slot), both int32."""
    ia = hash64_32(key_lo, key_hi, seed_a) % ma
    ib = hash64_32(key_lo, key_hi, seed_b) % mb
    bit_a = (u32(words_a[ia >> 5]) >> (ia & 31)) & 1
    bit_b = (u32(words_b[ib >> 5]) >> (ib & 31)) & 1
    b0 = hash64_32(key_lo, key_hi, seed_ba) % nb
    b1 = hash64_32(key_lo, key_hi, seed_bb) % nb
    bucket = torch.where((bit_a ^ bit_b).bool(), b1, b0)
    slot = slot_hash(key_lo, key_hi, seeds[bucket].to(torch.int64))
    return bucket.to(torch.int32), slot.to(torch.int32)


def slot_unpack_ref(s_lo, s_hi):
    """Packed 64-bit DMPH slots -> (cache, fp, length, addr), all int32;
    ``addr`` is the uint32 ``addr_lo`` as an int32 bit pattern."""
    f = slots.unpack(s_lo, s_hi)
    return (f["cache"].to(torch.int32), f["fp"].to(torch.int32),
            f["len"].to(torch.int32), i32(f["addr_lo"]))


def paged_attention_ref(q, k_pool, v_pool, page_map, seq_len):
    """Flash-decode oracle over a paged KV pool (one sequence).

    q:        (n_kv, group, d)     GQA query heads grouped per KV head
    k_pool:   (P, ps, n_kv, d)     physical page pool
    v_pool:   (P, ps, n_kv, d)
    page_map: (L,) int32           logical page -> physical page
    seq_len:  int                  valid tokens
    Returns the float32 flash partials (o, m, l): ``(n_kv, g, d)``,
    ``(n_kv, g)``, ``(n_kv, g)``.  On the card the products run in full
    float32 only while ``torch.backends.cuda.matmul.allow_tf32`` is False.
    """
    L = page_map.shape[0]
    ps = k_pool.shape[1]
    n_kv, g, d = q.shape
    pm = page_map.long()
    k = k_pool[pm].reshape(L * ps, n_kv, d).transpose(0, 1)  # (n_kv, S, d)
    v = v_pool[pm].reshape(L * ps, n_kv, d).transpose(0, 1)
    scores = torch.einsum("hgd,hsd->hgs", q.float(), k.float()) \
        / math.sqrt(float(d))
    pos = torch.arange(L * ps, device=q.device)
    scores = torch.where(pos[None, None, :] < int(seq_len), scores,
                         float("-inf"))
    m = scores.max(dim=-1).values
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("hgs,hsd->hgd", p, v.float()) / l[..., None]
    return o, m, l


def combine_flash_partials(o_parts, m_parts, l_parts):
    """Combine flash partials from independent KV ranges: re-weight each
    normalised ``o`` by ``exp(m - m_max) * l`` and renormalise by the sum of
    the weights."""
    m_max = torch.stack(list(m_parts)).max(dim=0).values  # (n_kv, g)
    num, den = 0.0, 0.0
    for o, m, l in zip(o_parts, m_parts, l_parts):
        w = torch.exp(m - m_max) * l
        num = num + o * w[..., None]
        den = den + w
    return num / den[..., None]


def fused_norm_matmul_ref(x, gamma, w, eps: float = 1e-6):
    """``RMSNorm(x) * gamma @ w``, the dense-arch QKV/MLP entry: x (S, d),
    gamma (d,), w (d, F).  The norm and the product run in float32 and the
    result has the dtype of ``x``; on the card the product is full float32
    only while ``torch.backends.cuda.matmul.allow_tf32`` is False."""
    xf = x.float()
    nrm = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return ((nrm * gamma.float()) @ w.float()).to(x.dtype)
