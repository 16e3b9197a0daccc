"""Wrappers around the port's CUDA kernels, dispatched by the tensor's device.

A CUDA tensor gets the hand-written kernel (``csrc/*.cu``, built at first
use by ``repro_torch.kernels.build``) or an error: never the plain version.
A CPU tensor gets the plain PyTorch version from ``ref.py``, which is how
the tests run the same path on a machine without a card.

Every wrapper takes int32 tensors holding uint32 bit patterns, checks
device, dtype, shape, contiguity and the bounds its kernel relies on, and
raises on anything the kernel does not take.  The kernel masks its own
ragged edge, so no padding is needed.  It launches on the current stream
and raises if ``cudaGetLastError()`` is not 0.  :data:`LAUNCHES` counts the
launches of each kernel, and nothing else adds to it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"ludo_lookup": 0, "slot_unpack": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name: str, t, dtype: torch.dtype, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor, got shape "
                         f"{tuple(t.shape)} (contiguous={t.is_contiguous()})")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with cudaError {err}")


def ludo_lookup(key_lo, key_hi, words_a, words_b, seeds, meta: dict):
    """Batched CN locator: keys -> (bucket, slot), int32 each.

    ``words_a``/``words_b`` are the Othello words (int32 bit patterns),
    ``seeds`` the per-bucket uint8 seeds, and ``meta`` =
    ``dict(ma, mb, nb, seed_a, seed_b, seed_ba, seed_bb)`` (see
    :func:`cn_meta_from`)."""
    device = key_lo.device if isinstance(key_lo, torch.Tensor) else None
    _check("key_lo", key_lo, torch.int32, device)
    _check("key_hi", key_hi, torch.int32, device)
    _check("words_a", words_a, torch.int32, device)
    _check("words_b", words_b, torch.int32, device)
    _check("seeds", seeds, torch.uint8, device)
    n = int(key_lo.shape[0])
    if key_hi.shape[0] != n:
        raise ValueError(f"key_lo/key_hi lengths differ: {n} vs "
                         f"{key_hi.shape[0]}")
    ma, mb, nb = int(meta["ma"]), int(meta["mb"]), int(meta["nb"])
    if not 0 < ma <= 32 * words_a.shape[0] or not 0 < mb <= 32 * words_b.shape[0]:
        raise ValueError(f"Othello sizes ma={ma}, mb={mb} exceed the words "
                         f"given ({words_a.shape[0]}, {words_b.shape[0]})")
    if not 0 < nb <= seeds.shape[0]:
        raise ValueError(f"nb={nb} exceeds the {seeds.shape[0]} seeds given")
    if n >= 2**31:
        raise ValueError(f"batch of {n} keys exceeds the kernel's int index")
    if device.type == "cpu":
        return ref.ludo_lookup_ref(
            key_lo, key_hi, words_a, words_b, seeds, ma=ma, mb=mb, nb=nb,
            seed_a=meta["seed_a"], seed_b=meta["seed_b"],
            seed_ba=meta["seed_ba"], seed_bb=meta["seed_bb"])
    if device.type != "cuda":
        raise ValueError(f"ludo_lookup runs on cuda or cpu, not {device}")
    bucket = torch.empty(n, dtype=torch.int32, device=device)
    slot = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        fn = build.launcher("ludo_lookup")
        with torch.cuda.device(device):
            err = fn(key_lo.data_ptr(), key_hi.data_ptr(), words_a.data_ptr(),
                     words_b.data_ptr(), seeds.data_ptr(), bucket.data_ptr(),
                     slot.data_ptr(), n, ma, mb, nb,
                     int(meta["seed_a"]) & 0xFFFFFFFF,
                     int(meta["seed_b"]) & 0xFFFFFFFF,
                     int(meta["seed_ba"]) & 0xFFFFFFFF,
                     int(meta["seed_bb"]) & 0xFFFFFFFF, _stream(device))
        _raise_on(err, "ludo_lookup")
        LAUNCHES["ludo_lookup"] += 1
    return bucket, slot


def slot_unpack(s_lo, s_hi):
    """Packed 64-bit DMPH slots -> (cache, fp, length, addr), int32 each
    (``addr`` is the uint32 address as an int32 bit pattern)."""
    device = s_lo.device if isinstance(s_lo, torch.Tensor) else None
    _check("s_lo", s_lo, torch.int32, device)
    _check("s_hi", s_hi, torch.int32, device)
    n = int(s_lo.shape[0])
    if s_hi.shape[0] != n:
        raise ValueError(f"s_lo/s_hi lengths differ: {n} vs {s_hi.shape[0]}")
    if n >= 2**31:
        raise ValueError(f"batch of {n} slots exceeds the kernel's int index")
    if device.type == "cpu":
        return ref.slot_unpack_ref(s_lo, s_hi)
    if device.type != "cuda":
        raise ValueError(f"slot_unpack runs on cuda or cpu, not {device}")
    outs = tuple(torch.empty(n, dtype=torch.int32, device=device)
                 for _ in range(4))
    if n:
        fn = build.launcher("slot_unpack")
        with torch.cuda.device(device):
            err = fn(s_lo.data_ptr(), s_hi.data_ptr(),
                     *(o.data_ptr() for o in outs), n, _stream(device))
        _raise_on(err, "slot_unpack")
        LAUNCHES["slot_unpack"] += 1
    return outs


def cn_meta_from(shard_or_cn) -> dict:
    """The kernel meta dict of an ``OutbackShard`` or a ``LudoCN``."""
    from repro_torch.core.ludo import SEED_BUCKET_A, SEED_BUCKET_B
    cn = getattr(shard_or_cn, "cn", shard_or_cn)
    oth = cn.othello
    return dict(ma=oth.ma, mb=oth.mb, nb=cn.num_buckets,
                seed_a=oth.seed_a, seed_b=oth.seed_b,
                seed_ba=SEED_BUCKET_A, seed_bb=SEED_BUCKET_B)
