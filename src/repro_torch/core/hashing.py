"""Integer hash primitives on torch tensors, bit-identical to ``repro.core.hashing``.

Keys are 64-bit, carried as two 32-bit lanes ``(lo, hi)``.  torch's
``uint32`` has no shifts on the CPU, so the port keeps every lane as an
``int32`` tensor holding the uint32 bit pattern (:func:`lanes`), and the
eager hash math here runs in ``int64`` masked to 32 bits:

* every function accepts any integer tensor (or Python int) and reads it
  as uint32 (``x & 0xFFFFFFFF`` after widening, so an int32 ``-1`` is the
  lane ``0xFFFFFFFF``);
* every function returns an ``int64`` tensor with values in ``[0, 2^32)``;
* an int64 product of two 32-bit lanes may wrap past 2^63, but its low 32
  bits are still the uint32 product, so masking after each multiply
  reproduces C-style wrapping uint32 arithmetic exactly.

The CUDA kernels (``repro_torch.kernels``) do the same math in native
``uint32_t``; these functions are the build path's and the plain versions'.
The ``*_int`` twins compute the same values on Python ints for the scalar
protocol walks, and ``split_u64``/``join_u64``/``splitmix64`` are host
numpy helpers for key sets.
"""

from __future__ import annotations

import numpy as np
import torch

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_C3 = 0x27D4EB2F
_C4 = 0x165667B1
_GOLDEN = 0x9E3779B9

_M32 = 0xFFFFFFFF


def u32(x) -> torch.Tensor:
    """Any integer tensor (or int) read as uint32 -> int64 in [0, 2^32)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=torch.int64)
    return x.to(torch.int64) & _M32


def i32(x) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor of the same bit pattern."""
    x = u32(x)
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def i32_int(v: int) -> int:
    """A uint32 Python int as the int32 value of the same bit pattern."""
    v &= _M32
    return v - (1 << 32) if v >= 1 << 31 else v


def lanes(a: np.ndarray, device) -> torch.Tensor:
    """Host uint32 lanes -> int32 bit-pattern tensor on ``device``."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def to_u32_numpy(t: torch.Tensor) -> np.ndarray:
    """An int32 bit-pattern (or int64 uint32-valued) tensor -> host uint32."""
    return u32(t).cpu().numpy().astype(np.uint32)


def fmix32(h) -> torch.Tensor:
    """Murmur3 32-bit finalizer. Bijective on uint32."""
    h = u32(h)
    h = h ^ (h >> 16)
    h = (h * _C1) & _M32
    h = h ^ (h >> 13)
    h = (h * _C2) & _M32
    return h ^ (h >> 16)


def hash64_32(lo, hi, seed) -> torch.Tensor:
    """Hash a 64-bit key (two lanes) + 32-bit seed -> uint32 value."""
    lo, hi, seed = u32(lo), u32(hi), u32(seed)
    h = seed ^ _GOLDEN
    h = (fmix32(h ^ lo) * _C3) & _M32
    h = (fmix32(h ^ hi) * _C4) & _M32
    return fmix32(h)


def hash_range(lo, hi, seed, size) -> torch.Tensor:
    """Hash a 64-bit key into ``[0, size)``."""
    return hash64_32(lo, hi, seed) % u32(size)


def slot_hash(lo, hi, bucket_seed) -> torch.Tensor:
    """Ludo in-bucket slot locator: seeded hash of the key -> slot in [0, 4)."""
    lo, hi, s = u32(lo), u32(hi), u32(bucket_seed)
    h = fmix32(lo ^ ((s * _C1) & _M32) ^ ((hi * _C2) & _M32))
    return h & 3


def popcount32(x) -> torch.Tensor:
    """SWAR population count over uint32 lanes."""
    x = u32(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def fingerprint6(lo, hi) -> torch.Tensor:
    """The 6-bit slot fingerprint from the paper's bucket layout (Fig. 5)."""
    return (hash64_32(lo, hi, 0xF1A9) >> 13) & 0x3F


# ---------------------------------------------------------------------------
# Pure-int scalar twins, for the scalar protocol walks.


def fmix32_int(h: int) -> int:
    h &= _M32
    h ^= h >> 16
    h = (h * _C1) & _M32
    h ^= h >> 13
    h = (h * _C2) & _M32
    return h ^ (h >> 16)


def hash64_32_int(lo: int, hi: int, seed: int) -> int:
    h = (seed ^ _GOLDEN) & _M32
    h = (fmix32_int(h ^ lo) * _C3) & _M32
    h = (fmix32_int(h ^ hi) * _C4) & _M32
    return fmix32_int(h)


def hash_range_int(lo: int, hi: int, seed: int, size: int) -> int:
    return hash64_32_int(lo, hi, seed) % size


def slot_hash_int(lo: int, hi: int, bucket_seed: int) -> int:
    return fmix32_int((lo ^ (bucket_seed * _C1) ^ (hi * _C2)) & _M32) & 3


def fingerprint6_int(lo: int, hi: int) -> int:
    return (hash64_32_int(lo, hi, 0xF1A9) >> 13) & 0x3F


# ---------------------------------------------------------------------------
# Host helpers for uint64 key sets.


def split_u64(keys: np.ndarray):
    """uint64 keys -> (lo, hi) uint32 lanes."""
    keys = np.asarray(keys, dtype=np.uint64)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def join_u64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(lo, hi) uint32 lanes -> uint64 keys."""
    return (np.asarray(hi, np.uint64) << np.uint64(32)) | np.asarray(lo, np.uint64)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """64-bit mixer for key-set generation."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        z = x
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return z
