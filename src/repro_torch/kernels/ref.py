"""Plain PyTorch versions of the port's kernels: the semantics contract.

Each CUDA kernel in ``csrc/`` is held bit for bit against the function of
the same name here: by ``chip_smoke.py`` on the card, and by the tests on
the CPU against ``repro.kernels.ref``.  ``repro_torch.kernels.ops`` calls
these for tensors that lie on the CPU, and only for those.

Lanes are int32 tensors holding uint32 bit patterns; the math runs in int64
masked to 32 bits (``repro_torch.core.hashing``).
"""

from __future__ import annotations

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
