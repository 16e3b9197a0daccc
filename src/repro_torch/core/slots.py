"""The packed DMPH slot bitfield from the paper (Fig. 5), on torch tensors.

Each bucket is 32 bytes = 4 slots; each slot is 64 bits:

    cache bit (1) | fingerprint (6) | length (9) | data address (48)

stored as two 32-bit lanes:

    hi: [31]=cache  [30:25]=fp  [24:16]=len  [15:0]=addr<47:32>
    lo: addr<31:0>

``length`` is the KV-block byte length (0 <=> empty slot, the paper's
emptiness/delete marker); ``address`` is the block's offset in the memory
node's KV heap.  Inputs are any integer tensors read as uint32 (see
``repro_torch.core.hashing``); ``pack`` returns int32 bit-pattern lanes,
the field getters int64 values.
"""

from __future__ import annotations

from repro_torch.core.hashing import i32, u32

CACHE_SHIFT = 31
FP_SHIFT = 25
LEN_SHIFT = 16
FP_MASK = 0x3F
LEN_MASK = 0x1FF
ADDR_HI_MASK = 0xFFFF


def pack(cache, fp, length, addr_lo, addr_hi):
    """Pack slot fields -> (lo, hi) int32 bit-pattern lanes."""
    hi = ((u32(cache) << CACHE_SHIFT)
          | ((u32(fp) & FP_MASK) << FP_SHIFT)
          | ((u32(length) & LEN_MASK) << LEN_SHIFT)
          | (u32(addr_hi) & ADDR_HI_MASK))
    return i32(addr_lo), i32(hi)


def unpack(lo, hi) -> dict:
    """Unpack (lo, hi) lanes -> dict of slot fields (int64 uint32 values)."""
    hi = u32(hi)
    return {
        "cache": (hi >> CACHE_SHIFT) & 1,
        "fp": (hi >> FP_SHIFT) & FP_MASK,
        "len": (hi >> LEN_SHIFT) & LEN_MASK,
        "addr_hi": hi & ADDR_HI_MASK,
        "addr_lo": u32(lo),
    }


def unpack_len(hi):
    return (u32(hi) >> LEN_SHIFT) & LEN_MASK


def unpack_addr32(lo, hi):
    """48-bit address truncated to its low 32 bits (heaps are < 2^32 blocks)."""
    del hi
    return u32(lo)
