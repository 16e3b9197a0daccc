"""Port vs reference: hashing, slot bitfield and bit arrays, bit for bit.

Inputs are drawn with numpy from a seed, plus the edge lanes 0 and
0xFFFFFFFF (and the int32 sign boundary), and fed to ``repro.core`` as
uint32 arrays and to ``repro_torch.core`` as int32 bit-pattern tensors on
the CPU.  The tolerance is exact: the path is integer-only.
"""

import numpy as np
import pytest
import torch

from repro.core import bitarray as r_bits
from repro.core import hashing as rh
from repro.core import othello as r_oth
from repro.core import slots as r_slots
from repro_torch.core import bitarray as t_bits
from repro_torch.core import hashing as th
from repro_torch.core import slots as t_slots

EDGES = np.array([0, 1, 2, 3, 0x7FFFFFFF, 0x80000000, 0x80000001,
                  0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint32)


def _lanes(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([EDGES, x])


def _t(a):
    return th.lanes(a, "cpu")


def _np(t):
    """A port result (int64 uint32 values or int32 patterns) as uint32."""
    return th.to_u32_numpy(t)


@pytest.fixture(scope="module")
def lanes():
    lo = _lanes(3000, 1)
    hi = np.roll(_lanes(3000, 2), 3)
    return lo, hi


def test_u32_i32_round_trip():
    x = _lanes(500, 3)
    t = _t(x)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(_np(t), x)
    np.testing.assert_array_equal(th.i32(th.u32(t)).numpy(), t.numpy())
    for v in EDGES.tolist():
        assert th.i32_int(v) == int(np.uint32(v).view(np.int32))


def test_fmix32(lanes):
    lo, _ = lanes
    np.testing.assert_array_equal(_np(th.fmix32(_t(lo))), rh.fmix32(lo))


@pytest.mark.parametrize("seed", [0, 1, 0xA11CE, 0x7FFFFFFF, 0xFFFFFFFF])
def test_hash64_32(lanes, seed):
    lo, hi = lanes
    np.testing.assert_array_equal(_np(th.hash64_32(_t(lo), _t(hi), seed)),
                                  rh.hash64_32(lo, hi, seed))


@pytest.mark.parametrize("size", [1, 4, 1023, 53_200, 2**31 + 11, 2**32 - 1])
def test_hash_range(lanes, size):
    lo, hi = lanes
    np.testing.assert_array_equal(
        _np(th.hash_range(_t(lo), _t(hi), 0x0B5EED02, size)),
        rh.hash_range(lo, hi, 0x0B5EED02, size))


@pytest.mark.parametrize("bucket_seed", [0, 1, 77, 255])
def test_slot_hash(lanes, bucket_seed):
    lo, hi = lanes
    np.testing.assert_array_equal(
        _np(th.slot_hash(_t(lo), _t(hi), bucket_seed)),
        rh.slot_hash(lo, hi, np.uint32(bucket_seed)))


def test_slot_hash_per_lane_seeds(lanes):
    lo, hi = lanes
    seeds = np.random.default_rng(4).integers(0, 256, lo.size, dtype=np.uint8)
    np.testing.assert_array_equal(
        _np(th.slot_hash(_t(lo), _t(hi), torch.from_numpy(seeds))),
        rh.slot_hash(lo, hi, seeds))


def test_popcount32(lanes):
    lo, _ = lanes
    np.testing.assert_array_equal(_np(th.popcount32(_t(lo))),
                                  rh.popcount32(lo))


def test_fingerprint6(lanes):
    lo, hi = lanes
    np.testing.assert_array_equal(_np(th.fingerprint6(_t(lo), _t(hi))),
                                  rh.fingerprint6(lo, hi))


@pytest.mark.parametrize("name", ["fmix32_int", "hash64_32_int",
                                  "hash_range_int", "slot_hash_int",
                                  "fingerprint6_int"])
def test_int_twins(lanes, name):
    lo, hi = lanes
    args = {"fmix32_int": lambda a, b: (a,),
            "hash64_32_int": lambda a, b: (a, b, 0xF00D),
            "hash_range_int": lambda a, b: (a, b, 0x0F10C, 1031),
            "slot_hash_int": lambda a, b: (a, b, a & 0xFF),
            "fingerprint6_int": lambda a, b: (a, b)}[name]
    ref, port = getattr(rh, name), getattr(th, name)
    for a, b in zip(lo[:400].tolist(), hi[:400].tolist()):
        assert port(*args(a, b)) == ref(*args(a, b))


def test_split_join_splitmix():
    x = np.concatenate([np.array([0, 1, 2**63, 2**64 - 1], np.uint64),
                        rh.splitmix64(np.arange(1000, dtype=np.uint64))])
    np.testing.assert_array_equal(th.splitmix64(x), rh.splitmix64(x))
    for a, b in zip(th.split_u64(x), rh.split_u64(x)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(th.join_u64(*th.split_u64(x)), x)


# ------------------------------------------------------------------ slots
def test_slot_pack_unpack(lanes):
    rng = np.random.default_rng(5)
    n = 2000
    cache = rng.integers(0, 2, n)
    fp = rng.integers(0, 64, n)
    length = rng.integers(0, 512, n)
    a_lo = _lanes(n - EDGES.size, 6)
    a_hi = rng.integers(0, 1 << 16, n)
    r_lo, r_hi = r_slots.pack(cache, fp, length, a_lo, a_hi)
    t_lo, t_hi = t_slots.pack(torch.from_numpy(cache), torch.from_numpy(fp),
                              torch.from_numpy(length), _t(a_lo),
                              torch.from_numpy(a_hi))
    assert t_lo.dtype == t_hi.dtype == torch.int32
    np.testing.assert_array_equal(_np(t_lo), r_lo)
    np.testing.assert_array_equal(_np(t_hi), r_hi)
    # unpack every field of packed and of arbitrary words (all bits set too)
    lo, hi = lanes
    for s_lo, s_hi in ((r_lo, r_hi), (lo, hi)):
        rf = r_slots.unpack(s_lo, s_hi)
        tf = t_slots.unpack(_t(s_lo), _t(s_hi))
        assert set(rf) == set(tf)
        for k in rf:
            np.testing.assert_array_equal(_np(tf[k]), rf[k])
        np.testing.assert_array_equal(_np(t_slots.unpack_len(_t(s_hi))),
                                      r_slots.unpack_len(s_hi))
        np.testing.assert_array_equal(
            _np(t_slots.unpack_addr32(_t(s_lo), _t(s_hi))),
            r_slots.unpack_addr32(s_lo, s_hi))


# -------------------------------------------------------------- bitarray
@pytest.mark.parametrize("m", [1, 31, 32, 33, 1000, 4099])
def test_bitarray_ops(m):
    rng = np.random.default_rng(m)
    r_words = r_bits.alloc_bits(m)
    t_words = t_bits.alloc_bits(m)
    assert t_words.shape == r_words.shape and t_words.dtype == torch.int32
    assert t_bits.nbits(t_words) == r_bits.nbits(r_words)
    for idx in rng.integers(0, m, 40).tolist() + [m - 1]:
        val = int(rng.integers(0, 2))
        r_bits.set_bit(r_words, idx, val)
        t_bits.set_bit(t_words, idx, val)
    flips = np.unique(rng.integers(0, m, max(1, m // 3)))
    r_bits.flip_bits(r_words, flips)
    t_bits.flip_bits(t_words, torch.from_numpy(flips))
    np.testing.assert_array_equal(_np(t_words), r_words)
    idx = rng.integers(0, m, 500).astype(np.uint32)
    np.testing.assert_array_equal(
        _np(t_bits.get_bit(t_words, torch.from_numpy(idx.astype(np.int64)))),
        r_bits.get_bit(r_words, idx))


@pytest.mark.parametrize("m", [1, 32, 33, 5000])
def test_pack_bits_matches_othello_pack(m):
    bits = np.random.default_rng(m).integers(0, 2, m).astype(np.uint8)
    np.testing.assert_array_equal(
        _np(t_bits.pack_bits(torch.from_numpy(bits))), r_oth._pack(bits))
