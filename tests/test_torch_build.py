"""Port vs reference: the host build is array-identical.

For the same keys, geometry and ``rng_seed``, ``repro_torch``'s Othello,
maintenance passes and Ludo build give the same words, seeds, buckets,
slots and fallback keys as ``repro``'s, bit for bit — including tiny tables
whose cuckoo placement leaves fallback keys.
"""

import numpy as np
import pytest
import torch

from repro.core import ludo as r_ludo
from repro.core import maintenance as r_maint
from repro.core import othello as r_oth
from repro.core.hashing import split_u64
from repro.core.store import make_uniform_keys
from repro_torch.core import ludo as t_ludo
from repro_torch.core import maintenance as t_maint
from repro_torch.core import othello as t_oth
from repro_torch.core.hashing import to_u32_numpy


def _keys(n, seed=3):
    lo, hi = split_u64(make_uniform_keys(n, seed))
    return lo, hi, torch.from_numpy(lo.astype(np.int64)), \
        torch.from_numpy(hi.astype(np.int64))


def _assert_same_cn(r_cn, t_cn):
    ro, to = r_cn.othello, t_cn.othello
    assert (ro.ma, ro.mb, ro.seed_a, ro.seed_b) == \
        (to.ma, to.mb, to.seed_a, to.seed_b)
    np.testing.assert_array_equal(to_u32_numpy(to.words_a), ro.words_a)
    np.testing.assert_array_equal(to_u32_numpy(to.words_b), ro.words_b)
    assert t_cn.seeds.dtype == torch.uint8
    np.testing.assert_array_equal(t_cn.seeds.numpy(), r_cn.seeds)
    assert t_cn.num_buckets == r_cn.num_buckets


@pytest.mark.parametrize("rng_seed", [0, 7])
@pytest.mark.parametrize("n", [1, 5, 1000, 40_000])
def test_ludo_build_identical(n, rng_seed):
    lo, hi, tlo, thi = _keys(n)
    r = r_ludo.build(lo, hi, load_factor=0.95, rng_seed=rng_seed)
    t = t_ludo.build(tlo, thi, load_factor=0.95, rng_seed=rng_seed)
    _assert_same_cn(r.cn, t.cn)
    np.testing.assert_array_equal(t.bucket.numpy().astype(np.uint32), r.bucket)
    np.testing.assert_array_equal(t.slot.numpy().astype(np.uint32), r.slot)
    np.testing.assert_array_equal(t.fallback.numpy(), r.fallback)


@pytest.mark.parametrize("n,num_buckets,rng_seed", [(16, 4, 0), (16, 4, 2),
                                                    (24, 7, 1), (64, 16, 0)])
def test_ludo_build_with_fallback_keys(n, num_buckets, rng_seed):
    lo, hi, tlo, thi = _keys(n, 5)
    r = r_ludo.build(lo, hi, num_buckets=num_buckets, rng_seed=rng_seed)
    t = t_ludo.build(tlo, thi, num_buckets=num_buckets, rng_seed=rng_seed)
    assert r.fallback.size > 0, "case sized to leave fallback keys"
    _assert_same_cn(r.cn, t.cn)
    np.testing.assert_array_equal(t.bucket.numpy().astype(np.uint32), r.bucket)
    np.testing.assert_array_equal(t.slot.numpy().astype(np.uint32), r.slot)
    np.testing.assert_array_equal(t.fallback.numpy(), r.fallback)
    assert not t.ok


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n", [1, 5, 1000, 40_000])
def test_othello_build_identical(n, seed):
    lo, hi, tlo, thi = _keys(n, 11)
    values = np.random.default_rng(n).integers(0, 2, n).astype(np.uint8)
    r = r_oth.build(lo, hi, values, seed=seed)
    t = t_oth.build(tlo, thi, torch.from_numpy(values), seed=seed)
    assert (r.ma, r.mb, r.seed_a, r.seed_b) == (t.ma, t.mb, t.seed_a, t.seed_b)
    np.testing.assert_array_equal(to_u32_numpy(t.words_a), r.words_a)
    np.testing.assert_array_equal(to_u32_numpy(t.words_b), r.words_b)
    # and every key reads back its value
    np.testing.assert_array_equal(t.lookup(tlo, thi).numpy(), values)


def test_first_of_each_matches_np_unique():
    x = np.random.default_rng(0).integers(0, 50, 1000)
    vals, first = t_oth.first_of_each(torch.from_numpy(x))
    r_vals, r_first = np.unique(x, return_index=True)
    np.testing.assert_array_equal(vals.numpy(), r_vals)
    np.testing.assert_array_equal(first.numpy(), r_first)


@pytest.mark.parametrize("rng_seed", [0, 9])
@pytest.mark.parametrize("n,load", [(1000, 0.95), (40_000, 0.97)])
def test_cuckoo_place_identical(n, load, rng_seed):
    lo, hi, tlo, thi = _keys(n, 2)
    nb = int(np.ceil(n / (4 * load)))
    b0, b1 = r_ludo.candidate_buckets(lo, hi, nb)
    r_b, r_fb = r_maint.cuckoo_place(b0.astype(np.int64), b1.astype(np.int64),
                                     nb, rng_seed)
    t_b, t_fb = t_maint.cuckoo_place(torch.from_numpy(b0.astype(np.int64)),
                                     torch.from_numpy(b1.astype(np.int64)),
                                     nb, rng_seed)
    np.testing.assert_array_equal(t_b.numpy(), r_b)
    np.testing.assert_array_equal(t_fb.numpy(), r_fb)


@pytest.mark.parametrize("tile", [None, 8, 256])
def test_one_shot_seeds_and_gather_identical(tile):
    lo, hi, tlo, thi = _keys(5000, 4)
    nb = int(np.ceil(5000 / (4 * 0.95)))
    b0, b1 = r_ludo.candidate_buckets(lo, hi, nb)
    bucket_of, _ = r_maint.cuckoo_place(b0.astype(np.int64),
                                        b1.astype(np.int64), nb, 0)
    r_g = r_maint.gather_buckets(lo, hi, bucket_of, nb)
    t_g = t_maint.gather_buckets(tlo, thi, torch.from_numpy(bucket_of), nb)
    for a, b in zip(t_g, r_g):
        np.testing.assert_array_equal(a.numpy() & 0xFFFFFFFF
                                      if a.dtype == torch.int64 and
                                      b.dtype == np.uint32 else a.numpy(), b)
    r_s, r_ok = r_maint.one_shot_seeds(*r_g[:3], tile=tile)
    t_s, t_ok = t_maint.one_shot_seeds(*t_g[:3], tile=tile)
    np.testing.assert_array_equal(t_s.numpy(), r_s)
    np.testing.assert_array_equal(t_ok.numpy(), r_ok)


def test_find_bucket_seeds_batch_identical():
    rng = np.random.default_rng(1)
    k_lo = rng.integers(0, 2**32, (300, 4), dtype=np.uint64).astype(np.uint32)
    k_hi = rng.integers(0, 2**32, (300, 4), dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(0, 5, 300)
    # a bucket of four identical keys has no perfect seed: -1
    k_lo[0, :] = k_lo[0, 0]
    k_hi[0, :] = k_hi[0, 0]
    counts[0] = 4
    want = r_maint.find_bucket_seeds_batch(k_lo, k_hi, counts)
    got = t_maint.find_bucket_seeds_batch(
        torch.from_numpy(k_lo.astype(np.int64)),
        torch.from_numpy(k_hi.astype(np.int64)), torch.from_numpy(counts))
    assert int(want[0]) == -1
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(40):
        k = int(counts[b])
        assert t_ludo.find_bucket_seed(k_lo[b, :k].tolist(),
                                       k_hi[b, :k].tolist()) == \
            r_ludo.find_bucket_seed(k_lo[b, :k], k_hi[b, :k])
