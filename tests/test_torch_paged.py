"""Port vs reference: the Ludo-paged KV cache and its decode path.

The same append, lookup and release sequences go through
``repro.cache`` and ``repro_torch.cache`` (on ``device="cpu"``), and must
give the same answers bit for bit: physical page ids, scalar ``lookup``,
``lookup_batch`` page maps and ``match`` (its unmatched lanes included),
the MN image, CN bits a page, the page whose append breaches the overflow
cache, and the cuckoo table's ``lookup2_batch``.  The slice as a whole,
``examples/serve_kvs.py`` part 2 at its own sizes, runs through both
packages' ops and must agree to 1e-5 (both compute in float32 from the same
float32 inputs; only the order of the sums differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import CuckooPageTable as RCuckoo
from repro.cache import LudoPageTable as RLudo
from repro.kernels import ops as r_ops
from repro_torch.cache import CuckooPageTable, LudoPageTable, page_key
from repro_torch.core.outback import ShardFullError
from repro_torch.kernels import ops

POOL = 8192
PAGES_PER_SEQ = 256


def _fill(tables, n_pages: int | None, per_seq: int = PAGES_PER_SEQ):
    """Append ``per_seq`` pages per sequence, in order, to every table until
    ``n_pages`` are in or the first table raises; returns the physical ids,
    the failing page's index (or None) and each table's error."""
    phys, errors = [], [None] * len(tables)
    for s in range(POOL // per_seq):
        for lp in range(per_seq):
            if n_pages is not None and len(phys) == n_pages:
                return phys, None, errors
            got = []
            for i, t in enumerate(tables):
                try:
                    got.append(t.append_page(s, lp))
                except Exception as e:  # noqa: BLE001 (compared below)
                    errors[i] = e
            if any(errors):
                return phys, len(phys), errors
            assert len(set(got)) == 1, (s, lp, got)
            phys.append(got[0])
    return phys, None, errors


def _same_mn(r, t):
    a, b = r.shard.mn_state(), t.shard.mn_state()
    for k in a:
        if k == "overflow":
            for kk in a[k]:
                np.testing.assert_array_equal(a[k][kk], b[k][kk], err_msg=kk)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(r.shard.cn.seeds, t.shard.cn.seeds.numpy())


def _same_maps(r, t, seqs, n):
    """lookup_batch of each sequence, bit for bit; returns the unmatched
    lane count."""
    unmatched = 0
    for s in seqs:
        pm_r, ok_r = r.lookup_batch(s, n)
        pm_t, ok_t = t.lookup_batch(s, n)
        assert pm_t.dtype == torch.int32 and ok_t.dtype == torch.bool
        np.testing.assert_array_equal(pm_t.numpy(), np.asarray(pm_r))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_r))
        unmatched += int((~ok_t).sum())
    return unmatched


@pytest.fixture(scope="module")
def breached():
    r, t = RLudo(POOL), LudoPageTable(POOL, device="cpu")
    phys, at, errors = _fill([r, t], None)
    return r, t, phys, at, errors


def test_fill_until_the_overflow_cache_breaches(breached):
    r, t, phys, at, (e_r, e_t) = breached
    # about 36% of the pool: the sentinel-seeded index has no resize path
    assert at is not None and 0.3 * POOL < at < 0.4 * POOL
    assert type(e_r).__name__ == "ShardFullError" and "s_stop" in str(e_r)
    assert isinstance(e_t, ShardFullError) and str(e_t) == str(e_r)
    assert phys == list(range(at))
    _same_mn(r, t)
    assert t.cn_bits_per_page() == r.cn_bits_per_page()
    assert t.allocator.free == r.allocator.free


def test_lookups_match_with_the_unmatched_lanes(breached):
    r, t, phys, at, _ = breached
    n_seq = -(-at // PAGES_PER_SEQ)
    unmatched = _same_maps(r, t, range(n_seq), PAGES_PER_SEQ)
    assert unmatched > 0, "sized for overflow residents"
    for s in range(n_seq):
        for lp in range(0, PAGES_PER_SEQ, 37):
            assert t.lookup(s, lp) == r.lookup(s, lp)


def test_unmatched_lanes_at_lower_fill():
    """32 sequences of 32 pages, 12.5% of the pool: three pages already
    live in the overflow cache and come back unmatched from both."""
    per_seq, n_seq = 32, 32
    r, t = RLudo(POOL), LudoPageTable(POOL, device="cpu")
    phys, at, _ = _fill([r, t], per_seq * n_seq, per_seq)
    assert at is None and len(phys) == per_seq * n_seq
    assert _same_maps(r, t, range(n_seq), per_seq) == 3
    # every matched entry is the page that was appended; the others still
    # name a page inside the pool
    maps = [t.lookup_batch(s, per_seq) for s in range(n_seq)]
    pm = torch.cat([m for m, _ in maps])
    ok = torch.cat([k for _, k in maps])
    np.testing.assert_array_equal(pm[ok].numpy(), np.asarray(phys)[ok.numpy()])
    assert ((pm >= 0) & (pm < POOL)).all()


def test_from_reference_of_a_breached_table(breached):
    """The page of the failed append is neither free nor live, so the pool
    size is passed; the copy answers and refuses as its source."""
    r, _, _, at, _ = breached
    t = LudoPageTable.from_reference(*_reference_state(r), device="cpu",
                                     capacity_pages=POOL)
    assert len(t.allocator.free) + at == POOL - 1
    assert t.cn_bits_per_page() == r.cn_bits_per_page()
    _same_mn(r, t)
    _same_maps(r, t, range(3), PAGES_PER_SEQ)
    with pytest.raises(ShardFullError, match="s_stop"):  # the failed page
        t.append_page(at // PAGES_PER_SEQ, at % PAGES_PER_SEQ)


def test_release_then_reuse_matches(breached):
    r, t, _, at, _ = breached
    for s in (0, 2):
        assert t.release_sequence(s) == r.release_sequence(s) == PAGES_PER_SEQ
    _same_mn(r, t)
    assert t.lookup(0, 5) is None and r.lookup(0, 5) is None
    assert t.allocator.free == r.allocator.free
    # the released slots take new pages again, in the same places
    phys = [(t.append_page(99, lp), r.append_page(99, lp)) for lp in range(40)]
    assert all(a == b for a, b in phys)
    _same_mn(r, t)
    _same_maps(r, t, [1, 99], 40)


def test_cuckoo_table_matches_reference():
    r, t = RCuckoo(4096), CuckooPageTable(4096, device="cpu")
    for s in range(6):
        for lp in range(70 + 13 * s):
            assert t.append_page(s, lp) == r.append_page(s, lp)
    assert t.release_sequence(2) == r.release_sequence(2)
    for lp in range(30):
        assert t.append_page(7, lp) == r.append_page(7, lp)
    for s, n in ((0, 70), (2, 96), (5, 135), (7, 30)):
        pm2_r, sel_r = r.lookup2_batch(s, n)
        pm2_t, sel_t = t.lookup2_batch(s, n)
        assert pm2_t.dtype == sel_t.dtype == torch.int32
        assert tuple(pm2_t.shape) == (n, 2)
        np.testing.assert_array_equal(pm2_t.numpy(), pm2_r)
        np.testing.assert_array_equal(sel_t.numpy(), sel_r)
        assert t.lookup2(s, 0) == r.lookup2(s, 0)
    assert t.table_bits_per_page() == r.table_bits_per_page()


def _reference_state(r):
    oth = r.shard.cn.othello
    cn = dict(words_a=oth.words_a, words_b=oth.words_b, ma=oth.ma, mb=oth.mb,
              seed_a=oth.seed_a, seed_b=oth.seed_b, seeds=r.shard.cn.seeds,
              num_buckets=r.shard.cn.num_buckets)
    return cn, r.shard.mn_state(), list(r.allocator.free), dict(r._live)


def test_from_reference_answers_as_its_source():
    r = RLudo(2048)
    for s in range(5):
        for lp in range(60 + 7 * s):
            r.append_page(s, lp)
    r.release_sequence(1)
    t = LudoPageTable.from_reference(*_reference_state(r), device="cpu")
    _same_mn(r, t)
    assert t.cn_bits_per_page() == r.cn_bits_per_page()
    _same_maps(r, t, range(5), 90)
    for lp in range(40):
        assert t.append_page(9, lp) == r.append_page(9, lp)
    assert t.release_sequence(3) == r.release_sequence(3)
    _same_mn(r, t)
    _same_maps(r, t, [0, 3, 9], 90)
    assert t.lookup(3, 2) is None and t.lookup(9, 39) == r.lookup(9, 39)


def test_page_key_matches_reference():
    from repro.cache import page_key as r_page_key
    lps = np.arange(300, dtype=np.uint64)
    np.testing.assert_array_equal(page_key(12345, lps), r_page_key(12345, lps))


def test_serve_kvs_part2_through_both_packages():
    """``examples/serve_kvs.py`` part 2 at its own sizes: a Ludo page table
    drives paged flash decode, against the two-fetch cuckoo baseline."""
    n_kv, g, d, ps, L, pool = 2, 4, 64, 16, 8, 256
    rl, rc = RLudo(pool), RCuckoo(pool)
    tl, tc = LudoPageTable(pool, device="cpu"), CuckooPageTable(
        pool, device="cpu")
    for lp in range(L):
        assert tl.append_page(7, lp) == rl.append_page(7, lp)
        assert tc.append_page(7, lp) == rc.append_page(7, lp)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((n_kv, g, d)).astype(np.float32)
    k = rng.standard_normal((pool, ps, n_kv, d)).astype(np.float32)
    v = rng.standard_normal((pool, ps, n_kv, d)).astype(np.float32)
    pm_r, ok_r = rl.lookup_batch(7, L)
    pm2_r, sel_r = rc.lookup2_batch(7, L)
    want = [r_ops.paged_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(pm_r), L * ps,
                                  mode="ref"),
            r_ops.cuckoo_paged_attention(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(pm2_r), jnp.asarray(sel_r), L * ps, mode="ref")]
    ops.reset_launch_counts()
    pm_t, ok_t = tl.lookup_batch(7, L)
    pm2_t, sel_t = tc.lookup2_batch(7, L)
    assert ok_t.all() and np.asarray(ok_r).all()
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = [ops.paged_attention(tq, tk, tv, pm_t, L * ps),
           ops.cuckoo_paged_attention(tq, tk, tv, pm2_t, sel_t, L * ps)]
    for g_parts, w_parts in zip(got, want):
        for g_, w in zip(g_parts, w_parts):
            np.testing.assert_allclose(g_.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0][0].numpy(), got[1][0].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert tl.cn_bits_per_page() == rl.cn_bits_per_page()
    assert tc.table_bits_per_page() == rc.table_bits_per_page()
    assert not any(ops.LAUNCHES.values())  # the CPU path launches nothing
