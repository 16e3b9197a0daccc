"""Port vs reference: the CN hot-key cache (``core/cn_cache.py``).

The cases of ``tests/test_cn_cache.py`` that need no unported module, each
run through ``repro`` and through the port on ``device="cpu"`` with the same
keys and op streams (made from seeds with numpy).  Exact equality: answers,
``CommMeter.snapshot()``, and the whole cache state — the value table,
CLOCK bits and hands, the sketch and its observation count, the negative
cache and the statistics.  The reference's own assertions are kept on the
port.  Added: the probe over duplicate and top-bit keys, admissions that
share a set, sketch saturation and halving across calls, a cache carried
over from the reference's state, and the scalar-vs-batched write parity
with a cache attached (``tests/test_write_batch_parity.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.cn_cache import CNKeyCache as RCache
from repro.core.cn_cache import ShardedCNCache as RSharded
from repro.core.cn_cache import cache_probe as r_cache_probe
from repro.core.cn_cache import neg_probe as r_neg_probe
from repro.core.hashing import hash64_32, split_u64, splitmix64
from repro.core.outback import OutbackShard as RShard
from repro.core.store import OutbackStore as RStore
from repro.core.store import make_uniform_keys
from repro_torch.core import cn_cache as t_cn
from repro_torch.core.cn_cache import CNKeyCache as TCache
from repro_torch.core.hashing import lanes
from repro_torch.core.outback import OutbackShard as TShard
from repro_torch.core.store import OutbackStore as TStore
from repro_torch.kernels import ops

from _torch_cache_state import ARRAYS, assert_same_cache, ref_state

N = 20_000
BUDGET = 8 * N


@pytest.fixture(scope="module")
def kv():
    keys = make_uniform_keys(N)
    return keys, splitmix64(keys)


def _host(x):
    if isinstance(x, torch.Tensor):
        a = x.numpy()
        return a.view(np.uint32) if a.dtype == np.int32 else a
    return np.asarray(x)


def assert_same_get(r_out, t_out) -> None:
    for x, y in zip(r_out, t_out):
        np.testing.assert_array_equal(np.asarray(x), _host(y))


def _shards(kv, budget=BUDGET):
    keys, vals = kv
    r = RShard(keys, vals, load_factor=0.85, cn_cache=RCache(budget))
    t = TShard(keys, vals, load_factor=0.85, device="cpu",
               cn_cache=TCache(budget, device="cpu"))
    return r, t


def assert_same_shard(r, t) -> None:
    assert r.meter.snapshot() == t.meter.snapshot()
    for k, v in r.mn_state().items():
        if k != "overflow":
            np.testing.assert_array_equal(v, t.mn_state()[k], err_msg=k)
    np.testing.assert_array_equal(r.cn.seeds, t.cn.seeds.numpy())
    assert_same_cache(r.cn_cache, t.cn_cache)


def _val(k):
    return int(splitmix64(np.uint64([k]))[0])


def _gets(sh, keys):
    return [(g.value, g.round_trips, g.makeup)
            for g in (sh.get(int(k)) for k in keys)]


# ------------------------------------------------------------------ budget
@pytest.mark.parametrize("budget", [1024, 4 << 10, 64 << 10, 1 << 20, 8 << 24])
def test_budget_respected(budget):
    r, t = RCache(budget), TCache(budget, device="cpu")
    assert t.memory_bytes() <= budget and t.capacity >= 8
    assert_same_cache(r, t)
    assert t.k_lo.dtype == torch.int32 and t.sketch.dtype == torch.uint8


def test_budget_too_small_rejected():
    for cls in (RCache, TCache):  # before any device is looked at
        with pytest.raises(ValueError, match="1 KiB"):
            cls(100)


# --------------------------------------------------------------- admission
def test_hot_key_admitted_after_reuse(kv):
    r, t = _shards(kv)
    k = int(kv[0][0])
    got = _gets(t, [k, k, k])  # miss (freq 1), miss + admitted, hit
    assert got == _gets(r, [k, k, k])
    assert [g[0] for g in got] == [_val(k)] * 3 and got[2][1] == 0
    assert t.cn_cache.stats.hits == 1 and t.cn_cache.stats.admitted == 1
    assert t.meter.saved_round_trips == 1
    assert_same_shard(r, t)


def test_one_shot_scan_not_admitted(kv):
    r, t = _shards(kv)
    assert _gets(r, kv[0][:500]) == _gets(t, kv[0][:500])
    assert t.cn_cache.stats.admitted <= 3
    assert_same_shard(r, t)


def test_cold_burst_cannot_flush_hot_set(kv):
    r, t = _shards(kv, budget=64 << 10)
    hot = kv[0][:16]
    for _ in range(6):
        assert _gets(r, hot) == _gets(t, hot)
    hot_cached = int(t.cn_cache.valid.sum())
    assert hot_cached >= 14
    assert _gets(r, kv[0][1000:3000]) == _gets(t, kv[0][1000:3000])
    before = t.cn_cache.stats.hits
    assert _gets(r, hot) == _gets(t, hot)
    assert t.cn_cache.stats.hits - before >= hot_cached - 2
    assert_same_shard(r, t)


# ---------------------------------------------------------- negative cache
def test_negative_cache_absorbs_repeated_misses(kv):
    r, t = _shards(kv)
    absent = 0xDEAD_BEEF_0001
    got = _gets(t, [absent] * 3)
    assert got == _gets(r, [absent] * 3)
    assert got[2] == (None, 0, False)
    assert t.cn_cache.stats.neg_hits >= 1
    assert r.insert(absent, 777) == t.insert(absent, 777)  # clears it
    got = _gets(t, [absent])
    assert got == _gets(r, [absent]) and got[0][0] == 777
    assert_same_shard(r, t)


# ---------------------------------------------------------------- coherence
def test_update_refreshes_cached_value(kv):
    r, t = _shards(kv)
    k = int(kv[0][1])
    assert _gets(r, [k] * 3) == _gets(t, [k] * 3)
    assert r.update(k, 4242) and t.update(k, 4242)
    assert _gets(r, [k]) == _gets(t, [k]) == [(4242, 0, False)]
    assert t.cn_cache.stats.hits >= 2
    assert_same_shard(r, t)


def test_delete_invalidates_cached_value(kv):
    r, t = _shards(kv)
    k = int(kv[0][2])
    assert _gets(r, [k] * 3) == _gets(t, [k] * 3)
    assert r.delete(k) and t.delete(k)
    assert t.cn_cache.stats.invalidated >= 1
    got = _gets(t, [k])
    assert got == _gets(r, [k]) and got[0][0] is None
    assert_same_shard(r, t)


def test_cache_equivalent_to_uncached_mixed_workload(kv):
    keys, vals = kv
    r, t = _shards(kv)
    t_u = TShard(keys, vals, load_factor=0.85, device="cpu")
    rng = np.random.default_rng(7)
    for _ in range(800):
        k = int(keys[rng.integers(0, 2000)])
        op = rng.integers(0, 10)
        v = int(rng.integers(0, 2**63))
        if op < 6:
            got = t.get(k).value
            assert got == t_u.get(k).value == r.get(k).value
        elif op < 8:
            assert t.update(k, v) == t_u.update(k, v) == r.update(k, v)
        elif op == 8:
            assert t.delete(k) == t_u.delete(k) == r.delete(k)
        else:
            assert t.insert(k, v) == t_u.insert(k, v) == r.insert(k, v)
    assert_same_shard(r, t)


# -------------------------------------------------------------- batch path
def test_get_batch_with_cache_matches_values(kv):
    keys, _ = kv
    r, t = _shards(kv)
    rng = np.random.default_rng(3)
    q = keys[rng.zipf(1.5, 4096) % 3000]
    for _ in range(3):
        out = t.get_batch(q)
        assert_same_get(r.get_batch(q), out)
        assert_same_shard(r, t)
    v_lo, v_hi, match = (_host(x) for x in out)
    assert match.all()
    got = (v_hi.astype(np.uint64) << np.uint64(32)) | v_lo.astype(np.uint64)
    np.testing.assert_array_equal(got, splitmix64(q))
    assert t.cn_cache.stats.hits > 0
    assert t.meter.saved_round_trips == t.meter.cache_hits \
        + 2 * t.meter.cache_neg_hits


def test_cache_off_meter_unchanged(kv):
    keys, vals = kv
    sh = TShard(keys, vals, load_factor=0.85, device="cpu")
    sh.meter.reset()
    sh.get_batch(keys[:1024])
    m = sh.meter
    assert (m.ops, m.round_trips) == (1024, 1024)
    assert m.req_bytes == 1024 * 64 and m.resp_bytes == 1024 * 64
    assert m.cache_hits == m.saved_round_trips == m.saved_req_bytes == 0


def test_get_batch_resolves_overflow_residents(kv):
    r, t = _shards(kv)
    extra = splitmix64(np.arange(1, 400, dtype=np.uint64) + np.uint64(1 << 40))
    for k in extra:
        v = _val(int(k)) & (2**63 - 1)
        assert r.insert(int(k), v) == t.insert(int(k), v)
    out = t.get_batch(extra)
    assert_same_get(r.get_batch(extra), out)
    assert _host(out[2]).all()
    assert_same_shard(r, t)


# --------------------------------------------- pure probe (numpy == torch)
def test_cache_probe_numpy_and_torch_agree(kv):
    r, t = _shards(kv)
    for k in kv[0][:64]:
        for sh in (r, t):
            sh.get(int(k))
            sh.get(int(k))
    absent = splitmix64(np.arange(1, 9, dtype=np.uint64) + np.uint64(3 << 44))
    for sh in (r, t):  # two negative entries
        for k in absent[:2]:
            sh.get(int(k))
            sh.get(int(k))
    assert_same_cache(r.cn_cache, t.cn_cache)
    q = np.concatenate([kv[0][:64], kv[0][5000:5064], absent])
    lo, hi = split_u64(q)
    rc, tc = r.cn_cache, t.cn_cache
    hit_n, vlo_n, vhi_n = r_cache_probe(lo, hi, rc.arrays(), rc.nsets)
    lo_t, hi_t = lanes(lo, "cpu"), lanes(hi, "cpu")
    hit_t, vlo_t, vhi_t = t_cn.cache_probe(lo_t, hi_t, tc.arrays(), tc.nsets)
    np.testing.assert_array_equal(hit_n, hit_t.numpy())
    np.testing.assert_array_equal(vlo_n, _host(vlo_t))
    np.testing.assert_array_equal(vhi_n, _host(vhi_t))
    assert hit_n[:64].sum() > 0 and not hit_n[64:].any()
    neg_n = r_neg_probe(lo, hi, rc.neg_arrays(), rc.nneg)
    neg_t = t_cn.neg_probe(lo_t, hi_t, tc.neg_arrays(), tc.nneg)
    np.testing.assert_array_equal(neg_n, neg_t.numpy())
    assert neg_n[-8:].sum() == 2
    for x, y in zip(rc.probe_batch(lo, hi), tc.probe_batch(lo, hi)):
        np.testing.assert_array_equal(x, _host(y))


# ------------------------------------------------------------ store + resize
def _stores(kv, budget, n=None):
    keys, vals = kv if n is None else (kv[0][:n], kv[1][:n])
    return (RStore(keys, vals, load_factor=0.85, cn_cache_budget_bytes=budget),
            TStore(keys, vals, load_factor=0.85, cn_cache_budget_bytes=budget,
                   device="cpu"))


def assert_same_store(r, t) -> None:
    assert r.meter_total().snapshot() == t.meter_total().snapshot()
    assert (r.directory, r.local_depth, r.global_depth, r.n_keys) == \
        (t.directory, t.local_depth, t.global_depth, t.n_keys)
    for a, b in zip(r.tables, t.tables):
        for k, v in a.mn_state().items():
            if k != "overflow":
                np.testing.assert_array_equal(v, b.mn_state()[k], err_msg=k)
    assert_same_cache(r.cn_cache, t.cn_cache)


def test_store_cache_survives_mutations(kv):
    r, t = _stores(kv, BUDGET)
    k = int(kv[0][0])
    assert _gets(r, [k] * 3) == _gets(t, [k] * 3)
    assert t.cn_cache.stats.hits >= 1
    assert r.update(k, 99) == t.update(k, 99)
    assert _gets(r, [k]) == _gets(t, [k]) == [(99, 0, False)]
    assert r.delete(k) == t.delete(k)
    got = _gets(t, [k])
    assert got == _gets(r, [k]) and got[0][0] is None
    assert_same_store(r, t)


def test_store_split_invalidates_routed_entries():
    keys = make_uniform_keys(3000, seed=11)
    r, t = _stores((keys, splitmix64(keys)), 64 << 10)
    hot = keys[:200]
    for _ in range(3):
        assert _gets(r, hot) == _gets(t, hot)
    assert int(t.cn_cache.valid.sum()) > 0
    inv_before = t.cn_cache.stats.invalidated
    r._split(0)
    t._split(0)
    assert t.cn_cache.stats.invalidated > inv_before
    assert len(t.tables) == 2
    assert_same_store(r, t)
    got = _gets(t, hot)
    assert got == _gets(r, hot)
    assert [g[0] for g in got] == [_val(int(k)) for k in hot]
    assert_same_store(r, t)


def test_sharded_cn_cache_replicas():
    r, t = RSharded(RCache(16 << 10), 4), \
        t_cn.ShardedCNCache(TCache(16 << 10, device="cpu"), 4)
    arrs = t.arrays()
    assert all(a.shape[0] == 4 for a in arrs)
    for x, y in zip(r.arrays(), arrs):
        np.testing.assert_array_equal(x, _host(y))
    assert t.memory_bytes_total() == 4 * t.cache.memory_bytes() == \
        r.memory_bytes_total()
    assert t.nsets == r.nsets


# ------------------------------------------------------ added: the probe
def _top_bit_keys(n, seed):
    k = splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(seed << 36))
    return k | np.uint64(1 << 63)


def test_observe_and_probe_over_duplicates_and_top_bit_keys():
    """Duplicate keys in one batch add their counts; keys with the top bit
    set sort after the rest (ascending uint64), which decides the
    admission order; the first occurrence brings the value."""
    low = splitmix64(np.arange(1, 200, dtype=np.uint64)) >> np.uint64(1)
    high = _top_bit_keys(199, 5)
    rng = np.random.default_rng(0)
    r, t = RCache(4 << 10), TCache(4 << 10, device="cpu")
    for step in range(6):
        q = np.concatenate([low, high])[rng.integers(0, 398, 600)]
        lo, hi = split_u64(q)
        for x, y in zip(r.probe_batch(lo, hi), t.probe_batch(lo, hi)):
            np.testing.assert_array_equal(x, _host(y))
        hit, neg, _, _ = r.probe_batch(lo, hi)
        present = (q % np.uint64(3)) != 0
        v = splitmix64(q + np.uint64(step))  # duplicates carry other values
        v_lo, v_hi = split_u64(v)
        r.observe_batch(lo, hi, v_lo, v_hi, present, hit, neg)
        t.observe_batch(lo, hi, v_lo, v_hi, present, hit, neg)
        assert_same_cache(r, t)
    assert t.stats.admitted > 0 and t.stats.evicted > 0
    assert t.stats.neg_admitted > 0 and t.stats.hits > 0
    assert (t.state()["k_hi"][t.state()["valid"] != 0] >> 31).any()


def test_admissions_sharing_a_set_run_in_key_order():
    """Many candidates of one batch in one 4-way set: each sees the CLOCK
    hand, ref bits and TinyLFU estimates the keys before it left."""
    c = RCache(1024)  # 8 sets of 4 ways
    pool = splitmix64(np.arange(1, 4000, dtype=np.uint64))
    lo, hi = split_u64(pool)
    s = hash64_32(lo, hi, 0xCACE5E7) & np.uint32(c.nsets - 1)
    same = pool[s == 3][:24]
    assert same.size == 24
    r, t = RCache(1024), TCache(1024, device="cpu")
    rng = np.random.default_rng(1)
    for step in range(8):
        # repeats make estimates differ; every key offered as present
        q = same[rng.integers(0, 24, 96)]
        lo, hi = split_u64(q)
        hit, neg, _, _ = r.probe_batch(lo, hi)
        v_lo, v_hi = split_u64(q >> np.uint64(step))
        ones = np.ones(q.size, bool)
        r.observe_batch(lo, hi, v_lo, v_hi, ones, hit, neg)
        t.observe_batch(lo, hi, v_lo, v_hi, ones, hit, neg)
        assert_same_cache(r, t)
    assert t.stats.evicted >= 4


def test_sketch_saturates_and_halves_across_calls():
    """Counters cap at 255 after a whole batch's counts are added; the
    halving happens once per call, after the bump, when the observation
    count reaches the aging window — whichever call crosses it."""
    r, t = RCache(1024), TCache(1024, device="cpu")
    assert t.aging_window == 256
    key = np.uint64(0x1234_5678_9ABC_DEF0)
    hot = np.full(300, key)
    cold = splitmix64(np.arange(1, 101, dtype=np.uint64))
    for q in (hot[:200], hot, cold[:50], np.concatenate([hot[:60], cold]),
              hot[:1], cold[:255], cold[:1]):
        lo, hi = split_u64(q)
        z = np.zeros(q.size, bool)
        r.observe_batch(lo, hi, lo, hi, np.ones(q.size, bool), z, z)
        t.observe_batch(lo, hi, lo, hi, np.ones(q.size, bool), z, z)
        assert_same_cache(r, t)
        k_lanes = split_u64(np.uint64([key]))
        assert int(t._estimates(*k_lanes)[0]) == \
            int(r._sketch_est(*k_lanes)[0])
    assert int(t.sketch.max()) <= 255


def test_from_reference_state_continues_in_lockstep(kv):
    keys, vals = kv
    r = RShard(keys, vals, load_factor=0.85, cn_cache=RCache(32 << 10))
    rng = np.random.default_rng(5)
    absent = splitmix64(np.arange(1, 64, dtype=np.uint64) + np.uint64(1 << 46))
    for _ in range(4):
        r.get_batch(np.concatenate([keys[rng.zipf(1.4, 800) % 4000],
                                    absent[rng.integers(0, 63, 40)]]))
    t_cache = TCache.from_reference_state(ref_state(r.cn_cache),
                                          device="cpu")
    assert_same_cache(r.cn_cache, t_cache)
    r2 = RCache(32 << 10)  # a twin of the reference cache, driven alone
    for name in ARRAYS:
        setattr(r2, name, np.asarray(getattr(r.cn_cache, name)).copy())
    r2._sketch_obs, r2.stats = r.cn_cache._sketch_obs, \
        dataclasses.replace(r.cn_cache.stats)
    for step in range(4):
        q = np.concatenate([keys[rng.zipf(1.4, 800) % 4000],
                            absent[rng.integers(0, 63, 40)]])
        lo, hi = split_u64(q)
        hit, neg, c_lo, c_hi = r2.probe_batch(lo, hi)
        for x, y in zip((hit, neg, c_lo, c_hi), t_cache.probe_batch(lo, hi)):
            np.testing.assert_array_equal(x, _host(y))
        present = np.isin(q, keys)
        v_lo, v_hi = split_u64(splitmix64(q))
        r2.observe_batch(lo, hi, v_lo, v_hi, present | hit, hit, neg)
        t_cache.observe_batch(lo, hi, v_lo, v_hi, present | hit, hit, neg)
        r2.note_update(int(q[0]), step)
        t_cache.note_update(int(q[0]), step)
        r2.note_delete(int(q[1]))
        t_cache.note_delete(int(q[1]))
        assert_same_cache(r2, t_cache)


# ----------------------------- added: scalar-vs-batched writes with a cache
def _mix(n_ops, seed, keys, n_new=3000):
    rng = np.random.default_rng(seed)
    new = splitmix64(np.arange(1, n_new + 1, dtype=np.uint64)
                     + np.uint64(77 << 40))
    ops_ = []
    for _ in range(n_ops):
        x = rng.random()
        if x < 0.35:
            ops_.append(("u", int(keys[rng.integers(keys.size)]),
                         int(rng.integers(1 << 30))))
        elif x < 0.65:
            ops_.append(("i", int(new[rng.integers(n_new)]),
                         int(rng.integers(1 << 30))))
        elif x < 0.85:
            ops_.append(("d", int(keys[rng.integers(keys.size)]), 0))
        else:
            ops_.append(("d", int(new[rng.integers(n_new)]), 0))
    return ops_


def _apply_scalar(sh, ops_):
    for op, k, v in ops_:
        {"u": lambda: sh.update(k, v), "i": lambda: sh.insert(k, v),
         "d": lambda: sh.delete(k)}[op]()


def _apply_batched(sh, ops_):
    i = 0
    while i < len(ops_):
        j = i
        while j < len(ops_) and ops_[j][0] == ops_[i][0]:
            j += 1
        ks = np.asarray([o[1] for o in ops_[i:j]], np.uint64)
        vs = np.asarray([o[2] for o in ops_[i:j]], np.uint64)
        if ops_[i][0] == "u":
            sh.update_batch(ks, vs)
        elif ops_[i][0] == "i":
            sh.insert_batch(ks, vs)
        else:
            sh.delete_batch(ks)
        i = j


def test_shard_mix_parity_with_cn_cache():
    keys = make_uniform_keys(12_000, 5)
    vals = splitmix64(keys)
    ops_ = _mix(1500, 42, keys)
    r = RShard(keys, vals, load_factor=0.88, cn_cache=RCache(1 << 16))
    a = TShard(keys, vals, load_factor=0.88, device="cpu",
               cn_cache=TCache(1 << 16, device="cpu"))
    b = TShard(keys, vals, load_factor=0.88, device="cpu",
               cn_cache=TCache(1 << 16, device="cpu"))
    for sh in (r, a, b):  # warm the caches so the notes touch entries
        for _ in range(3):
            sh.get_batch(keys[:512])
    _apply_batched(r, ops_)
    _apply_scalar(a, ops_)
    _apply_batched(b, ops_)
    assert_same_shard(r, a)
    assert_same_shard(r, b)
    assert a.cn_cache.stats.invalidated > 0


def test_cpu_cache_path_launches_no_kernel(kv):
    ops.reset_launch_counts()
    _, t = _shards(kv)
    t.get_batch(kv[0][:256])
    t.get_batch(kv[0][:256])
    assert not any(ops.LAUNCHES.values())
