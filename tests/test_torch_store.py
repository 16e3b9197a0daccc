"""Port vs reference: the directory store and its §4.4 resize (``core/store.py``).

The cases of ``tests/test_store_resize.py``, ``tests/test_store_split_timing.py``
and the store cases of ``tests/test_write_batch_parity.py`` (and its api
coherence case), each run through ``repro`` and through the port on
``device="cpu"`` with the same keys and op streams (made from seeds with
numpy).  Exact equality: answers and statuses, ``meter_total().snapshot()``,
``resize_events`` (less the wall-clock ``rebuild_seconds``), the directory,
local and global depths, every table's ``mn_state()`` and, with a cache, its
whole state.  The reference's own assertions are kept on the port (split
timing: no wall-clock assertion).  Added: ``OutbackStore.from_reference``
continuing a reference store in lockstep, and the MN-image round trip.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.api import BatchPolicy as RPolicy
from repro.api import StoreSpec as RSpec
from repro.api import open_store as r_open
from repro.core.hashing import splitmix64
from repro.core.store import OutbackStore as RStore
from repro.core.store import make_uniform_keys
from repro_torch.api import BatchPolicy as TPolicy
from repro_torch.api import StoreSpec as TSpec
from repro_torch.api import open_store as t_open
from repro_torch.core.store import OutbackStore as TStore

from _torch_cache_state import assert_same_cache, ref_state

CHUNK = RStore.SPLIT_CHECK_CHUNK


def _host(x):
    if isinstance(x, torch.Tensor):
        a = x.numpy()
        return a.view(np.uint32) if a.dtype == np.int32 else a
    return np.asarray(x)


def _events(store):
    return [{k: v for k, v in dataclasses.asdict(e).items()
             if k != "rebuild_seconds"} for e in store.resize_events]


def _tables_state(store):
    return [t.mn_state() for t in store.tables]


def assert_same_store(r, t) -> None:
    assert r.meter_total().snapshot() == t.meter_total().snapshot()
    assert _events(r) == _events(t)
    assert (r.directory, r.local_depth, r.global_depth, r.n_keys,
            r._op_count, len(r._buffer)) == \
        (t.directory, t.local_depth, t.global_depth, t.n_keys,
         t._op_count, len(t._buffer))
    assert len(r.tables) == len(t.tables)
    for a, b in zip(_tables_state(r), _tables_state(t)):
        assert a.keys() == b.keys()
        for k in a:
            if k == "overflow":
                for kk in a[k]:
                    np.testing.assert_array_equal(a[k][kk], b[k][kk],
                                                  err_msg=kk)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for a, b in zip(r.tables, t.tables):
        np.testing.assert_array_equal(a.cn.seeds, b.cn.seeds.numpy())
    assert (r.cn_memory_bytes(), r.mn_state_bytes()) == \
        (t.cn_memory_bytes(), t.mn_state_bytes())
    assert (r.cn_cache is None) == (t.cn_cache is None)
    if r.cn_cache is not None:
        assert_same_cache(r.cn_cache, t.cn_cache)


def _pair(n=4000, seed=5, **kw):
    keys = make_uniform_keys(n, seed=seed)
    vals = splitmix64(keys)
    return (RStore(keys, vals, load_factor=0.85, **kw),
            TStore(keys, vals, load_factor=0.85, device="cpu", **kw), keys)


def _val(k):
    return int(splitmix64(np.uint64([k]))[0])


def _fresh_keys(n, tag):
    return splitmix64(np.arange(1, n + 1, dtype=np.uint64)
                      + np.uint64(tag << 48))


def _both(r, t, fn):
    """``fn`` on both stores; their answers must agree.  Returns the port's."""
    a, b = fn(r), fn(t)
    assert a == b
    return b


def _get(k):
    return lambda s: (lambda g: (g.value, g.round_trips, g.makeup))(
        s.get(int(k)))


def _get_batch(keys, **kw):
    return lambda s: [_host(x).tolist() for x in s.get_batch(keys, **kw)]


# --------------------------------------------- tests/test_store_resize.py
def test_resize_window_buffers_and_replays_inserts():
    r, t, keys = _pair()
    hr, ht = r.begin_split(0), t.begin_split(0)
    new_keys = _fresh_keys(50, 7)
    frozen = [_both(r, t, lambda s: s.insert(int(k), _val(int(k)) >> 1))
              for k in new_keys]
    assert all(c == "frozen" for c in frozen)
    assert len(t._buffer) == 50
    assert _both(r, t, _get(keys[0]))[0] == _val(int(keys[0]))
    hr.build()
    ht.build()
    assert _both(r, t, _get(keys[1]))[0] == _val(int(keys[1]))
    hr.finish()
    ht.finish()
    for k in new_keys:
        assert _both(r, t, _get(k))[0] == _val(int(k)) >> 1
    assert t.resize_events[-1].buffered_mutations == 50
    assert t._buffer == []
    assert t.resize_events[-1].rebuild_seconds > 0
    assert_same_store(r, t)


def test_resize_window_buffers_and_replays_deletes():
    r, t, keys = _pair()
    victims = keys[:20]
    hr, ht = r.begin_split(0), t.begin_split(0)
    assert not any(_both(r, t, lambda s: s.delete(int(k))) for k in victims)
    for k in victims:
        assert _both(r, t, _get(k))[0] == _val(int(k))
    hr.build()
    ht.build()
    hr.finish()
    ht.finish()
    for k in victims:
        assert _both(r, t, _get(k))[0] is None
    for k in keys[20:100]:
        assert _both(r, t, _get(k))[0] == _val(int(k))
    assert_same_store(r, t)


def test_split_doubles_directory_and_preserves_all_keys():
    r, t, keys = _pair()
    assert t.global_depth == 0 and len(t.tables) == 1
    n_before = t.n_keys
    r._split(0)
    t._split(0)
    assert t.global_depth == 1 and len(t.tables) == 2
    assert t.n_keys == n_before
    idx = np.random.default_rng(0).integers(0, len(keys), 500)
    got = _both(r, t, _get_batch(keys[idx], resolve_makeup=True))
    assert all(got[2])
    for k in keys[idx[:100]]:
        assert _both(r, t, _get(k))[0] == _val(int(k))
    assert_same_store(r, t)


def test_split_without_directory_doubling():
    r, t, keys = _pair()
    for s in (r, t):
        s._split(0)
        s._split(0)  # doubles again: 4 entries, 3 tables
    assert t.global_depth == 2
    lagging = t.local_depth.index(1)
    assert r.local_depth.index(1) == lagging
    r._split(lagging)
    t._split(lagging)
    assert t.global_depth == 2 and len(t.directory) == 4
    for k in keys[:300]:
        assert _both(r, t, _get(k))[0] == _val(int(k))
    assert_same_store(r, t)


def test_only_one_resize_in_flight():
    _, t, _ = _pair(1000)
    t.begin_split(0)
    with pytest.raises(RuntimeError, match="already in flight"):
        t.begin_split(0)


def test_organic_resize_from_insert_pressure():
    r, t, keys = _pair(2000)
    extra = _fresh_keys(2500, 3)
    for k in extra:
        _both(r, t, lambda s: s.insert(int(k), _val(int(k)) >> 2))
    assert t.resize_events, "insert pressure should have split"
    assert_same_store(r, t)
    rng = np.random.default_rng(1)
    for k in extra[rng.integers(0, len(extra), 200)]:
        assert _both(r, t, _get(k))[0] == _val(int(k)) >> 2
    for k in keys[rng.integers(0, len(keys), 200)]:
        assert _both(r, t, _get(k))[0] == _val(int(k))
    assert_same_store(r, t)


def test_resize_replay_with_cn_cache_keeps_coherence():
    r, t, keys = _pair(3000, cn_cache_budget_bytes=64 << 10)
    hot = keys[:100]
    for _ in range(3):
        for k in hot:
            _both(r, t, _get(k))
    hr, ht = r.begin_split(0), t.begin_split(0)
    for k in hot[:10]:
        assert _both(r, t, lambda s: s.update(int(k), 1234))
    new_keys = _fresh_keys(30, 9)
    for k in new_keys:
        _both(r, t, lambda s: s.insert(int(k), 555))
    hr.build()
    ht.build()
    hr.finish()
    ht.finish()
    assert_same_store(r, t)
    for k in hot[:10]:
        got = _both(r, t, _get(k))[0]
        direct = _both(r, t, lambda s: s._table(int(k))._get_mn(int(k)).value)
        assert got == direct
    for k in new_keys:
        assert _both(r, t, _get(k))[0] == 555
    for k in hot[10:]:
        assert _both(r, t, _get(k))[0] == _val(int(k))
    assert_same_store(r, t)


# ---------------------------------------- tests/test_store_split_timing.py
N_TIMING = 3000


def _drive(open_store, spec_cls, policy_cls, batched: bool, **kw):
    keys = make_uniform_keys(N_TIMING, 11)
    vals = splitmix64(keys)
    spec = spec_cls("outback-dir", load_factor=0.85,
                    cache_budget_bytes=32 << 10,
                    batch=policy_cls(window=CHUNK, order="relaxed"))
    st = open_store(spec, keys, vals, **kw)
    fresh = splitmix64(np.arange(1, 2 * N_TIMING + 1, dtype=np.uint64)
                       + np.uint64(31 << 40))
    fvals = splitmix64(fresh)
    i, out = 0, []
    while not st.engine.resize_events and i < fresh.shape[0]:
        if batched:
            out.append(st.insert_batch(fresh[i:i + CHUNK],
                                       fvals[i:i + CHUNK]).statuses)
        else:
            for j in range(i, min(i + CHUNK, fresh.shape[0])):
                out.append(st.insert(int(fresh[j]), int(fvals[j])).statuses)
        i += CHUNK
        res = st.get_batch(keys[:128])
        out.append((res.values.tolist(), res.found.tolist()))
    assert st.engine.resize_events, "workload sized to force a split"
    return st, keys, fresh[:i], out


def _drive_both(batched: bool):
    r, keys, fresh, r_out = _drive(r_open, RSpec, RPolicy, batched)
    t, _, t_fresh, t_out = _drive(t_open, TSpec, TPolicy, batched,
                                  device="cpu")
    assert r_out == t_out
    np.testing.assert_array_equal(fresh, t_fresh)
    assert_same_store(r.engine, t.engine)
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    assert_same_cache(r.cache, t.cache)
    return r, t, keys, fresh


def test_split_timing_and_final_state_parity():
    _, s_st, keys, s_fresh = _drive_both(batched=False)
    r_b, b_st, _, b_fresh = _drive_both(batched=True)
    ev_s = s_st.engine.resize_events[0]
    ev_b = b_st.engine.resize_events[0]
    assert ev_b.step >= ev_s.step - CHUNK
    assert ev_b.step - ev_s.step <= 2 * (CHUNK + 128)
    assert abs(ev_b.table_keys - ev_s.table_keys) <= CHUNK
    assert s_st.engine.global_depth == b_st.engine.global_depth
    assert len(s_st.engine.tables) == len(b_st.engine.tables)
    n_ins = min(s_fresh.shape[0], b_fresh.shape[0])
    probe = np.concatenate([keys, s_fresh[:n_ins]])
    rs = s_st.get_batch(probe)
    rb = b_st.get_batch(probe)
    rr = r_b.get_batch(probe)
    np.testing.assert_array_equal(rs.found, rb.found)
    np.testing.assert_array_equal(rs.values, rb.values)
    np.testing.assert_array_equal(rr.values, rb.values)
    for j in range(0, probe.shape[0], 101):
        want = s_st.engine.get(int(probe[j]))
        got = int(rs.values[j]) if rs.found[j] else None
        assert got == want.value
    ms, mb = s_st.meter_totals(), b_st.meter_totals()
    assert abs(ms.round_trips - mb.round_trips) <= 2 * (CHUNK + 128)
    assert abs(ms.ops - mb.ops) <= 2 * (CHUNK + 128)
    assert r_b.meter_totals().snapshot() == mb.snapshot()


def test_batched_split_chunk_never_breaches_overflow_headroom():
    keys = make_uniform_keys(1024, 3)
    st = TStore(keys, splitmix64(keys), load_factor=0.85, device="cpu")
    ref = RStore(keys, splitmix64(keys), load_factor=0.85)
    table = st.tables[0]
    assert st._insert_chunk_len(table) <= max(1, int(0.35 * table.overflow.cap))
    assert st._insert_chunk_len(table) <= TStore.SPLIT_CHECK_CHUNK
    assert st._insert_chunk_len(table) == ref._insert_chunk_len(ref.tables[0])
    assert TStore.SPLIT_CHECK_CHUNK == CHUNK


# ------------------------------- tests/test_write_batch_parity.py (store)
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
    out = []
    for op, k, v in ops_:
        out.append({"u": lambda: sh.update(k, v), "i": lambda: sh.insert(k, v),
                    "d": lambda: sh.delete(k)}[op]())
    return [bool(x) if not isinstance(x, str) else x for x in out]


def _apply_batched(sh, ops_):
    i, out = 0, []
    while i < len(ops_):
        j = i
        while j < len(ops_) and ops_[j][0] == ops_[i][0]:
            j += 1
        ks = np.asarray([o[1] for o in ops_[i:j]], np.uint64)
        vs = np.asarray([o[2] for o in ops_[i:j]], np.uint64)
        if ops_[i][0] == "u":
            out += np.asarray(sh.update_batch(ks, vs)).tolist()
        elif ops_[i][0] == "i":
            out += list(sh.insert_batch(ks, vs))
        else:
            out += np.asarray(sh.delete_batch(ks)).tolist()
        i = j
    return out


@pytest.mark.parametrize("budget", [0, 1 << 15])
def test_store_mix_parity_below_resize(budget):
    keys = make_uniform_keys(8000, 5)
    ops_ = _mix(900, 17, keys, n_new=500)
    vals = splitmix64(keys)
    kw = dict(load_factor=0.85, initial_depth=1,
              cn_cache_budget_bytes=budget)
    r = RStore(keys, vals, **kw)
    a = TStore(keys, vals, device="cpu", **kw)
    b = TStore(keys, vals, device="cpu", **kw)
    for s in (r, a, b):
        s.get_batch(keys[:600])
        s.get_batch(keys[:600])
    assert _apply_batched(r, ops_) == _apply_scalar(a, ops_) == \
        _apply_batched(b, ops_)
    assert len(b.resize_events) == 0
    assert_same_store(r, b)
    assert a.meter_total().snapshot() == b.meter_total().snapshot()
    for ta, tb in zip(_tables_state(a), _tables_state(b)):
        for k in ta:
            if k != "overflow":
                np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def test_store_insert_batch_triggers_split_and_stays_correct():
    keys = make_uniform_keys(10_000, 21)
    vals = splitmix64(keys)
    r = RStore(keys, vals, load_factor=0.85)
    t = TStore(keys, vals, load_factor=0.85, device="cpu")
    new = splitmix64(np.arange(1, 6001, dtype=np.uint64) + np.uint64(3 << 42))
    statuses = _both(r, t, lambda s: s.insert_batch(new, new >> np.uint64(3)))
    assert len(t.resize_events) >= 1 and t.global_depth >= 1
    assert "frozen" not in statuses
    assert_same_store(r, t)
    v_lo, v_hi, match = _both(r, t, _get_batch(new, resolve_makeup=True))
    got = (np.asarray(v_hi, np.uint64) << np.uint64(32)) | \
        np.asarray(v_lo, np.uint64)
    assert all(match)
    np.testing.assert_array_equal(got, new >> np.uint64(3))
    assert all(_both(r, t, _get_batch(keys[::17], resolve_makeup=True))[2])
    assert_same_store(r, t)


def test_store_frozen_window_buffers_batched_mutations():
    keys = make_uniform_keys(6000, 31)
    vals = splitmix64(keys)
    r = RStore(keys, vals, load_factor=0.85)
    t = TStore(keys, vals, load_factor=0.85, device="cpu")
    hr, ht = r.begin_split(0), t.begin_split(0)
    new = splitmix64(np.arange(1, 33, dtype=np.uint64) + np.uint64(5 << 42))
    assert _both(r, t, lambda s: s.insert_batch(new, new)) == \
        ["frozen"] * len(new)
    assert not any(_both(r, t, lambda s: s.delete_batch(keys[:8]).tolist()))
    assert_same_store(r, t)
    hr.build()
    ht.build()
    hr.finish()
    ht.finish()
    assert all(_both(r, t, _get_batch(new, resolve_makeup=True))[2])
    assert not any(_both(r, t, _get_batch(keys[:8], resolve_makeup=True))[2])
    assert_same_store(r, t)


def test_api_stack_cache_coherent_through_batched_split():
    keys = make_uniform_keys(9000, 4)
    vals = splitmix64(keys)
    r = r_open(RSpec("outback-dir", load_factor=0.85,
                     cache_budget_bytes=64 << 10), keys, vals)
    t = t_open(TSpec("outback-dir", load_factor=0.85,
                     cache_budget_bytes=64 << 10), keys, vals, device="cpu")

    def same(fn):
        a, b = fn(r), fn(t)
        assert (a.values.tolist(), a.found.tolist(), a.statuses) == \
            (b.values.tolist(), b.found.tolist(), b.statuses)
        return b

    same(lambda s: s.get_batch(keys[:2000]))
    same(lambda s: s.get_batch(keys[:2000]))
    new = splitmix64(np.arange(1, 5001, dtype=np.uint64) + np.uint64(13 << 42))
    same(lambda s: s.insert_batch(new, new >> np.uint64(2)))
    assert len(t.engine.resize_events) >= 1
    same(lambda s: s.update_batch(keys[:64], np.full(64, 123, np.uint64)))
    res = same(lambda s: s.get_batch(np.concatenate([keys[:64], new[:64]])))
    assert res.found.all()
    np.testing.assert_array_equal(res.values[:64], np.full(64, 123, np.uint64))
    np.testing.assert_array_equal(res.values[64:], new[:64] >> np.uint64(2))
    same(lambda s: s.delete_batch(keys[:8]))
    assert not same(lambda s: s.get_batch(keys[:8])).found.any()
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    assert_same_store(r.engine, t.engine)
    assert_same_cache(r.cache, t.cache)


# ----------------------------------------------------- carrying state over
def _cn_dict(table):
    oth = table.cn.othello
    return dict(words_a=oth.words_a, words_b=oth.words_b, ma=oth.ma,
                mb=oth.mb, seed_a=oth.seed_a, seed_b=oth.seed_b,
                seeds=table.cn.seeds, num_buckets=table.cn.num_buckets)


def test_from_reference_continues_in_lockstep():
    """A port store built from a reference store's directory, tables and
    cache answers and splits exactly as that store goes on to."""
    from repro_torch.core.cn_cache import CNKeyCache as TCache
    keys = make_uniform_keys(3000, 8)
    vals = splitmix64(keys)
    r = RStore(keys, vals, load_factor=0.85, initial_depth=1,
               cn_cache_budget_bytes=32 << 10, rng_seed=3)
    r._split(1)
    r.get_batch(keys[:900])
    r.get_batch(keys[:900])
    t = TStore.from_reference(
        r.directory, r.local_depth, r.global_depth,
        [(_cn_dict(tb), tb.mn_state()) for tb in r.tables], device="cpu",
        load_factor=0.85, rng_seed=3, op_count=r._op_count,
        cn_cache=TCache.from_reference_state(ref_state(r.cn_cache),
                                             device="cpu"))
    for tt, tr in zip(t.tables, r.tables):  # carry the meters' totals
        tt.meter.merge(tr.meter)
    t.meter.merge(r.meter)
    r.resize_events, r_events = [], r.resize_events
    assert_same_store(r, t)
    new = _fresh_keys(1500, 12)
    assert _both(r, t, lambda s: s.insert_batch(new, new))
    assert len(t.resize_events) >= 1
    _both(r, t, _get_batch(np.concatenate([keys[:900], new[:300]])))
    assert_same_store(r, t)
    assert r_events  # the split before the hand-over


def test_mn_state_round_trip_and_resync_after_split():
    r, t, keys = _pair(3000)
    image = t.mn_state()  # one table, before any split
    t2 = TStore(keys, splitmix64(keys), load_factor=0.85, device="cpu")
    t._split(0)
    r._split(0)
    assert t.mn_state_bytes() == r.mn_state_bytes()
    t2.install_mn_state(t.mn_state())  # layout differs: tables rebuilt
    assert (t2.directory, t2.local_depth, t2.global_depth) == \
        (t.directory, t.local_depth, t.global_depth)
    got = [_host(x).tolist() for x in t2.get_batch(keys, resolve_makeup=True)]
    assert got == [_host(x).tolist()
                   for x in t.get_batch(keys, resolve_makeup=True)]
    t.install_mn_state(image)  # and back, one table again
    assert len(t.tables) == 1 and t.global_depth == 0
    assert all(t.get_batch(keys, resolve_makeup=True)[2].tolist())
