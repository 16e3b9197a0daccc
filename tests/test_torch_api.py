"""Port vs reference through the public entry point: ``open_store``.

``repro_torch.api.open_store(StoreSpec("outback", ...), device="cpu")`` is
held against ``repro.api.open_store`` on YCSB A-D mixes (made from seeds
with numpy) at ``BatchPolicy(window=1 | 64 | 1024)``: every handle's
``OpResult`` — values, found, statuses and the meter stage's attribution —
the pipeline's own counters and the final ``CommMeter.snapshot()`` must be
identical.  So is ``outback-dir`` with and without a CN cache, and
``outback`` with one (then the cache's whole state too), and a stack's
cache meters as an engine's internal cache does
(``tests/test_api_stack.py``).  The four baselines (``race``, ``mica``,
``cluster``, ``dummy``) take the same YCSB mixes with and without a CN
cache, with identical answers, attribution and meters; so does the
mesh-sharded host (``sharded``, 2 and 3 shards) with and without a cache,
with the same traces, and the same stacked mesh state after the stream and
after batched and scalar mutations.  The pipeline's ``combine_reads``
(with and without a CN cache, on ``outback``, ``outback-dir`` and
``race``) and ``coalesce`` subsets give the same answers, stats, meters and
traces.  A spec's JSON is the same in both packages; the telemetry option
raises ``SpecError`` ("not yet ported"), replication and faults raise the
reference's own ``SpecError`` on kinds without ``mn_state`` and open and
serve on ``outback`` (the whole failure plane: ``tests/test_torch_faults.py``).
"""

import dataclasses

import numpy as np
import pytest

import repro.net as rnet
from repro import api as r_api
from repro.core.cn_cache import CNKeyCache as RCache
from repro.core.hashing import splitmix64
from repro.core.outback import OutbackShard as RShard
from repro.core.store import OutbackStore as RStore
from repro.core.store import make_uniform_keys
from repro_torch import api as t_api
from repro_torch.core import baselines as T_BASE
from repro_torch.core.cn_cache import CNKeyCache as TCache
from repro_torch.core.outback import OutbackShard as TShard
from repro_torch.core.sharded_kvs import ShardedKVSState
from repro_torch.core.store import OutbackStore as TStore
from repro_torch.kernels import ops
from repro_torch.net import Transport

from _torch_cache_state import assert_same_cache

N = 4096
N_OPS = 600
ATTRIBUTION = ("round_trips", "req_bytes", "resp_bytes", "makeups",
               "cache_hits", "cache_neg_hits", "retries", "backoffs",
               "failovers")


@pytest.fixture(scope="module")
def data():
    keys = make_uniform_keys(N, 5)
    return keys, splitmix64(keys)


def _zipf_ranks(rng, n_items, size, theta=0.99):
    p = 1.0 / np.arange(1, n_items + 1) ** theta
    return rng.choice(n_items, size=size, p=p / p.sum())


def _ycsb(mix, keys, n_ops, seed):
    """A YCSB core-workload stream: ``(op, key, value)`` triples.

    A: 50% read / 50% update, zipfian; B: 95 / 5; C: read only;
    D: 95% read of the latest keys / 5% insert of new ones."""
    rng = np.random.default_rng(seed)
    fresh = splitmix64(np.arange(1, n_ops + 1, dtype=np.uint64)
                       + np.uint64(seed << 40))
    # a fixed key permutation makes the zipf head land on scattered keys
    order = keys[rng.permutation(keys.size)]
    write_p = {"A": 0.5, "B": 0.05, "C": 0.0, "D": 0.05}[mix]
    ranks = _zipf_ranks(rng, keys.size, n_ops)
    writes = rng.random(n_ops) < write_p
    vals = rng.integers(0, 1 << 63, n_ops, dtype=np.uint64)
    inserted = []
    out = []
    for t in range(n_ops):
        if mix == "D":
            if writes[t]:
                inserted.append(int(fresh[t]))
                out.append(("insert", int(fresh[t]), int(vals[t])))
            else:  # "latest": zipf over recency, newest first
                pool = inserted[::-1] + order.tolist()
                out.append(("get", int(pool[ranks[t] % len(pool)]), None))
        elif writes[t]:
            out.append(("update", int(order[ranks[t]]), int(vals[t])))
        else:
            out.append(("get", int(order[ranks[t]]), None))
    return out


def _drive(store, stream):
    handles = []
    for op, k, v in stream:
        handles.append(store.submit(op, k) if v is None
                       else store.submit(op, k, v))
    store.flush()
    return handles


def _result_tuple(res):
    return (res.values.tolist(), res.found.tolist(), res.statuses,
            tuple(getattr(res, f) for f in ATTRIBUTION))


@pytest.mark.parametrize("window", [1, 64, 1024])
@pytest.mark.parametrize("mix", ["A", "B", "C", "D"])
def test_ycsb_through_open_store_matches_reference(data, mix, window):
    keys, vals = data
    policy = dict(window=window)
    r = r_api.open_store(r_api.StoreSpec("outback", load_factor=0.85,
                                         batch=r_api.BatchPolicy(**policy)),
                         keys, vals)
    t = t_api.open_store(t_api.StoreSpec("outback", load_factor=0.85,
                                         batch=t_api.BatchPolicy(**policy)),
                         keys, vals, device="cpu")
    stream = _ycsb(mix, keys, N_OPS, seed=ord(mix))
    rh, th = _drive(r, stream), _drive(t, stream)
    for a, b in zip(rh, th):
        assert _result_tuple(a.result()) == _result_tuple(b.result())
        assert _result_tuple(a.batch) == _result_tuple(b.batch)
    assert dataclasses.asdict(r.stats) == dataclasses.asdict(t.stats)
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    # the sync conveniences and the scalar walks, after the stream
    probe = np.concatenate([keys[:300], np.asarray([k for _, k, _ in stream],
                                                   np.uint64)])
    assert _result_tuple(r.get_batch(probe)) == \
        _result_tuple(t.get_batch(probe))
    for k in probe[::37]:
        assert _result_tuple(r.get(int(k))) == _result_tuple(t.get(int(k)))
        assert _result_tuple(r.delete(int(k))) == \
            _result_tuple(t.delete(int(k)))
        assert _result_tuple(r.insert(int(k), 9)) == \
            _result_tuple(t.insert(int(k), 9))
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    assert not any(ops.LAUNCHES.values())


# the directory store (two tables), with and without a CN cache, and the
# shard with one: the same YCSB streams through both packages
CONFIGS = {
    "outback-dir": dict(kind="outback-dir", params={"initial_depth": 1}),
    "outback-dir+cache": dict(kind="outback-dir", cache_budget_bytes=1 << 15,
                              params={"initial_depth": 1}),
    "outback+cache": dict(kind="outback", cache_budget_bytes=1 << 15),
}


@pytest.mark.parametrize("window", [1, 64, 1024])
@pytest.mark.parametrize("mix", ["A", "B", "C", "D"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_ycsb_directory_and_cache_match_reference(data, config, mix, window):
    keys, vals = data
    kw = dict(CONFIGS[config], load_factor=0.85)
    r = r_api.open_store(r_api.StoreSpec(
        **kw, batch=r_api.BatchPolicy(window=window)), keys, vals)
    t = t_api.open_store(t_api.StoreSpec(
        **kw, batch=t_api.BatchPolicy(window=window)), keys, vals,
        device="cpu")
    stream = _ycsb(mix, keys, N_OPS, seed=ord(mix))
    for a, b in zip(_drive(r, stream), _drive(t, stream)):
        assert _result_tuple(a.result()) == _result_tuple(b.result())
        assert _result_tuple(a.batch) == _result_tuple(b.batch)
    assert dataclasses.asdict(r.stats) == dataclasses.asdict(t.stats)
    probe = np.concatenate([keys[:300], np.asarray([k for _, k, _ in stream],
                                                   np.uint64)])
    for _ in range(2):  # the second read of a cached stack hits
        assert _result_tuple(r.get_batch(probe)) == \
            _result_tuple(t.get_batch(probe))
    for k in probe[::37]:
        for op in (lambda s: s.get(int(k)), lambda s: s.delete(int(k)),
                   lambda s: s.get(int(k)), lambda s: s.insert(int(k), 9)):
            assert _result_tuple(op(r)) == _result_tuple(op(t))
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    if "cache" in config:
        assert_same_cache(r.inner.inner.cache, t.cache)
        assert t.cache.stats.hits > 0
    if kw["kind"] == "outback-dir":
        assert (r.engine.directory, r.engine.local_depth) == \
            (t.engine.directory, t.engine.local_depth)
        assert len(t.engine.tables) == 2
    assert not any(ops.LAUNCHES.values())


def _stack_workload(keys):
    absent = splitmix64(np.arange(1, 65, dtype=np.uint64) + np.uint64(1 << 44))
    rng = np.random.default_rng(3)
    return [np.concatenate([keys[rng.integers(0, keys.size // (i + 1), 384)],
                            absent[: 16 * (i % 3)]]) for i in range(6)]


def test_shard_stack_matches_internal_cache(data):
    """A stack's cache layer meters and caches as a shard's own cache
    (``cn_cache=``) does, in both packages (``tests/test_api_stack.py``)."""
    keys, vals = data
    budget = 1 << 16
    legacy = TShard(keys, vals, load_factor=0.85, device="cpu",
                    cn_cache=TCache(budget, device="cpu"))
    r_legacy = RShard(keys, vals, load_factor=0.85, cn_cache=RCache(budget))
    stack = t_api.open_store(t_api.StoreSpec(
        "outback", load_factor=0.85, cache_budget_bytes=budget), keys, vals,
        device="cpu")
    absent = int(splitmix64(np.uint64([1 << 43]))[0])
    for q in _stack_workload(keys):
        res = stack.get_batch(q)
        for out in (legacy.get_batch(q), r_legacy.get_batch(q)):
            v_lo, v_hi, match = (np.asarray(x).astype(np.uint64)
                                 & np.uint64(0xFFFFFFFF) for x in out)
            np.testing.assert_array_equal(match.astype(bool), res.found)
            got = (v_hi << np.uint64(32)) | v_lo
            np.testing.assert_array_equal(got[res.found],
                                          res.values[res.found])
    for _ in range(4):
        for k in (int(keys[0]), int(keys[1]), absent):
            assert legacy.get(k).value == stack.get(k).value == \
                r_legacy.get(k).value
    assert legacy.meter.snapshot() == stack.meter_totals().snapshot() == \
        r_legacy.meter.snapshot()
    assert_same_cache(r_legacy.cn_cache, legacy.cn_cache)
    assert_same_cache(r_legacy.cn_cache, stack.cache)
    res = stack.get_batch(_stack_workload(keys)[0])
    assert res.cache_hits + res.cache_neg_hits <= len(res)
    assert res.round_trips >= len(res) - res.cache_hits - res.cache_neg_hits


def test_store_stack_matches_internal_cache_through_resize(data):
    """The directory store: inserts force a §4.4 split, and the stack's
    cache joins the same invalidation the store's own cache gets."""
    keys, vals = data
    m, budget = keys.size // 2, 1 << 16
    legacy = TStore(keys[:m], vals[:m], load_factor=0.85, device="cpu",
                    cn_cache_budget_bytes=budget)
    r_legacy = RStore(keys[:m], vals[:m], load_factor=0.85,
                      cn_cache_budget_bytes=budget)
    stack = t_api.open_store(t_api.StoreSpec(
        "outback-dir", load_factor=0.85, cache_budget_bytes=budget),
        keys[:m], vals[:m], device="cpu")
    fresh = splitmix64(np.arange(1, 500, dtype=np.uint64) + np.uint64(1 << 47))
    probe = keys[:256]
    for i, k in enumerate(fresh):
        case = legacy.insert(int(k), i)
        assert case == stack.insert(int(k), i).status == \
            r_legacy.insert(int(k), i)
        if i % 41 == 0:
            q = np.concatenate([probe, fresh[: max(1, i)]])
            res = stack.get_batch(q)
            for out in (legacy.get_batch(q), r_legacy.get_batch(q)):
                match = np.asarray(out[2])
                np.testing.assert_array_equal(match, res.found)
        if i % 67 == 0:
            kk = int(keys[i % m])
            assert legacy.update(kk, i) == bool(stack.update(kk, i).found[0])
            r_legacy.update(kk, i)
    assert len(legacy.tables) > 1, "workload sized to force a resize"
    assert len(stack.engine.tables) == len(legacy.tables)
    for k in fresh[:32]:
        assert legacy.delete(int(k)) == bool(stack.delete(int(k)).found[0]) \
            == r_legacy.delete(int(k))
    assert legacy.meter_total().snapshot() == \
        stack.meter_totals().snapshot() == r_legacy.meter_total().snapshot()
    for field in ("invalidated", "hits", "neg_hits"):
        assert getattr(legacy.cn_cache.stats, field) == \
            getattr(stack.cache.stats, field)
    assert_same_cache(r_legacy.cn_cache, legacy.cn_cache)


# combine_reads with and without a CN cache across kinds, and coalesce
# subsets: both packages give the same answers, stats, meters and traces
POLICY_CASES = {
    "outback+cache/combine": (dict(kind="outback", load_factor=0.85,
                                   cache_budget_bytes=1 << 15),
                              dict(window=64, combine_reads=True)),
    "outback-dir/combine": (dict(kind="outback-dir", load_factor=0.85,
                                 params={"initial_depth": 1}),
                            dict(window=64, combine_reads=True)),
    "outback-dir+cache/combine7": (dict(kind="outback-dir",
                                        load_factor=0.85,
                                        cache_budget_bytes=1 << 15,
                                        params={"initial_depth": 1}),
                                   dict(window=7, combine_reads=True)),
    "race/combine": (dict(kind="race", load_factor=0.5),
                     dict(window=64, combine_reads=True)),
    "race+cache/combine": (dict(kind="race", load_factor=0.5,
                                cache_budget_bytes=1 << 15),
                           dict(window=64, combine_reads=True)),
    "outback/coalesce-get": (dict(kind="outback", load_factor=0.85),
                             dict(window=64, coalesce=("get",))),
    "outback+cache/coalesce-writes": (dict(kind="outback", load_factor=0.85,
                                           cache_budget_bytes=1 << 15),
                                      dict(window=64,
                                           coalesce=("update", "insert",
                                                     "delete"))),
    "outback-dir/coalesce-get-update": (dict(kind="outback-dir",
                                             load_factor=0.85,
                                             params={"initial_depth": 1}),
                                        dict(window=32,
                                             coalesce=("get", "update"),
                                             combine_reads=True)),
    "race/coalesce-relaxed": (dict(kind="race", load_factor=0.5),
                              dict(window=64, order="relaxed",
                                   coalesce=("get", "delete"))),
}


@pytest.mark.parametrize("case", list(POLICY_CASES))
def test_policies_across_kinds_match_reference(data, case):
    keys, vals = data
    kw, policy = POLICY_CASES[case]
    r_tr, t_tr = rnet.Transport(), Transport()
    r = r_api.open_store(r_api.StoreSpec(**kw,
                                         batch=r_api.BatchPolicy(**policy)),
                         keys, vals, transport=r_tr)
    t = t_api.open_store(t_api.StoreSpec(**kw,
                                         batch=t_api.BatchPolicy(**policy)),
                         keys, vals, device="cpu", transport=t_tr)
    absent = splitmix64(np.arange(1, 41, dtype=np.uint64) + np.uint64(9 << 40))
    stream = (_ycsb("A", keys, N_OPS, seed=5)
              + _ycsb("D", keys, N_OPS // 2, seed=6)
              + [("delete", int(k), None) for k in keys[:40]]
              + [("get", int(k), None) for k in keys[:60]]
              + [("update", int(k), 3) for k in absent[:20]]
              + [("get", int(k), None) for k in absent]
              + [("insert", int(k), 4) for k in absent[::2]]
              + [("get", int(k), None) for k in absent])
    for a, b in zip(_drive(r, stream), _drive(t, stream)):
        assert _result_tuple(a.result()) == _result_tuple(b.result())
        assert (a.batch is None) == (b.batch is None)  # None: combined
        if a.batch is not None:
            assert _result_tuple(a.batch) == _result_tuple(b.batch)
    assert dataclasses.asdict(r.stats) == dataclasses.asdict(t.stats)
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    assert [(type(e).__name__, dataclasses.astuple(e)) for e in t_tr.trace] \
        == [(type(e).__name__, dataclasses.astuple(e)) for e in r_tr.trace]
    if policy.get("combine_reads"):
        assert t.stats.combined_reads > 0


@pytest.mark.parametrize("policy", [dict(window=256, order="relaxed"),
                                    dict(window=128, combine_reads=True)])
def test_pipeline_policies_match_reference(data, policy):
    keys, vals = data
    r = r_api.open_store(r_api.StoreSpec("outback", load_factor=0.85,
                                         batch=r_api.BatchPolicy(**policy)),
                         keys, vals)
    t = t_api.open_store(t_api.StoreSpec("outback", load_factor=0.85,
                                         batch=t_api.BatchPolicy(**policy)),
                         keys, vals, device="cpu")
    stream = _ycsb("A", keys, N_OPS, seed=3) + [
        ("delete", int(k), None) for k in keys[:40]] + [
        ("get", int(k), None) for k in keys[:60]]
    for a, b in zip(_drive(r, stream), _drive(t, stream)):
        assert _result_tuple(a.result()) == _result_tuple(b.result())
    assert dataclasses.asdict(r.stats) == dataclasses.asdict(t.stats)
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()


def test_batched_mutations_through_open_store_match(data):
    keys, vals = data
    r = r_api.open_store(r_api.StoreSpec("outback", load_factor=0.85),
                         keys, vals)
    t = t_api.open_store(t_api.StoreSpec("outback", load_factor=0.85),
                         keys, vals, device="cpu")
    fresh = splitmix64(np.arange(1, 400, dtype=np.uint64) + np.uint64(3 << 41))
    for call in (lambda s: s.insert_batch(fresh, fresh),
                 lambda s: s.update_batch(keys[:500], keys[:500]),
                 lambda s: s.delete_batch(np.concatenate([keys[:50], fresh])),
                 lambda s: s.get_batch(keys, resolve_makeup=False),
                 lambda s: s.get_batch(np.concatenate([keys, fresh]))):
        assert _result_tuple(call(r)) == _result_tuple(call(t))
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    r.reset_meters()
    t.reset_meters()
    assert t.meter_totals().snapshot() == r.meter_totals().snapshot()


# the four baselines through open_store, with and without a CN cache
BASELINE_SPECS = {"race": 0.5, "mica": 0.5, "cluster": 0.5, "dummy": None}


@pytest.mark.parametrize("window", [1, 1024])
@pytest.mark.parametrize("cache", [0, 1 << 15])
@pytest.mark.parametrize("mix", ["A", "C", "D"])
@pytest.mark.parametrize("kind", list(BASELINE_SPECS))
def test_ycsb_baselines_match_reference(data, kind, mix, cache, window):
    keys, vals = data
    kw = dict(kind=kind, load_factor=BASELINE_SPECS[kind],
              cache_budget_bytes=cache)
    r = r_api.open_store(r_api.StoreSpec(
        **kw, batch=r_api.BatchPolicy(window=window)), keys, vals)
    t = t_api.open_store(t_api.StoreSpec(
        **kw, batch=t_api.BatchPolicy(window=window)), keys, vals,
        device="cpu")
    assert t.engine.device.type == "cpu"
    assert isinstance(t.engine, getattr(T_BASE, type(r.engine).__name__))
    stream = _ycsb(mix, keys, N_OPS, seed=ord(mix) + 1)
    for a, b in zip(_drive(r, stream), _drive(t, stream)):
        assert _result_tuple(a.result()) == _result_tuple(b.result())
        assert _result_tuple(a.batch) == _result_tuple(b.batch)
    assert dataclasses.asdict(r.stats) == dataclasses.asdict(t.stats)
    probe = np.concatenate([keys[:300], np.asarray([k for _, k, _ in stream],
                                                   np.uint64)])
    for _ in range(2):  # the second read of a cached stack hits
        assert _result_tuple(r.get_batch(probe)) == \
            _result_tuple(t.get_batch(probe))
    for k in probe[::37]:
        for op in (lambda s: s.get(int(k)), lambda s: s.delete(int(k)),
                   lambda s: s.get(int(k)), lambda s: s.insert(int(k), 9),
                   lambda s: s.update(int(k), 11)):
            assert _result_tuple(op(r)) == _result_tuple(op(t))
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    if cache:
        assert_same_cache(r.inner.inner.cache, t.cache)
        assert t.cache.stats.hits > 0
        assert t.cache_hit_savings == r.inner.inner.cache_hit_savings
    assert t.verifies_keys == r.verifies_keys == (kind != "dummy")
    r.reset_meters()
    t.reset_meters()
    assert t.meter_totals().snapshot() == r.meter_totals().snapshot()
    assert not any(ops.LAUNCHES.values())


# the mesh-sharded host through open_store: answers, meters, traces and
# the re-installed mesh state after the stream
@pytest.mark.parametrize("window", [1, 1024])
@pytest.mark.parametrize("cache", [0, 1 << 15])
@pytest.mark.parametrize("mix", ["A", "C", "D"])
@pytest.mark.parametrize("params", [{"num_shards": 2},
                                    {"num_shards": 3, "data_parallel": 2}],
                         ids=["2x1", "3x2"])
def test_ycsb_sharded_matches_reference(data, params, mix, cache, window):
    keys, vals = data
    kw = dict(kind="sharded", cache_budget_bytes=cache, params=params)
    r_tr, t_tr = rnet.Transport(), Transport()
    r = r_api.open_store(r_api.StoreSpec(
        **kw, batch=r_api.BatchPolicy(window=window)), keys, vals,
        transport=r_tr)
    t = t_api.open_store(t_api.StoreSpec(
        **kw, batch=t_api.BatchPolicy(window=window)), keys, vals,
        device="cpu", transport=t_tr)
    assert isinstance(t.engine, ShardedKVSState)
    assert len(t.engine.shards) == params["num_shards"]
    assert {sh.device.type for sh in t.engine.shards} == {"cpu"}
    stream = _ycsb(mix, keys, N_OPS, seed=ord(mix) + 2)
    for a, b in zip(_drive(r, stream), _drive(t, stream)):
        assert _result_tuple(a.result()) == _result_tuple(b.result())
        assert _result_tuple(a.batch) == _result_tuple(b.batch)
    assert dataclasses.asdict(r.stats) == dataclasses.asdict(t.stats)
    probe = np.concatenate([keys[:300], np.asarray([k for _, k, _ in stream],
                                                   np.uint64)])
    for _ in range(2):  # the second read of a cached stack hits
        assert _result_tuple(r.get_batch(probe)) == \
            _result_tuple(t.get_batch(probe))
    for k in probe[::37]:
        for op in (lambda s: s.get(int(k)), lambda s: s.delete(int(k)),
                   lambda s: s.get(int(k)), lambda s: s.insert(int(k), 9),
                   lambda s: s.update(int(k), 11)):
            assert _result_tuple(op(r)) == _result_tuple(op(t))
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    assert _trace_tuples(r_tr.trace) == _trace_tuples(t_tr.trace)
    if cache:
        assert_same_cache(r.inner.inner.cache, t.cache)
        assert t.cache.stats.hits > 0
    _assert_same_mesh_state(r, t)
    r.reset_meters()
    t.reset_meters()
    assert t.meter_totals().snapshot() == r.meter_totals().snapshot()
    assert not any(ops.LAUNCHES.values())


def _trace_tuples(trace) -> list:
    return [(type(e).__name__, dataclasses.astuple(e)) for e in trace]


def _assert_same_mesh_state(r, t):
    rs, ts = r.mesh_state(), t.mesh_state()
    assert rs is r.engine and ts is t.engine
    for a, b in zip(rs.arrays(), ts.arrays()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (rs.num_buckets, rs.heap_cap, rs.ma, rs.mb) == \
        (ts.num_buckets, ts.heap_cap, ts.ma, ts.mb)


def test_sharded_batched_and_scalar_mutations_match_reference():
    """``test_write_batch_parity.py::test_api_sharded_batched_mutations``
    on both packages: scalar inserts, batched updates, Gets and deletes,
    then the mesh state each re-installs."""
    keys = make_uniform_keys(4096, 6)
    vals = splitmix64(keys)
    spec = dict(kind="sharded", params={"num_shards": 2})
    r = r_api.open_store(r_api.StoreSpec(**spec), keys, vals)
    t = t_api.open_store(t_api.StoreSpec(**spec), keys, vals, device="cpu")
    new = []
    for k in splitmix64(np.arange(1, 200, dtype=np.uint64)
                        + np.uint64(1 << 43)):
        a, b = r.insert(int(k), 1), t.insert(int(k), 1)
        assert _result_tuple(a) == _result_tuple(b)
        if bool(b.found[0]):
            new.append(int(k))
    new = np.asarray(new, np.uint64)
    _assert_same_mesh_state(r, t)
    for call in (lambda s: s.update_batch(new, np.full(new.size, 7,
                                                       np.uint64)),
                 lambda s: s.get_batch(new),
                 lambda s: s.delete_batch(new[:16]),
                 lambda s: s.get_batch(new[:16]),
                 lambda s: s.insert_batch(new[:16], new[:16]),
                 lambda s: s.delete_batch(keys[:64]),
                 lambda s: s.get_batch(keys, resolve_makeup=False),
                 lambda s: s.get_batch(np.concatenate([keys, new]))):
        assert _result_tuple(call(r)) == _result_tuple(call(t))
        _assert_same_mesh_state(r, t)
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    got = t.get_batch(new)
    assert got.found.all()
    assert set(got.values[16:].tolist()) == {7}
    with pytest.raises(AttributeError):
        t_api.open_store(t_api.StoreSpec("outback"), keys, vals,
                         device="cpu").mesh_state()


# ------------------------------------------------------------ spec / json
SPECS = [
    dict(kind="outback"),
    dict(kind="outback", load_factor=0.95, rng_seed=7),
    dict(kind="outback", params={"overflow_frac": 0.05, "heap_slack": 1.5}),
    dict(kind="outback", replicas=2, placement_k=2),
    dict(kind="race", cache_budget_bytes=1 << 16),
]


@pytest.mark.parametrize("kw", SPECS)
@pytest.mark.parametrize("batch", [None, dict(window=64, order="relaxed")])
def test_spec_json_is_identical_in_both_packages(kw, batch):
    r = r_api.StoreSpec(**kw, batch=None if batch is None
                        else r_api.BatchPolicy(**batch))
    t = t_api.StoreSpec(**kw, batch=None if batch is None
                        else t_api.BatchPolicy(**batch))
    assert r.to_json() == t.to_json()
    assert t_api.StoreSpec.from_json(r.to_json()) == t
    assert r_api.StoreSpec.from_json(t.to_json()) == r


@pytest.mark.parametrize("kw,what", [
    (dict(kind="mica", replicas=2), "mica"),
    (dict(kind="outback", telemetry={"sample": 1.0}), "telemetry"),
    (dict(kind="cluster", faults={"events": []}), "cluster"),
    (dict(kind="race", telemetry={"sample": 1.0}), "race"),
    (dict(kind="sharded", replicas=2), "sharded"),
])
def test_unported_options_raise_spec_error(data, kw, what):
    """The telemetry plane is not ported: a spec that asks for it raises
    "not yet ported".  Replication and faults on a kind without
    ``mn_state`` raise the reference's own ``SpecError``."""
    keys, vals = data
    with pytest.raises(t_api.SpecError) as e:
        t_api.open_store(t_api.StoreSpec(**kw), keys, vals, device="cpu")
    assert what in str(e.value)
    if "telemetry" in kw:
        assert "not yet ported" in str(e.value)
    else:
        with pytest.raises(r_api.SpecError) as e_r:
            r_api.open_store(r_api.StoreSpec(**kw), keys, vals)
        assert str(e.value) == str(e_r.value)
        assert "mn_state" in str(e.value)


@pytest.mark.parametrize("kw", [dict(kind="outback", replicas=2),
                                dict(kind="outback", faults={"events": []})])
def test_replicated_and_faulted_specs_open_and_serve(data, kw):
    """The two failure-plane options the port refused before: they open
    and serve as the reference's do, meters and answers alike."""
    keys, vals = data
    r = r_api.open_store(r_api.StoreSpec(**kw, load_factor=0.85), keys, vals)
    t = t_api.open_store(t_api.StoreSpec(**kw, load_factor=0.85), keys, vals,
                         device="cpu")
    fresh = splitmix64(np.arange(1, 65, dtype=np.uint64) + np.uint64(7 << 41))
    for call in (lambda s: s.insert_batch(fresh, fresh),
                 lambda s: s.update_batch(keys[:64], fresh),
                 lambda s: s.delete_batch(keys[64:96]),
                 lambda s: s.get_batch(np.concatenate([keys[:128], fresh])),
                 lambda s: s.get(int(keys[70]))):
        assert _result_tuple(call(r)) == _result_tuple(call(t))
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    assert isinstance(t.inner.inner, t_api.RetryLayer)
    assert isinstance(t.inner.inner.inner, t_api.ReplicaSetAdapter)


def test_spec_errors_match_reference_validation(data):
    keys, vals = data
    with pytest.raises(t_api.SpecError, match="sharded"):
        t_api.open_store(t_api.StoreSpec("sharded", params={"replicas": 2}),
                         keys, vals, device="cpu", transport=Transport())
    for bad in (dict(kind="nope"), dict(kind="sharded", params={"bogus": 1}),
                dict(kind="outback", load_factor=1.5),
                dict(kind="outback", params={"bogus": 1}),
                dict(kind="outback-dir", params={"heap_slack": 1.5}),
                dict(kind="outback", cache_budget_bytes=100),
                dict(kind="outback", batch={"window": -3})):
        with pytest.raises(r_api.SpecError):
            r_api.StoreSpec(**bad).validate()
        with pytest.raises(t_api.SpecError):
            t_api.StoreSpec(**bad).validate()
    with pytest.raises(t_api.SpecError, match="shape mismatch"):
        t_api.open_store(t_api.StoreSpec("outback"), keys, vals[:-1],
                         device="cpu")


def test_store_satisfies_the_protocols(data):
    keys, vals = data
    t = t_api.open_store(t_api.StoreSpec("outback"), keys, vals, device="cpu")
    assert isinstance(t, t_api.PipelinedKVStore)
    assert isinstance(t, t_api.KVStore)
    assert isinstance(t.inner, t_api.MeterLayer)
    assert isinstance(t.inner.inner, t_api.OutbackShardAdapter)
    assert t.spec == t_api.StoreSpec("outback") and t.telemetry is None
    assert t.engine.device.type == "cpu"
    kinds = ("cluster", "dummy", "mica", "outback", "outback-dir", "race",
             "sharded")
    assert t_api.registered_kinds() == kinds
    assert t_api.registry_docs() == {k: r_api.registry_docs()[k]
                                     for k in kinds}
    cached = t_api.open_store(t_api.StoreSpec("outback-dir",
                                              cache_budget_bytes=1 << 14),
                              keys, vals, device="cpu")
    assert isinstance(cached, t_api.KVStore)
    assert isinstance(cached.inner.inner, t_api.CNCacheLayer)
    assert isinstance(cached.inner.inner.inner, t_api.OutbackStoreAdapter)
    assert cached.cache is cached.inner.inner.cache
    assert cached.cache.device.type == "cpu" and t.cache is None
    assert cached.engine._coherence_caches == [cached.cache]
