"""The port's transport model (``repro_torch.net``) against ``repro.net``.

Every comparison is exact: traces as tuples (``dataclasses.astuple`` of
each ``OpEvent``, ``Segment`` and mark), and every ``SimResult`` field of
``simulate`` / ``simulate_open`` / ``simulate_cluster`` with ``==`` on
floats (the replay keeps the reference's expressions in its order).

* the cases of ``tests/test_net_sim.py`` on the port (less the session
  store, whose module is not ported; the sharded mesh's case is in
  ``tests/test_torch_sharded_kvs.py``): determinism,
  the latency and throughput orderings, doorbell batching, resize-dip
  windows, Makeup-Get continuations, meter-to-trace rules;
* each kind's trace from the same keys and queries equals the reference's,
  engine by engine and through ``open_store(..., transport=...)``, and so
  does its replay at several client counts;
* hand-built traces with every mark (resize, doorbell, the fault kinds,
  replicas, waits, CN-to-CN segments) replay equally in all three
  simulators;
* the pipeline's doorbell windows (``tests/test_api_pipeline.py``) and the
  stack's transport binding (``tests/test_api_stack.py``) for ``outback``
  and ``outback-dir``, and a split's ``mark_resize``.
"""

import dataclasses

import numpy as np
import pytest

import repro.net as rnet
from repro import api as r_api
from repro.core import baselines as R
from repro.core.cn_cache import CNKeyCache as RCache
from repro.core.meter import CommMeter as RMeter
from repro.core.hashing import splitmix64
from repro.core.outback import OutbackShard as RShard
from repro.core.store import OutbackStore as RStore
from repro.core.store import make_uniform_keys
import repro_torch.net as tnet
from repro_torch import api as t_api
from repro_torch.core import baselines as T
from repro_torch.core.cn_cache import CNKeyCache as TCache
from repro_torch.core.meter import CommMeter
from repro_torch.core.outback import OutbackShard as TShard
from repro_torch.core.store import OutbackStore as TStore
from repro_torch.net import (CX3, CX6, DoorbellMark, OpEvent, ResizeMark,
                             Segment, Simulator, Transport, simulate)

N = 20_000
ENGINES = {"outback": (RShard, TShard, dict(load_factor=0.85)),
           "race": (R.RaceKVS, T.RaceKVS, {}),
           "mica": (R.MicaKVS, T.MicaKVS, {}),
           "cluster": (R.ClusterKVS, T.ClusterKVS, {}),
           "dummy": (R.DummyKVS, T.DummyKVS, {})}


@pytest.fixture(scope="module")
def data():
    keys = make_uniform_keys(N, 7)
    return keys, splitmix64(keys)


@pytest.fixture(scope="module")
def queries(data):
    keys, _ = data
    return keys[np.random.default_rng(3).integers(0, N, 4096)]


def _tuples(trace) -> list:
    return [(type(e).__name__, dataclasses.astuple(e)) for e in trace]


def _same_result(a, b) -> None:
    """Every SimResult field equal: arrays element for element, floats
    with ``==``."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y,
                                                         equal_nan=True), \
                f.name
        else:
            assert x == y, f.name
    assert a.percentiles() == b.percentiles()
    assert a.tput_mops == b.tput_mops


def _engine_traces(kind, data, queries):
    keys, vals = data
    r_cls, t_cls, kw = ENGINES[kind]
    r_tr, t_tr = rnet.Transport(), Transport()
    r_cls(keys, vals, transport=r_tr, **kw).get_batch(queries)
    t_cls(keys, vals, transport=t_tr, device="cpu", **kw).get_batch(queries)
    return r_tr, t_tr


@pytest.fixture(scope="module")
def pairs(data, queries):
    return {k: _engine_traces(k, data, queries) for k in ENGINES}


@pytest.fixture(scope="module")
def traces(pairs):
    return {k: t for k, (_, t) in pairs.items()}


# ------------------------------------------------- traces and their replay
@pytest.mark.parametrize("kind", list(ENGINES))
def test_engine_traces_match_reference(pairs, kind):
    r_tr, t_tr = pairs[kind]
    assert _tuples(r_tr.trace) == _tuples(t_tr.trace)
    assert len(r_tr) == len(t_tr) >= 4096
    assert r_tr.event_counts() == t_tr.event_counts()


@pytest.mark.parametrize("clients,window", [(1, 1), (8, 1), (64, 1), (7, 2)])
@pytest.mark.parametrize("kind", list(ENGINES))
def test_replay_matches_reference(pairs, kind, clients, window):
    r_tr, t_tr = pairs[kind]
    _same_result(rnet.simulate(r_tr.trace, clients=clients, window=window),
                 simulate(t_tr.trace, clients=clients, window=window))


@pytest.mark.parametrize("kind", ["outback", "race", "mica"])
def test_replay_options_match_reference(pairs, kind):
    r_tr, t_tr = pairs[kind]
    for kw in (dict(clients=4, service=rnet.CX3), dict(clients=8,
               mn_threads=2, doorbell=False), dict(clients=3, max_ops=1000),
               dict(clients=2, window=4, record_spans=True)):
        t_kw = dict(kw, service=CX3) if "service" in kw else kw
        _same_result(rnet.simulate(r_tr.trace, **kw),
                     simulate(t_tr.trace, **t_kw))


def test_service_models_match_reference():
    assert dataclasses.asdict(CX6) == dataclasses.asdict(rnet.CX6)
    assert dataclasses.asdict(CX3) == dataclasses.asdict(rnet.CX3)


def _hand_trace(net) -> list:
    """One trace with every item kind the replay engines read."""
    seg = net.Segment
    two = net.OpEvent(segments=(seg(64, 64, mn_reads=2, mn_hash=1),),
                      cn_hash=5, cn_cmp=1)
    race = net.OpEvent(segments=(seg(16, 128, one_sided=True),
                                 seg(16, 32, one_sided=True, verbs=2)),
                       cn_hash=3, cn_cmp=17)
    other = net.OpEvent(segments=(seg(64, 64, mn=1, mn_cmp=8,
                                      wait_s=2e-6),))
    fwd = net.OpEvent(segments=(seg(64, 64, cn_dst=1, mn_writes=1),))
    return ([two] * 40 + [net.DoorbellMark(16)] + [race] * 16
            + [net.ResizeMark(3000)] + [other, two] * 20
            + [net.FaultMark("mn_crash", mn=1, down_s=20e-6)]
            + [other] * 30
            + [net.FaultMark("nic_saturation", mn=0, down_s=15e-6,
                             factor=3.0)]
            + [two] * 30 + [net.FaultMark("partition", mn=-1, down_s=5e-6,
                                          cn=0)]
            + [net.FaultMark("fenced", cn=1), net.DoorbellMark(8)]
            + [fwd, two] * 10 + [net.FaultMark("cn_crash", mn=1,
                                               down_s=3e-6)]
            + [net.ResizeMark(500)] + [race] * 12)


@pytest.mark.parametrize("kw", [dict(clients=1), dict(clients=8, window=3),
                                dict(clients=4, window="policy"),
                                dict(clients=5, replicas=2, mn_threads=2),
                                dict(clients=6, replicas=2,
                                     record_spans=True, window="policy")])
def test_simulate_hand_trace_matches_reference(kw):
    r, t = _hand_trace(rnet), _hand_trace(tnet)
    assert _tuples(r) == _tuples(t)
    _same_result(rnet.simulate(r, **kw), simulate(t, **kw))


@pytest.mark.parametrize("kw", [dict(), dict(replicas=2, qps=3),
                                dict(mn_threads=2, doorbell=False)])
def test_simulate_open_matches_reference(kw):
    r, t = _hand_trace(rnet), _hand_trace(tnet)
    n_ops = sum(isinstance(e, OpEvent) for e in t)
    arrivals = np.random.default_rng(9).random(n_ops) * 200e-6
    arrivals[::5] = arrivals[0]  # ties break by insertion order
    _same_result(rnet.simulate_open(r, arrivals, **kw),
                 tnet.simulate_open(t, arrivals, **kw))
    with pytest.raises(ValueError, match="misalignment"):
        tnet.simulate_open(t, arrivals[:-1])


@pytest.mark.parametrize("kw", [dict(), dict(clients_per_cn=3, window=2),
                                dict(window="policy", replicas=2),
                                dict(max_ops=50, mn_threads=2)])
def test_simulate_cluster_matches_reference(kw, pairs):
    r_tr, t_tr = pairs["mica"]
    r = [_hand_trace(rnet), r_tr.trace[:500]]
    t = [_hand_trace(tnet), t_tr.trace[:500]]
    _same_result(rnet.simulate_cluster(r, **kw),
                 tnet.simulate_cluster(t, **kw))


def test_availability_and_timeline_match_reference():
    r = rnet.simulate(_hand_trace(rnet), clients=4, replicas=2)
    t = simulate(_hand_trace(tnet), clients=4, replicas=2)
    assert r.availability(20) == t.availability(20)
    for a, b in zip(r.tput_timeline(13), t.tput_timeline(13)):
        assert np.array_equal(a, b)
    assert r.tput_in_window(1e-5, 5e-5) == t.tput_in_window(1e-5, 5e-5)
    assert t.fault_windows and t.resize_windows


def test_transport_calls_match_reference():
    """mark_fault / add_wait / doorbells / reset: the same call sequence
    gives the same trace (fault marks never move the attach cursor)."""
    trs = (rnet.Transport(), Transport())
    for tr, meter in zip(trs, (RMeter(), CommMeter())):
        meter.sink = tr
        meter.add(3, rts=1, req=8, resp=32, mn_reads=2)
        tr.mark_fault("mn_crash", mn=1, down_s=1e-5)
        meter.add(0, rts=1, req=8, resp=32, cont=True)
        tr.add_wait(3e-6)
        tr.add_wait(-1.0)  # ignored
        tok = tr.begin_doorbell()
        meter.add(2, rts=2, req=16, resp=64, one_sided=True)
        tr.close_doorbell(tok)
        tr.current_mn, tr.current_cn_dst = 1, 0
        meter.add(1, rts=1, req=8, resp=8, mn_cmp=4)
        meter.add(0, mn_hash=2, cn_cmp=1, attach=True)
        tr.mark_resize(100)
        meter.add(0, rts=1, req=8, resp=8, attach=True)
    assert _tuples(trs[0].trace) == _tuples(trs[1].trace)
    assert trs[0].event_counts() == trs[1].event_counts()
    trs[1].reset()
    assert trs[1].trace == [] and trs[1].current_mn == 0


# ----------------------------------------- tests/test_net_sim.py on the port
def test_simulator_deterministic_tie_break():
    sim = Simulator()
    seen = []
    for i in range(5):
        sim.schedule(1.0, lambda i=i: seen.append(i))
    sim.run()
    assert seen == [0, 1, 2, 3, 4]


def test_simulation_is_deterministic(traces):
    t = traces["outback"].trace
    a = simulate(t, clients=7, window=2)
    b = simulate(t, clients=7, window=2)
    _same_result(a, b)


def test_trace_replay_counts_every_op(traces):
    for name, tr in traces.items():
        res = simulate(tr.trace, clients=4)
        assert res.n_ops == len(tr) >= 4096, name


def test_latency_orderings(traces):
    p50 = {k: simulate(tr.trace, clients=1).percentile_us(50)
           for k, tr in traces.items()}
    assert p50["outback"] <= p50["mica"] and p50["outback"] <= p50["cluster"]
    assert 1.6 <= p50["race"] / p50["outback"] <= 2.6  # two dependent RTs
    t = traces["outback"].trace
    assert (simulate(t, clients=1, service=CX3).percentile_us(50)
            > simulate(t, clients=1, service=CX6).percentile_us(50))


def test_throughput_saturates_with_clients(traces):
    t = traces["outback"].trace
    tput = [simulate(t, clients=c).tput_mops for c in (1, 4, 16, 64)]
    assert tput[1] > 3.5 * tput[0]
    assert tput[3] == pytest.approx(tput[2], rel=0.15)
    lat = [simulate(t, clients=c).percentile_us(50) for c in (1, 64)]
    assert lat[1] > lat[0]


def test_dummy_is_the_upper_bound(traces):
    tput = {k: simulate(tr.trace, clients=64).tput_mops
            for k, tr in traces.items()}
    for k in ("outback", "race", "mica", "cluster"):
        assert tput[k] < tput["dummy"], (k, tput)
    assert tput["mica"] < tput["outback"]


def test_mn_threads_scale_rpc_throughput(traces):
    t = traces["mica"].trace
    one = simulate(t, clients=64, mn_threads=1).tput_mops
    two = simulate(t, clients=64, mn_threads=2).tput_mops
    assert two > 1.6 * one


def test_doorbell_batching_pays_at_depth(traces):
    t = traces["outback"].trace
    on = simulate(t, clients=1, window=8, doorbell=True)
    off = simulate(t, clients=1, window=8, doorbell=False)
    assert on.tput_mops > 1.1 * off.tput_mops
    a = simulate(t, clients=2, window=1, doorbell=True)
    b = simulate(t, clients=2, window=1, doorbell=False)
    assert a.percentiles() == b.percentiles()


def test_resize_mark_opens_dip_window(data):
    """A split's ``mark_resize`` opens the Fig.-17 dip; the store's trace
    (marks included) and its replay equal the reference's."""
    keys, vals = data
    out = []
    for store_cls, net, kw in ((RStore, rnet, {}), (TStore, tnet,
                                                    {"device": "cpu"})):
        tr = net.Transport()
        store = store_cls(keys[:8000], vals[:8000], load_factor=0.85,
                          transport=tr, **kw)
        q = keys[:2048]
        store.get_batch(q)
        h = store.begin_split(0)
        for _ in range(6):
            store.get_batch(q)  # the stale table serves during the rebuild
        h.build()
        h.finish()
        store.get_batch(q)
        marks = [e for e in tr.trace if isinstance(e, net.ResizeMark)]
        assert marks == [net.ResizeMark(store.resize_events[0].table_keys)]
        out.append((tr, net.simulate(tr.trace, clients=8)))
    (r_tr, r_res), (t_tr, res) = out
    assert _tuples(r_tr.trace) == _tuples(t_tr.trace)
    _same_result(r_res, res)
    assert len(res.resize_windows) == 1
    w0, w1 = res.resize_windows[0]
    assert 0 < w0 < w1 < res.seconds
    assert res.tput_in_window(w0, w1) < 0.8 * res.tput_in_window(0, w0)


def test_overlapping_resize_windows_keep_slowdown_open():
    op = OpEvent(segments=(Segment(req_bytes=64, resp_bytes=64, mn_reads=2),))
    trace = [op] * 64 + [ResizeMark(4000), op, ResizeMark(4000)] + [op] * 4096
    res = simulate(trace, clients=8)
    assert len(res.resize_windows) == 2
    (a0, a1), (b0, b1) = res.resize_windows
    assert b0 < a1 < b1
    assert res.tput_in_window(b0, b1) < 0.8 * res.tput_in_window(0, a0)
    assert res.tput_in_window(b1, res.seconds) > res.tput_in_window(b0, b1)


def test_makeup_get_rides_as_continuation(data):
    keys, vals = data
    trs = []
    for cls, net, kw in ((RShard, rnet, {}), (TShard, tnet,
                                              {"device": "cpu"})):
        tr = net.Transport()
        sh = cls(keys[:2000], vals[:2000], load_factor=0.85, transport=tr,
                 **kw)
        sh.get(int(splitmix64(np.uint64([1 << 50]))[0]))
        assert sh.meter.ops == 2 and sh.meter.round_trips == 2
        ops = [e for e in tr.trace if isinstance(e, net.OpEvent)]
        assert len(ops) == 1 and len(ops[0].segments) == 2
        trs.append(tr)
    assert _tuples(trs[0].trace) == _tuples(trs[1].trace)


def test_batch_makeups_attach_to_distinct_ops(data):
    keys, vals = data
    extra = splitmix64(np.arange(1, 200, dtype=np.uint64)
                       + np.uint64(1 << 40))
    trs = []
    for cls, net, kw in ((RShard, rnet, {}), (TShard, tnet,
                                              {"device": "cpu"})):
        tr = net.Transport()
        sh = cls(keys[:2000], vals[:2000], load_factor=0.85, transport=tr,
                 **kw)
        for k in extra:
            sh.insert(int(k), int(k) & (2**62 - 1))
        tr.reset()
        _, _, match = sh.get_batch(extra, resolve_makeup=True)
        assert np.asarray(match).all()
        two_rt = [e for e in tr.trace
                  if isinstance(e, net.OpEvent) and len(e.segments) >= 2]
        assert len(two_rt) >= 2
        assert max(len(e.segments) for e in tr.trace) <= 3
        trs.append(tr)
    assert _tuples(trs[0].trace) == _tuples(trs[1].trace)


def test_one_sided_bytes_not_padded_and_attach_rules():
    m = CommMeter()
    m.add(1, rts=1, req=16, resp=32)
    assert (m.req_bytes, m.resp_bytes) == (64, 64)
    m.reset()
    m.add(1, rts=1, req=16, resp=32, one_sided=True)
    assert (m.req_bytes, m.resp_bytes) == (16, 32)
    m = CommMeter()
    m.add(1, rts=1, req=8, resp=8, mn_reads=2)
    m.add(0, rts=1, req=8, resp=8, mn_cmp=3, attach=True)
    assert m.ops == 1 and m.round_trips == 2 and m.mn_cmp_ops == 3
    assert m.req_bytes == 2 * 64


def test_add_zero_without_attach_is_a_noop():
    tr = Transport()
    m = CommMeter()
    m.sink = tr
    m.add(2, rts=1, req=8, resp=8)
    snap = m.snapshot()
    m.add(0, rts=1, req=8, resp=8)
    assert m.snapshot() == snap
    assert len(tr) == 2 and all(len(e.segments) == 1 for e in tr.trace)


def test_fully_cached_batch_adds_no_phantom_round_trip(data):
    keys, vals = data
    tr = Transport()
    sh = TShard(keys, vals, load_factor=0.85, device="cpu", transport=tr,
                cn_cache=TCache(1 << 20, device="cpu"))
    hot = keys[:64]
    for _ in range(3):
        sh.get_batch(hot)
    before, n_trace = sh.meter.snapshot(), len(tr.trace)
    sh.get_batch(hot)
    after = sh.meter.snapshot()
    assert after["round_trips"] == before["round_trips"]
    assert after["req_bytes"] == before["req_bytes"]
    assert after["ops"] == before["ops"] + 64
    assert len(tr.trace) == n_trace


@pytest.mark.parametrize("kind", list(ENGINES))
def test_transport_none_identical_meters(data, queries, kind):
    keys, vals = data
    _, t_cls, kw = ENGINES[kind]
    plain = t_cls(keys, vals, device="cpu", **kw)
    wired = t_cls(keys, vals, device="cpu", transport=Transport(), **kw)
    plain.get_batch(queries)
    wired.get_batch(queries)
    assert plain.meter.snapshot() == wired.meter.snapshot()


def test_trace_segments_wellformed(traces):
    for name, tr in traces.items():
        for e in tr.trace:
            assert isinstance(e, OpEvent) and len(e.segments) >= 1, name
            for s in e.segments:
                assert isinstance(s, Segment)
                assert s.req_bytes >= 0 and s.resp_bytes >= 0
                if s.one_sided:
                    assert s.mn_hash == s.mn_cmp == 0


# ------------------------------------------- open_store with a transport
def _stream(keys, seed):
    rng = np.random.default_rng(seed)
    fresh = splitmix64(np.arange(1, 301, dtype=np.uint64)
                       + np.uint64(seed << 41))
    out = []
    for t, kind in enumerate(rng.choice(4, 1500, p=[0.6, 0.2, 0.1, 0.1])):
        k = int(keys[rng.integers(0, keys.size)])
        out.append([("get", k, None), ("update", k, t),
                    ("insert", int(fresh[t % 300]), t),
                    ("delete", k, None)][kind])
    return out


KIND_SPECS = {"outback": dict(load_factor=0.85),
              "outback-dir": dict(load_factor=0.85,
                                  params={"initial_depth": 1}),
              "race": dict(load_factor=0.5), "mica": dict(load_factor=0.5),
              "cluster": dict(load_factor=0.5), "dummy": {}}


@pytest.mark.parametrize("window", [1, 256])
@pytest.mark.parametrize("cache", [0, 1 << 15])
@pytest.mark.parametrize("kind", list(KIND_SPECS))
def test_open_store_traces_match_reference(data, kind, cache, window):
    """Every kind through ``open_store(..., transport=Transport())``: the
    answers, meter totals, trace (doorbell marks included) and replay are
    the reference's."""
    keys, vals = data
    keys, vals = keys[:4096], vals[:4096]
    kw = dict(KIND_SPECS[kind], cache_budget_bytes=cache)
    r_tr, t_tr = rnet.Transport(), Transport()
    r = r_api.open_store(r_api.StoreSpec(
        kind, batch=r_api.BatchPolicy(window=window), **kw), keys, vals,
        transport=r_tr)
    t = t_api.open_store(t_api.StoreSpec(
        kind, batch=t_api.BatchPolicy(window=window), **kw), keys, vals,
        transport=t_tr, device="cpu")
    stream = _stream(keys, 11)
    for s in (r, t):
        hs = [s.submit(op, k) if v is None else s.submit(op, k, v)
              for op, k, v in stream]
        s.flush()
        s._handles = hs
    for a, b in zip(r._handles, t._handles):
        ra, tb = a.result(), b.result()
        assert (ra.values.tolist(), ra.found.tolist(), ra.statuses) == \
            (tb.values.tolist(), tb.found.tolist(), tb.statuses)
    probe = np.concatenate([keys[:500], keys[:200]])
    for _ in range(2):
        ra, tb = r.get_batch(probe), t.get_batch(probe)
        assert ra.values.tolist() == tb.values.tolist()
    assert r.meter_totals().snapshot() == t.meter_totals().snapshot()
    assert _tuples(r_tr.trace) == _tuples(t_tr.trace)
    assert any(isinstance(e, DoorbellMark) for e in t_tr.trace) == \
        (window > 1)
    for clients in (1, 8):
        _same_result(rnet.simulate(r_tr.trace, clients=clients,
                                   window="policy"),
                     simulate(t_tr.trace, clients=clients, window="policy"))


# -------------------------------------- tests/test_api_pipeline.py doorbells
def _spec(pkg, kind, **kw):
    return pkg.StoreSpec(kind, load_factor=0.85, **kw)


def _both(data, kind="outback", **kw):
    """The same spec opened in both packages, each with its transport."""
    keys, vals = data
    r_tr, t_tr = rnet.Transport(), Transport()
    r_kw = {k: (r_api.BatchPolicy(**v) if k == "batch" else v)
            for k, v in kw.items()}
    t_kw = {k: (t_api.BatchPolicy(**v) if k == "batch" else v)
            for k, v in kw.items()}
    r = r_api.open_store(_spec(r_api, kind, **r_kw), keys, vals,
                         transport=r_tr)
    t = t_api.open_store(_spec(t_api, kind, **t_kw), keys, vals,
                         transport=t_tr, device="cpu")
    return (r, r_tr), (t, t_tr)


def test_flushes_map_onto_doorbell_windows(data):
    keys, _ = data
    (r, r_tr), (st, tr) = _both(data, batch=dict(window=128,
                                                  order="relaxed"))
    for s in (r, st):
        for i in range(0, 1024, 32):
            s.submit("get", keys[i:i + 32])
        s.flush()
    assert _tuples(r_tr.trace) == _tuples(tr.trace)
    marks = [m for m in tr.trace if isinstance(m, DoorbellMark)]
    assert len(marks) == 8 and all(m.n_ops == 128 for m in marks)
    sync = simulate(tr.trace, window=1)
    pol = simulate(tr.trace, window="policy")
    deep = simulate(tr.trace, window=128)
    assert pol.n_ops == sync.n_ops == 1024
    assert pol.seconds < 0.5 * sync.seconds
    assert abs(pol.seconds - deep.seconds) / deep.seconds < 0.05
    _same_result(pol, simulate(tr.trace, window="policy"))
    _same_result(pol, rnet.simulate(r_tr.trace, window="policy"))


def test_doorbell_window_closes_after_its_group(data):
    keys, _ = data
    (r, r_tr), (st, tr) = _both(data, batch=dict(window=64,
                                                  order="relaxed"))
    for s in (r, st):
        s.submit("get", keys[:64])
        for k in keys[64:80]:
            s.get(int(k))
    assert _tuples(r_tr.trace) == _tuples(tr.trace)
    pol = simulate(tr.trace, window="policy")
    deep = simulate(tr.trace, window=64)
    sync = simulate(tr.trace, window=1)
    assert pol.n_ops == 80
    assert deep.seconds < pol.seconds < sync.seconds


@pytest.mark.parametrize("kind", ["outback", "outback-dir", "mica"])
def test_doorbell_marks_count_wire_ops_not_lanes(data, kind):
    keys, _ = data
    (r, r_tr), (st, tr) = _both(data, kind, cache_budget_bytes=1 << 16,
                                batch=dict(window=64, order="relaxed"))
    hot = keys[:64]
    for s in (r, st):
        for _ in range(4):
            s.submit("get", hot)
            s.flush()
    assert _tuples(r_tr.trace) == _tuples(tr.trace)
    marks = [m for m in tr.trace if isinstance(m, DoorbellMark)]
    assert len(marks) == 4
    assert marks[0].n_ops == 64 and marks[-1].n_ops < 64
    counts, cur = [], None
    for e in tr.trace:
        if isinstance(e, DoorbellMark):
            if cur is not None:
                counts.append(cur)
            cur = 0
        elif cur is not None:
            cur += 1
    counts.append(cur)
    assert counts == [m.n_ops for m in marks]


def test_sync_surface_emits_no_marks_for_sync_policy(data):
    keys, _ = data
    (r, r_tr), (st, tr) = _both(data)
    r.get_batch(keys[:64])
    st.get_batch(keys[:64])
    assert not any(isinstance(m, DoorbellMark) for m in tr.trace)
    assert _tuples(r_tr.trace) == _tuples(tr.trace)


def test_aborted_flush_still_closes_its_doorbell():
    """A MICA insert that raises mid-flush: the doorbell window is closed
    over the ops the flush recorded, as in the reference."""
    keys = make_uniform_keys(512, 7)
    fresh = splitmix64(np.arange(1, 2001, dtype=np.uint64)
                       + np.uint64(3 << 44))
    trs = []
    for api, net, kw in ((r_api, rnet, {}), (t_api, tnet,
                                             {"device": "cpu"})):
        tr = net.Transport()
        st = api.open_store(api.StoreSpec(
            "mica", batch=api.BatchPolicy(window=4096)), keys,
            splitmix64(keys), transport=tr, **kw)
        st.submit("get", keys[:100])
        st.submit("insert", fresh, fresh)
        with pytest.raises(RuntimeError, match="MICA displacement bound"):
            st.flush()
        trs.append(tr)
    assert _tuples(trs[0].trace) == _tuples(trs[1].trace)
    marks = [m for m in trs[1].trace if isinstance(m, DoorbellMark)]
    assert len(marks) == 1 and marks[0].n_ops > 100


# ----------------------------------------- tests/test_api_stack.py transport
BUDGET = 1 << 16


def _workload(keys):
    absent = splitmix64(np.arange(1, 65, dtype=np.uint64) + np.uint64(1 << 44))
    rng = np.random.default_rng(3)
    return [np.concatenate([keys[rng.integers(0, keys.size // (i + 1), 384)],
                            absent[: 16 * (i % 3)]]) for i in range(6)]


def _same_answers(legacy_out, res):
    v_lo, v_hi, match = (np.asarray(x).astype(np.uint64)
                         & np.uint64(0xFFFFFFFF) for x in legacy_out)
    np.testing.assert_array_equal(match.astype(bool), res.found)
    got = (v_hi << np.uint64(32)) | v_lo
    np.testing.assert_array_equal(got[res.found], res.values[res.found])


def test_shard_stack_parity_batched_and_scalar(data):
    keys, vals = data
    tr_legacy, tr_stack, r_tr = Transport(), Transport(), rnet.Transport()
    legacy = TShard(keys, vals, load_factor=0.85, device="cpu",
                    cn_cache=TCache(BUDGET, device="cpu"),
                    transport=tr_legacy)
    stack = t_api.open_store(t_api.StoreSpec(
        "outback", load_factor=0.85, cache_budget_bytes=BUDGET), keys, vals,
        transport=tr_stack, device="cpu")
    ref = RShard(keys, vals, load_factor=0.85, cn_cache=RCache(BUDGET),
                 transport=r_tr)
    for q in _workload(keys):
        res = stack.get_batch(q)
        _same_answers(legacy.get_batch(q), res)
        _same_answers(ref.get_batch(q), res)
    absent = int(splitmix64(np.uint64([1 << 43]))[0])
    for _ in range(4):
        for k in (int(keys[0]), int(keys[1]), absent):
            assert legacy.get(k).value == stack.get(k).value == \
                ref.get(k).value
    assert legacy.meter.snapshot() == stack.meter_totals().snapshot() == \
        ref.meter.snapshot()
    assert _tuples(tr_legacy.trace) == _tuples(tr_stack.trace) == \
        _tuples(r_tr.trace)


def test_store_stack_parity_through_resize(data):
    keys, vals = data
    m = 3000  # half of tests/test_api_stack.py's N: the inserts force a split
    tr_legacy, tr_stack, r_tr = Transport(), Transport(), rnet.Transport()
    legacy = TStore(keys[:m], vals[:m], load_factor=0.85, device="cpu",
                    cn_cache_budget_bytes=BUDGET, transport=tr_legacy)
    stack = t_api.open_store(t_api.StoreSpec(
        "outback-dir", load_factor=0.85, cache_budget_bytes=BUDGET),
        keys[:m], vals[:m], transport=tr_stack, device="cpu")
    ref = RStore(keys[:m], vals[:m], load_factor=0.85,
                 cn_cache_budget_bytes=BUDGET, transport=r_tr)
    fresh = splitmix64(np.arange(1, 500, dtype=np.uint64) + np.uint64(1 << 47))
    probe = keys[:256]
    for i, k in enumerate(fresh):
        case = legacy.insert(int(k), i)
        assert case == stack.insert(int(k), i).status == ref.insert(int(k), i)
        if i % 41 == 0:
            q = np.concatenate([probe, fresh[: max(1, i)]])
            res = stack.get_batch(q)
            _same_answers(legacy.get_batch(q), res)
            _same_answers(ref.get_batch(q), res)
        if i % 67 == 0:
            kk = int(keys[i % m])
            assert legacy.update(kk, i) == bool(stack.update(kk, i).found[0])
            ref.update(kk, i)
    assert len(legacy.tables) > 1, "workload sized to force a resize"
    for k in fresh[:32]:
        assert legacy.delete(int(k)) == bool(stack.delete(int(k)).found[0]) \
            == ref.delete(int(k))
    assert legacy.meter_total().snapshot() == \
        stack.meter_totals().snapshot() == ref.meter_total().snapshot()
    assert _tuples(tr_legacy.trace) == _tuples(tr_stack.trace) == \
        _tuples(r_tr.trace)
    assert sum(isinstance(e, ResizeMark) for e in tr_stack.trace) == \
        len(stack.engine.resize_events)


def test_cacheless_stack_is_plain_engine(data):
    keys, vals = data
    tr_legacy, tr_stack = Transport(), Transport()
    legacy = TShard(keys, vals, load_factor=0.85, device="cpu",
                    transport=tr_legacy)
    stack = t_api.open_store(t_api.StoreSpec("outback", load_factor=0.85),
                             keys, vals, transport=tr_stack, device="cpu")
    work = _workload(keys)
    for q in work[:3]:
        _same_answers(legacy.get_batch(q),
                      stack.get_batch(q, resolve_makeup=False))
    for q in work[3:]:
        _same_answers(legacy.get_batch(q, resolve_makeup=True),
                      stack.get_batch(q))
    assert legacy.meter.snapshot() == stack.meter_totals().snapshot()
    assert _tuples(tr_legacy.trace) == _tuples(tr_stack.trace)
    assert stack.inner.inner.engine.meter.sink is tr_stack


def test_split_successors_inherit_the_transport(data):
    keys, vals = data
    tr = Transport()
    store = TStore(keys[:4000], vals[:4000], load_factor=0.85,
                   initial_depth=1, device="cpu", transport=tr)
    assert store.meter.sink is tr
    h = store.begin_split(0)
    h.build()
    h.finish()
    assert all(t.meter.sink is tr for t in store.tables)
    assert [e for e in tr.trace if isinstance(e, ResizeMark)] == \
        [ResizeMark(store.resize_events[0].table_keys)]
    clone = TStore.from_reference(
        store.directory, store.local_depth, store.global_depth,
        [(_cn_dict(t), t.mn_state()) for t in store.tables], device="cpu",
        transport=tr)
    assert all(t.meter.sink is tr for t in clone.tables)


def _cn_dict(t) -> dict:
    oth = t.cn.othello
    return {"words_a": oth.words_a.numpy().view(np.uint32),
            "words_b": oth.words_b.numpy().view(np.uint32), "ma": oth.ma,
            "mb": oth.mb, "seed_a": oth.seed_a, "seed_b": oth.seed_b,
            "seeds": t.cn.seeds.numpy(), "num_buckets": t.cn.num_buckets}
