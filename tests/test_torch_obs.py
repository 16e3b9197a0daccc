"""The telemetry plane of the port (``repro_torch.obs`` and the hub's
hooks in every stack layer) against ``repro``.

Two halves:

* the 20 tests of ``tests/test_obs.py``, run against ``repro_torch`` on
  the CPU (``device="cpu"``): the histograms' bucket math, the config and
  its JSON, the dormant plane's byte identity (meters, traces, MN state),
  seeded reruns, the op clock's snapshots, the layers' span annotations,
  the replica and shard dims, the exporters and the meter sinks; each
  also holds the port's numbers against the reference's where both
  packages compute them;
* parity: one seeded stream through ``repro.api.open_store`` and
  ``repro_torch.api.open_store`` with a ``TelemetryConfig`` for all seven
  kinds, a cached ``outback-dir`` through splits and a crashed
  ``replicas=2`` store: every counter, gauge, histogram, span, snapshot
  and ``telemetry_rows`` row is equal (JSON for JSON), and so are the
  meters, traces and MN images with the hub on and off; ``chrome_trace``
  of one trace is the reference's; a malformed config raises the
  reference's exception with its message.
"""

import json
import pickle

import numpy as np
import pytest

from repro import api as r_api
from repro import obs as r_obs
from repro.core.hashing import splitmix64
from repro.core.store import make_uniform_keys
from repro.net import FaultSchedule as RFaultSchedule
from repro.net import Transport as RTransport
from repro.obs import hist as r_hist
from repro_torch import api as t_api
from repro_torch.api import (BatchPolicy, SpecError, StoreSpec,
                             TelemetryConfig, open_store)
from repro_torch.core.meter import CommMeter
from repro_torch.kernels import ops
from repro_torch.net import FaultSchedule, Transport
from repro_torch.obs import (HIST_SPEC, SPAN_KINDS, TELEMETRY_SCHEMA,
                             LogHistogram, TelemetryHub, chrome_trace,
                             telemetry_rows, validate_telemetry_rows)
from repro_torch.obs.hist import (N_BUCKETS, bucket_hi, bucket_index,
                                  bucket_indices, bucket_lo)


def _dataset(n=2048, seed=5):
    keys = make_uniform_keys(n, seed)
    return keys, splitmix64(keys)


def _spec(telemetry=None, **kw):
    return StoreSpec("outback", load_factor=0.85, telemetry=telemetry, **kw)


def _open(spec, keys, vals, **kw):
    return open_store(spec, keys, vals, device="cpu", **kw)


def _rows_json(hub) -> str:
    return "\n".join(json.dumps(r, sort_keys=True)
                     for r in telemetry_rows(hub))


def _ref_rows_json(hub) -> str:
    return "\n".join(json.dumps(r, sort_keys=True)
                     for r in r_obs.telemetry_rows(hub))


# ------------------------------------------------------------- histograms
def test_bucket_edges_contain_their_values():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.uniform(0, 3, 200),
                           rng.uniform(1, 2**40, 200),
                           [0.0, 0.5, 1.0, 2.0, 2.0**44, 2.0**50]])
    for v in vals:
        i = bucket_index(float(v))
        assert 0 <= i < N_BUCKETS
        assert i == r_hist.bucket_index(float(v))
        if i < N_BUCKETS - 1:  # overflow bucket clamps
            assert bucket_lo(i) <= v < bucket_hi(i)
            assert (bucket_lo(i), bucket_hi(i)) == (r_hist.bucket_lo(i),
                                                    r_hist.bucket_hi(i))
    # the vectorised path is exactly the scalar path, and the reference's
    assert np.array_equal(bucket_indices(vals),
                          [bucket_index(float(v)) for v in vals])
    assert np.array_equal(bucket_indices(vals), r_hist.bucket_indices(vals))


def test_histogram_merge_is_associative_and_weighted_record_matches():
    rng = np.random.default_rng(1)
    parts = [rng.integers(0, 10_000, 300) for _ in range(3)]
    hs, rs = [], []
    for p in parts:
        h, r = LogHistogram(), r_obs.LogHistogram()
        h.record_many(p)
        r.record_many(p)
        hs.append(h)
        rs.append(r)
    left = hs[0].copy().merge(hs[1]).merge(hs[2])
    right = hs[0].copy().merge(hs[1].copy().merge(hs[2]))
    assert left == right and left.n == 900
    r_left = rs[0].copy().merge(rs[1]).merge(rs[2])
    assert left.to_json_dict() == r_left.to_json_dict()
    # weighted vectorised recording == scalar repeated recording
    a, b, rb = LogHistogram(), LogHistogram(), r_obs.LogHistogram()
    vals = rng.integers(0, 5000, 200)
    w = rng.integers(0, 4, 200)
    for v, k in zip(vals, w):
        a.record(int(v), int(k))
    b.record_many(vals, weights=w)
    rb.record_many(vals, weights=w)
    assert a == b
    assert b.to_json_dict() == rb.to_json_dict()


def test_record_range_matches_elementwise_recording():
    rng = np.random.default_rng(3)
    cases = [(0, 1), (0, 5), (-3, 2), (-5, -1), (5, 5), (1023, 2048),
             (2**44 - 5, 2**44 + 5)]
    cases += [tuple(sorted(rng.integers(-10, 200_000, 2)))
              for _ in range(50)]
    acc_a, acc_b, acc_r = LogHistogram(), LogHistogram(), \
        r_obs.LogHistogram()
    for a, b in cases:
        h1, h2 = LogHistogram(), LogHistogram()
        h1.record_range(a, b)
        h2.record_many(np.arange(a, b))
        assert h1 == h2, (a, b)
        assert h1.total() == h1.n
        acc_a.record_range(a, b)
        acc_b.record_many(np.arange(a, b))
        acc_r.record_range(a, b)
    assert acc_a == acc_b
    assert acc_a.to_json_dict() == acc_r.to_json_dict()


def test_histogram_json_round_trip_and_spec_guard():
    h = LogHistogram()
    h.record_many(np.random.default_rng(2).integers(0, 10**6, 500))
    d = json.loads(json.dumps(h.to_json_dict(), sort_keys=True))
    assert LogHistogram.from_json_dict(d) == h
    # one JSON reads in both packages
    assert r_obs.LogHistogram.from_json_dict(d).to_json_dict() == \
        h.to_json_dict()
    bad = dict(d, spec={"scheme": "other"})
    with pytest.raises(ValueError, match="spec mismatch"):
        LogHistogram.from_json_dict(bad)


def test_percentile_stays_in_observed_range():
    h, r = LogHistogram(), r_obs.LogHistogram()
    for x in (h, r):
        x.record_many([100.0] * 50)
    assert h.percentile(50) == 100.0
    for x in (h, r):
        x.record_many(np.linspace(10, 1000, 100))
    for q in (1, 50, 99, 99.9):
        assert 10 <= h.percentile(q) <= 1000
        assert h.percentile(q) == r.percentile(q)


# ------------------------------------------------------- config and spec
def test_telemetry_config_round_trip_and_validation():
    cfg = TelemetryConfig(window_ops=128, spans_max=16)
    assert TelemetryConfig.from_json_dict(cfg.to_json_dict()) == cfg
    assert cfg.to_json_dict() == r_obs.TelemetryConfig(
        window_ops=128, spans_max=16).to_json_dict()
    with pytest.raises(ValueError, match="window_ops"):
        TelemetryConfig(window_ops=0).validate()
    with pytest.raises(ValueError, match="unknown"):
        TelemetryConfig.from_json_dict({"window_ops": 4, "bogus": 1})


def test_store_spec_carries_telemetry_through_json():
    spec = _spec(TelemetryConfig(window_ops=64))
    d = json.loads(json.dumps(spec.to_json_dict()))
    back = StoreSpec.from_json_dict(d)
    assert back.telemetry == TelemetryConfig(window_ops=64)
    assert StoreSpec.from_json_dict(_spec().to_json_dict()).telemetry is None
    # the same JSON as the reference's spec, both ways
    r = r_api.StoreSpec("outback", load_factor=0.85,
                        telemetry=r_obs.TelemetryConfig(window_ops=64))
    assert r.to_json() == spec.to_json()
    assert StoreSpec.from_json(r.to_json()) == spec


# ------------------------------------------------------- dormant identity
def _dormant_run(api, telemetry, keys, vals, q, transport, **kw):
    st = api.open_store(
        api.StoreSpec("outback", load_factor=0.85, telemetry=telemetry,
                      batch=api.BatchPolicy(window=128, order="relaxed")),
        keys[:1024], vals[:1024], transport=transport, **kw)
    for i in range(0, 512, 128):
        st.get_batch(q[i:i + 128])
    st.insert_batch(keys[1024:1088], vals[1024:1088])
    st.update_batch(keys[:32], vals[:32])
    st.delete_batch(keys[32:48])
    st.flush()
    return st


def test_dormant_plane_is_byte_identical():
    """Meters, recorded trace, final MN state and the kernels' launch
    counts must not notice the hub (and equal the reference's)."""
    keys, vals = _dataset()
    q = keys[np.random.default_rng(7).integers(0, 1024, 512)]
    snaps, traces, states, launches = [], [], [], []
    for telemetry in (None, TelemetryConfig(window_ops=64)):
        tr = Transport()
        ops.reset_launch_counts()
        st = _dormant_run(
            t_api, telemetry,
            keys, vals, q, tr, device="cpu")
        launches.append(dict(ops.LAUNCHES))
        snaps.append(st.meter_totals().snapshot())
        traces.append(tr.trace)
        states.append(pickle.dumps(st.engine.mn_state()))
    assert snaps[0] == snaps[1]
    assert traces[0] == traces[1]
    assert states[0] == states[1], "telemetry perturbed the final MN state"
    assert launches[0] == launches[1]
    r_tr = RTransport()
    ref = _dormant_run(r_api, r_obs.TelemetryConfig(window_ops=64), keys,
                       vals, q, r_tr)
    assert ref.meter_totals().snapshot() == snaps[1]
    assert [repr(x) for x in r_tr.trace] == [repr(x) for x in traces[1]]


def test_seeded_rerun_is_bit_identical():
    """Same spec + same op stream → byte-identical JSONL and trace JSON,
    both equal to the reference's."""
    outs = []
    port = (t_api, telemetry_rows, chrome_trace, Transport, {"device": "cpu"})
    ref = (r_api, r_obs.telemetry_rows, r_obs.chrome_trace, RTransport, {})
    for api, rows_of, ct, tr_cls, kw in (port, port, ref):
        keys, vals = _dataset()
        tr = tr_cls()
        st = api.open_store(
            api.StoreSpec("outback", load_factor=0.85,
                          telemetry=api.TelemetryConfig(window_ops=64),
                          batch=api.BatchPolicy(window=64, order="relaxed")),
            keys[:1024], vals[:1024], transport=tr, **kw)
        for i in range(0, 1024, 64):
            st.get_batch(keys[i:i + 64])
        st.insert_batch(keys[1024:1056], vals[1024:1056])
        st.flush()
        rows = rows_of(st.telemetry)
        validate_telemetry_rows(rows)
        outs.append(("\n".join(json.dumps(r, sort_keys=True) for r in rows),
                     json.dumps(ct(tr.trace, clients=2), sort_keys=True)))
    assert outs[0] == outs[1]
    assert outs[0] == outs[2]


# --------------------------------------------------------- clock and spans
def test_snapshot_cadence_follows_the_op_clock():
    keys, vals = _dataset()
    st = _open(_spec(TelemetryConfig(window_ops=100),
                     batch=BatchPolicy(window=64, order="relaxed")),
               keys[:1024], vals[:1024])
    for i in range(0, 640, 64):
        st.get_batch(keys[i:i + 64])
    hub = st.telemetry
    assert hub.clock == 640
    assert [s["clock"] for s in hub.snapshots] == [100, 200, 300, 400,
                                                   500, 600]
    for a, b in zip(hub.snapshots, hub.snapshots[1:]):
        for k, v in a["counters"].items():
            assert b["counters"].get(k, 0) >= v


def test_flush_spans_carry_layer_annotations():
    keys, vals = _dataset()
    hubs = []
    for api, kw in ((t_api,
                     {"device": "cpu"}), (r_api, {})):
        st = api.open_store(
            api.StoreSpec("outback", load_factor=0.85,
                          telemetry=api.TelemetryConfig(),
                          batch=api.BatchPolicy(window=32, order="relaxed")),
            keys[:1024], vals[:1024], **kw)
        for i in range(64):
            st.submit("get", int(keys[i]))
        st.flush()
        st.insert(int(keys[0]) ^ 0x5A5A, 9)  # scalar → its own span
        hubs.append(st.telemetry)
    hub = hubs[0]
    spans = list(hub.spans)
    assert all(s.kind in SPAN_KINDS for s in spans)
    flushes = [s for s in spans if s.kind == "flush"]
    assert len(flushes) >= 2
    for s in flushes:
        assert s.op == "get" and s.trigger in ("window", "explicit")
        assert s.ann["coalesced"] >= 1
        assert "queue_wait_ops" in s.ann
        assert s.ann["round_trips"] >= 1
        assert s.ann["req_bytes"] > 0
    assert any(s.kind == "scalar" for s in spans)
    assert hub.counters["ops{op=get}"] == 64
    assert hub.counters["ops{op=insert}"] == 1
    assert hub.counters["pipe.flushes{trigger=window}"] == 2
    assert [s.to_json_dict() for s in spans] == \
        [s.to_json_dict() for s in hubs[1].spans]


def test_span_deque_is_bounded_and_numbered():
    hub = TelemetryHub(TelemetryConfig(spans_max=4))
    for i in range(10):
        hub.begin_span("flush", "get", 1, "window")
    assert hub.spans_opened == 10
    assert len(hub.spans) == 4
    assert [s.span_id for s in hub.spans] == [6, 7, 8, 9]


# -------------------------------------------- failure-plane instrumentation
def test_crash_run_lands_on_replica_dims_and_retry_counters():
    keys, vals = _dataset(4096)
    sched = FaultSchedule.single_crash(at_op=256, duration_ops=256,
                                       down_s=100e-6, lease_term_ops=128)
    st = _open(_spec(TelemetryConfig(window_ops=128), replicas=2,
                     faults=sched), keys[:2048], vals[:2048])
    for i in range(0, 2048, 64):
        st.get_batch(keys[i:i + 64])
    st.insert_batch(keys[2048:2112], vals[2048:2112])
    hub = st.telemetry
    c = hub.counters
    assert c.get("replica.failovers", 0) >= 1
    assert c.get("retry.backoff_rounds", 0) >= 1
    assert any(k.startswith("replica.resyncs{mn=") for k in c)
    assert "wire.events{mn=0}" in c and "wire.events{mn=1}" in c
    assert "replica.write_lanes{mn=0}" in c
    rows = telemetry_rows(hub)
    validate_telemetry_rows(rows)


def test_sharded_and_directory_stores_tag_shard_dims():
    keys, vals = _dataset(4096)
    st = _open(StoreSpec("sharded", telemetry=TelemetryConfig(),
                         params={"num_shards": 2}), keys[:2048], vals[:2048])
    st.get_batch(keys[:256])
    c = st.telemetry.counters
    assert "wire.events{shard=0}" in c and "wire.events{shard=1}" in c

    st = _open(StoreSpec("outback-dir", load_factor=0.85,
                         telemetry=TelemetryConfig()),
               keys[:1024], vals[:1024])
    st.get_batch(keys[:256])
    st.insert_batch(keys[1024:3072], vals[1024:3072])  # pressure → splits
    c = st.telemetry.counters
    assert "wire.events{shard=dir}" in c
    shard_keys = [k for k in c if k.startswith("wire.events{shard=")
                  and "dir" not in k and "host" not in k]
    assert shard_keys, "per-table sinks never fired"
    if st.engine.resize_events:  # split successors inherit sinks
        assert len(shard_keys) >= 2


# --------------------------------------------------------------- exporters
def test_validator_rejects_malformed_exports():
    keys, vals = _dataset()
    st = _open(_spec(TelemetryConfig(window_ops=64)), keys[:1024],
               vals[:1024])
    st.get_batch(keys[:256])
    rows = telemetry_rows(st.telemetry)
    validate_telemetry_rows(rows)
    r_obs.validate_telemetry_rows(rows)  # the reference accepts the port's
    with pytest.raises(ValueError, match="schema"):
        validate_telemetry_rows([dict(rows[0], schema="nope")] + rows[1:])
    with pytest.raises(ValueError, match="meta"):
        validate_telemetry_rows(rows[1:] + rows[:1])
    snap = next(i for i, r in enumerate(rows) if r["row"] == "snapshot")
    bad = [dict(r) for r in rows]
    bad[snap]["clock"] = 7
    with pytest.raises(ValueError, match="multiple"):
        validate_telemetry_rows(bad)
    with pytest.raises(ValueError, match="total"):
        validate_telemetry_rows([r for r in rows if r["row"] != "total"])


def test_chrome_trace_is_perfetto_shaped():
    keys, vals = _dataset()
    tr = Transport()
    st = _open(_spec(batch=BatchPolicy(window=64, order="relaxed")),
               keys[:1024], vals[:1024], transport=tr)
    for i in range(0, 512, 64):
        st.get_batch(keys[i:i + 64])
    doc = chrome_trace(tr.trace, clients=2)
    ev = doc["traceEvents"]
    assert {e["name"] for e in ev if e.get("ph") == "M"} >= {
        "process_name", "thread_name"}
    ops_ = [e for e in ev if e["ph"] == "X" and e["name"] == "op"]
    rts = [e for e in ev if e["ph"] == "X" and e["name"].startswith("rt")]
    assert len(ops_) == 512 and len(rts) >= len(ops_)
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in ops_)
    assert any(e["ph"] == "i" and e["name"] == "doorbell" for e in ev)
    busy = [e for e in ev if e.get("pid") == 2 and e["ph"] == "X"]
    assert busy, "MN busy slices missing"
    json.dumps(doc)


def test_record_spans_is_a_pure_observation():
    from repro_torch.net.replay import simulate
    keys, vals = _dataset()
    tr = Transport()
    st = _open(_spec(batch=BatchPolicy(window=64, order="relaxed")),
               keys[:1024], vals[:1024], transport=tr)
    st.get_batch(keys[:256])
    plain = simulate(tr.trace, clients=2)
    spanned = simulate(tr.trace, clients=2, record_spans=True)
    assert plain.percentiles() == spanned.percentiles()
    assert plain.n_ops == spanned.n_ops and plain.seconds == spanned.seconds
    assert spanned.op_spans and spanned.server_spans
    assert not plain.op_spans


# ------------------------------------------------------------- meter sinks
def test_comm_meter_sink_fan_out_and_back_compat():
    class Tap:
        def __init__(self):
            self.events = []

        def on_meter_add(self, n, **kw):
            self.events.append((n, kw.get("rts", 0)))

    m = CommMeter()
    a, b = Tap(), Tap()
    m.sink = a
    assert m.sink is a and m.sinks == [a]
    m.add_sink(b)
    m.add_sink(b)
    assert m.sinks == [a, b]
    m.add(4, rts=2, req=64, resp=64)
    assert a.events == [(4, 2)] and b.events == [(4, 2)]
    m.sink = None
    assert m.sinks == []
    m2 = CommMeter()
    m2.add(4, rts=2, req=64, resp=64)
    assert m.snapshot() == m2.snapshot()


def test_hub_merge_folds_counters_and_hists_exactly():
    h1, h2 = TelemetryHub(), TelemetryHub()
    h1.count("x", 3, op="get")
    h2.count("x", 4, op="get")
    h1.hist("lat").record_many([1, 10, 100])
    h2.hist("lat").record_many([5, 50])
    h1.merge(h2)
    assert h1.counters["x{op=get}"] == 7
    assert h1.hists["lat"].n == 5
    ref = LogHistogram()
    ref.record_many([1, 10, 100, 5, 50])
    assert h1.hists["lat"] == ref


def test_schema_tag_is_stable():
    assert TELEMETRY_SCHEMA == "outback-telemetry/v1" == \
        r_obs.TELEMETRY_SCHEMA
    assert HIST_SPEC["n_buckets"] == 353
    assert HIST_SPEC == r_obs.HIST_SPEC


# ------------------------------------------------- parity with the reference
_KINDS = [
    ("outback", {}),
    ("outback-dir", {"cache_budget_bytes": 32 << 10,
                     "params": {"initial_depth": 1}}),
    ("sharded", {"params": {"num_shards": 2}}),
    ("race", {"load_factor": 0.6}),
    ("mica", {}),
    ("cluster", {"cache_budget_bytes": 16 << 10}),
    ("dummy", {}),
    ("outback-crash", {}),
]


def _parity_run(api, name, kw, keys, vals, telemetry, transport, **okw):
    kind = "outback" if name == "outback-crash" else name
    extra = {"load_factor": 0.85, **kw}
    if name == "outback-crash":
        sched_cls = (RFaultSchedule if api is r_api else FaultSchedule)
        extra.update(replicas=2, faults=sched_cls.single_crash(
            at_op=256, duration_ops=256, down_s=100e-6, lease_term_ops=128))
    st = api.open_store(
        api.StoreSpec(kind, telemetry=telemetry,
                      batch=api.BatchPolicy(window=64, order="relaxed"),
                      **extra),
        keys[:1024], vals[:1024], transport=transport, **okw)
    rng = np.random.default_rng(11)
    for i in range(12):
        st.get_batch(keys[rng.integers(0, 1024, 96)])
        if i % 3 == 0:
            st.update_batch(keys[i * 16:(i + 1) * 16],
                            vals[i * 16:(i + 1) * 16] + np.uint64(1))
    if name == "outback-dir":
        st.insert_batch(keys[1024:1536], vals[1024:1536])  # splits
    elif name in ("outback", "outback-crash"):
        st.insert_batch(keys[1024:1056], vals[1024:1056])
    st.delete_batch(keys[40:48])
    for i in range(8):
        st.submit("get", int(keys[i]))
    st.get(int(keys[3]))
    st.update(int(keys[4]), 77)
    st.flush()
    return st


@pytest.mark.parametrize("name,kw", _KINDS, ids=[k for k, _ in _KINDS])
def test_hub_matches_reference(name, kw):
    """Every counter, gauge, histogram, span, snapshot and export row of
    the port's hub equals the reference's; with the hub off the port's
    meters, trace and MN image are those of the hub-on run."""
    keys, vals = _dataset(2048, seed=13)
    r_tr, t_tr, t0_tr = RTransport(), Transport(), Transport()
    ref = _parity_run(r_api, name, kw, keys, vals,
                      r_obs.TelemetryConfig(window_ops=128), r_tr)
    port = _parity_run(t_api,
                       name, kw, keys, vals, TelemetryConfig(window_ops=128),
                       t_tr, device="cpu")
    off = _parity_run(t_api,
                      name, kw, keys, vals, None, t0_tr, device="cpu")
    hub, r_hub = port.telemetry, ref.telemetry
    assert hub.counters == r_hub.counters
    assert hub.gauges == r_hub.gauges
    assert {k: h.to_json_dict() for k, h in hub.hists.items()} == \
        {k: h.to_json_dict() for k, h in r_hub.hists.items()}
    assert _rows_json(hub) == _ref_rows_json(r_hub)
    validate_telemetry_rows(telemetry_rows(hub))
    if name == "outback-dir":
        assert port.engine.resize_events, "the run must split a table"
    # the plane only observes, in the port as in the reference
    assert off.telemetry is None
    assert port.meter_totals().snapshot() == off.meter_totals().snapshot() \
        == ref.meter_totals().snapshot()
    assert t_tr.trace == t0_tr.trace
    assert [repr(x) for x in t_tr.trace] == [repr(x) for x in r_tr.trace]
    if hasattr(port.engine, "mn_state"):
        assert pickle.dumps(port.engine.mn_state()) == \
            pickle.dumps(off.engine.mn_state())


def test_chrome_trace_matches_reference():
    keys, vals = _dataset()
    docs = []
    for api, tr, ct, kw in (
            (t_api, Transport(),
             chrome_trace, {"device": "cpu"}),
            (r_api, RTransport(), r_obs.chrome_trace, {})):
        st = api.open_store(
            api.StoreSpec("outback-dir", load_factor=0.85,
                          batch=api.BatchPolicy(window=64, order="relaxed")),
            keys[:1024], vals[:1024], transport=tr, **kw)
        for i in range(0, 512, 64):
            st.get_batch(keys[i:i + 64])
        st.insert_batch(keys[1024:2048], vals[1024:2048])
        st.flush()
        docs.append(json.dumps(ct(tr.trace, clients=3), sort_keys=True))
    assert docs[0] == docs[1]


@pytest.mark.parametrize("telemetry", [
    {"sample": 1.0}, {"window_ops": 0}, {"spans_max": -1}, "fast", 7,
    {"window_ops": 8, "extra": 2}])
def test_malformed_telemetry_raises_the_reference_error(telemetry):
    def err(api):
        try:
            api.StoreSpec("outback", telemetry=telemetry).validate()
        except Exception as e:  # noqa: BLE001 - compare whatever it is
            return type(e).__name__, str(e)
        return None
    got, want = err(t_api), \
        err(r_api)
    assert want is not None and got == want
    assert got[0] == SpecError.__name__
