"""The port's serving front door (``repro_torch.serve.frontdoor``) against
``repro.serve.frontdoor``.

The 15 tests of ``tests/test_frontdoor.py``, run against ``repro_torch``
on the CPU (``device="cpu"``).  Each scenario runs through both packages
over the same keys: the front door's records (every field, as
``dataclasses.astuple``), ``stats()``, ``lane_arrivals()``,
``meter_totals().snapshot()``, the transport trace (as tuples),
``state_signature(engine.mn_state())`` and, where telemetry is on, the
hub's counters must be equal; then the reference test's own assertions
hold on the port's run.
"""

import dataclasses
import types

import numpy as np
import pytest

from repro import api as r_api
from repro import net as r_net
from repro import serve as r_serve
from repro import obs as r_obs
from repro.net.chaos import state_signature as r_sig
from repro.net.faults import FaultSchedule as RFaultSchedule
from repro.net.replay import simulate_open as r_simulate_open
from repro_torch import api as t_api
from repro_torch import net as t_net
from repro_torch import obs as t_obs
from repro_torch import serve as t_serve
from repro_torch.net.chaos import state_signature as t_sig
from repro_torch.net.faults import FaultSchedule
from repro_torch.net.replay import simulate_open
from repro_torch.serve import (FrontDoor, FrontDoorConfig, TenantLimit,
                               TenantSpec, TrafficSpec, generate)

N = 8_000

REF = types.SimpleNamespace(api=r_api, net=r_net, serve=r_serve, obs=r_obs,
                            sig=r_sig, faults=RFaultSchedule, kw={})
PORT = types.SimpleNamespace(api=t_api, net=t_net, serve=t_serve, obs=t_obs,
                             sig=t_sig, faults=FaultSchedule,
                             kw={"device": "cpu"})


@pytest.fixture(scope="module")
def data():
    from repro_torch.core.hashing import splitmix64
    from repro_torch.core.store import make_uniform_keys
    keys = make_uniform_keys(N, 3)
    return keys, splitmix64(keys)


def _open(P, keys, vals, **spec_kw):
    tr = P.net.Transport()
    spec = P.api.StoreSpec("outback", load_factor=0.85,
                           batch=P.api.BatchPolicy(window=256), **spec_kw)
    return P.api.open_store(spec, keys, vals, transport=tr, **P.kw), tr


def _cfg(P, **kw):
    """A ``FrontDoorConfig`` of package ``P`` (limits rebuilt there)."""
    kw = dict(kw)
    if "limits" in kw:
        kw["limits"] = tuple(P.serve.TenantLimit(**dataclasses.asdict(l))
                             for l in kw["limits"])
    return P.serve.FrontDoorConfig(**kw)


def _trace(trace):
    return [(type(x).__name__, dataclasses.astuple(x)) for x in trace]


def _artifacts(P, fd, st, tr):
    hub = getattr(st, "hub", None)
    return {"records": [dataclasses.astuple(r) for r in fd.records],
            "stats": fd.stats(),
            "arrivals": fd.lane_arrivals(),
            "meter": st.meter_totals().snapshot(),
            "trace": _trace(tr.trace),
            "state": P.sig(st.engine.mn_state()),
            "counters": None if hub is None else dict(hub.counters),
            "hists": None if hub is None else
            {k: (h.n, list(h.counts)) for k, h in hub.hists.items()}}


def _plain(x):
    """Records and tuples of them as plain values (the two packages'
    classes differ by module)."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, dataclasses.astuple(x))
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _both(scenario, *args):
    """``scenario(P, *args) -> (front_door, store, transport, extra)`` in
    both packages; the artifacts and extras must be equal.  Returns the
    port's run."""
    t = scenario(PORT, *args)
    r = scenario(REF, *args)
    assert _artifacts(PORT, *t[:3]) == _artifacts(REF, *r[:3])
    assert _plain(t[3]) == _plain(r[3])
    return t


# ------------------------------------------------------------ singleflight
def test_collapsed_gets_share_the_leaders_answer(data):
    keys, vals = data

    def run(P):
        st, tr = _open(P, keys, vals)
        fd = P.serve.FrontDoor(st, _cfg(P, singleflight=True, window=64))
        k = int(keys[5])
        recs = [fd.offer("a", "get", k, t_s=i * 1e-6) for i in range(5)]
        miss = fd.offer("b", "get", int(keys[5]) ^ 0x1357_9BDF, t_s=6e-6)
        fd.flush()
        return fd, st, tr, (recs, miss)

    fd, st, tr, (recs, miss) = _both(run)
    leader, followers = recs[0], recs[1:]
    assert leader.outcome == "ok" and leader.found
    assert leader.result == int(vals[5])
    for f in followers:
        assert f.outcome == "collapsed"
        assert (f.found, f.result, f.lane) == (True, int(vals[5]),
                                               leader.lane)
    assert not miss.found and miss.outcome == "ok"
    assert fd.stats()["lanes"] == 2
    m = st.meter_totals()
    assert m.sf_hits == 4
    assert m.saved_round_trips >= 4


def test_singleflight_window_scope(data):
    keys, vals = data

    def run(P):
        st, tr = _open(P, keys, vals)
        fd = P.serve.FrontDoor(st, _cfg(P, singleflight=True, window=64))
        k = int(keys[9])
        fd.offer("a", "get", k, t_s=0.0)
        fd.flush()
        again = fd.offer("a", "get", k, t_s=1e-6)
        fd.flush()
        return fd, st, tr, again

    fd, st, tr, again = _both(run)
    assert again.outcome == "ok"
    assert fd.stats()["lanes"] == 2
    assert st.meter_totals().sf_hits == 0


def test_write_after_collapsed_read_hazard_flushes(data):
    keys, vals = data

    def run(P):
        st, tr = _open(P, keys, vals)
        fd = P.serve.FrontDoor(st, _cfg(P, singleflight=True, window=4096))
        k = int(keys[11])
        g1 = fd.offer("a", "get", k, t_s=0.0)
        g2 = fd.offer("b", "get", k, t_s=1e-6)
        before = (g2.outcome, g1.found, g1.result, g2.found, g2.result)
        w = fd.offer("a", "update", k, 0xBEEF, t_s=2e-6)
        after = (g1.found, g1.result, g2.found, g2.result)
        g3 = fd.offer("b", "get", k, t_s=3e-6)
        fd.flush()
        return fd, st, tr, (before, after, w, g3)

    fd, st, tr, (before, after, w, g3) = _both(run)
    assert before[0] == "collapsed"
    assert after == (True, int(vals[11]), True, int(vals[11]))
    assert w.outcome == "ok" and w.found
    assert g3.found and g3.result == 0xBEEF
    assert g3.outcome == "ok"


def test_get_then_write_then_get_orders_without_singleflight(data):
    keys, vals = data

    def run(P):
        st, tr = _open(P, keys, vals)
        fd = P.serve.FrontDoor(st, _cfg(P, max_inflight=64, queue_depth=64,
                                        window=4096))
        k = int(keys[13])
        g1 = fd.offer("a", "get", k, t_s=0.0)
        fd.offer("a", "update", k, 0xCAFE, t_s=1e-6)
        g2 = fd.offer("a", "get", k, t_s=2e-6)
        fd.flush()
        return fd, st, tr, (g1, g2)

    _, _, _, (g1, g2) = _both(run)
    assert g1.result == int(vals[13]) and g2.result == 0xCAFE


# ------------------------------------------------- admission + rate limits
def test_admission_sheds_deterministically(data):
    keys, vals = data
    kw = dict(max_inflight=2, queue_depth=2, service_us=10.0, window=64)

    def run(P):
        st, tr = _open(P, keys, vals)
        fd = P.serve.FrontDoor(st, _cfg(P, **kw))
        recs = [fd.offer("a", "get", int(keys[i]), t_s=0.0)
                for i in range(8)]
        fd.flush()
        return fd, st, tr, recs

    fd, st, tr, recs = _both(run)
    assert [r.outcome for r in recs] == ["ok"] * 4 + ["shed"] * 4
    assert [r.release_s for r in recs[:4]] == \
        pytest.approx([0.0, 0.0, 10e-6, 10e-6])
    assert fd.stats()["lanes"] == 4
    assert len(fd.lane_arrivals()) == 4
    fd2, _, _, recs2 = run(PORT)
    assert [(r.outcome, r.release_s) for r in recs2] == \
        [(r.outcome, r.release_s) for r in recs]


def test_token_bucket_limits_one_tenant_only(data):
    keys, vals = data

    def run(P):
        st, tr = _open(P, keys, vals)
        fd = P.serve.FrontDoor(st, _cfg(
            P, window=64, limits=(TenantLimit("b", 100_000.0, burst=2.0),)))
        a_ok = b_ok = b_lim = 0
        for i in range(40):
            t = i * 1e-6
            ra = fd.offer("a", "get", int(keys[i]), t_s=t)
            rb = fd.offer("b", "get", int(keys[40 + i]), t_s=t)
            a_ok += ra.outcome == "ok"
            b_ok += rb.outcome == "ok"
            b_lim += rb.outcome == "ratelimited"
        fd.flush()
        return fd, st, tr, (a_ok, b_ok, b_lim)

    fd, _, _, (a_ok, b_ok, b_lim) = _both(run)
    assert a_ok == 40
    assert b_ok + b_lim == 40 and 2 <= b_ok <= 7
    assert fd.stats()["ratelimited"] == b_lim


def test_rejections_are_answers_not_hangs(data):
    keys, vals = data

    def run(P):
        st, tr = _open(P, keys, vals)
        fd = P.serve.FrontDoor(st, _cfg(P, max_inflight=1, queue_depth=0,
                                        service_us=50.0, window=16))
        r1 = fd.offer("a", "get", int(keys[0]), t_s=0.0)
        r2 = fd.offer("a", "get", int(keys[1]), t_s=0.0)
        fd.flush()
        return fd, st, tr, (r1, r2)

    _, _, _, (r1, r2) = _both(run)
    assert r1.outcome == "ok"
    assert r2.outcome == "shed" and not r2.found and r2.lane == -1


def test_unavailable_surfaces_as_typed_outcome(data):
    keys, vals = data

    def run(P):
        sched = P.faults.single_crash(at_op=2, duration_ops=4_096,
                                      max_retries=1, lease_term_ops=0)
        st, tr = _open(P, keys, vals, faults=sched)
        fd = P.serve.FrontDoor(st, _cfg(P, singleflight=True, window=32))
        recs = [fd.offer("a", "get", int(keys[i % 16]), t_s=i * 1e-6)
                for i in range(256)]
        fd.flush()
        return fd, st, tr, recs

    st_state = {}

    def artifacts(P, run_):
        fd, st, tr, recs = run_
        # a replicated store's MN images: one a replica
        rs = st.inner
        while not hasattr(rs, "replicas"):
            rs = rs.inner
        st_state[P is PORT] = [P.sig(r.engine.mn_state())
                               for r in rs.replicas]
        return ([dataclasses.astuple(r) for r in fd.records], fd.stats(),
                fd.lane_arrivals(), st.meter_totals().snapshot(),
                _trace(tr.trace))

    t, r = run(PORT), run(REF)
    assert artifacts(PORT, t) == artifacts(REF, r)
    assert st_state[True] == st_state[False]
    recs = t[3]
    outcomes = {x.outcome for x in recs}
    assert "unavailable" in outcomes
    assert outcomes <= {"ok", "collapsed", "unavailable"}
    for x in recs:
        if x.outcome == "unavailable":
            assert not x.found


# ------------------------------------------------------- config round trip
def test_config_json_round_trip():
    cfg = FrontDoorConfig(max_inflight=8, queue_depth=32, service_us=3.5,
                          singleflight=True, window=128,
                          limits=(TenantLimit("a", 1e5, burst=4.0),))
    back = FrontDoorConfig.from_json_dict(cfg.to_json_dict())
    assert back == cfg
    assert not cfg.passthrough and FrontDoorConfig().passthrough
    ref = r_serve.FrontDoorConfig.from_json_dict(cfg.to_json_dict())
    assert ref.to_json_dict() == cfg.to_json_dict()
    assert FrontDoorConfig.from_json_dict(ref.to_json_dict()) == cfg


@pytest.mark.parametrize("bad", [
    dict(max_inflight=-1),
    dict(queue_depth=4),
    dict(service_us=0.0),
    dict(window=0),
    dict(limits=(TenantLimit("a", 1e5), TenantLimit("a", 2e5))),
    dict(limits=(TenantLimit("a", 0.0),)),
    dict(limits=(TenantLimit("a", 1e5, burst=0.5),)),
])
def test_invalid_configs_raise(bad):
    with pytest.raises(ValueError) as got:
        FrontDoorConfig(**bad).validate()
    with pytest.raises(ValueError) as want:
        _cfg(REF, **bad).validate()
    assert str(got.value) == str(want.value)


def test_config_rejects_unknown_fields():
    with pytest.raises(ValueError, match="unknown FrontDoorConfig"):
        FrontDoorConfig.from_json_dict({"max_inflight": 2, "qps": 8})


def test_offers_must_be_time_ordered(data):
    keys, vals = data
    for P in (PORT, REF):
        st, _ = _open(P, keys, vals)
        fd = P.serve.FrontDoor(st, _cfg(P, singleflight=True))
        fd.offer("a", "get", int(keys[0]), t_s=5e-6)
        with pytest.raises(ValueError, match="non-decreasing"):
            fd.offer("a", "get", int(keys[1]), t_s=4e-6)
        with pytest.raises(ValueError, match="unknown op"):
            fd.offer("a", "scan", int(keys[0]), t_s=6e-6)


# ------------------------------------------------------ telemetry counters
def test_hub_counters_follow_outcomes(data):
    keys, vals = data

    def run(P):
        st, tr = _open(P, keys, vals,
                       telemetry=P.obs.TelemetryConfig(window_ops=1024))
        fd = P.serve.FrontDoor(st, _cfg(
            P, max_inflight=2, queue_depth=1, service_us=25.0,
            singleflight=True, window=64,
            limits=(TenantLimit("b", 50_000.0),)))
        for i in range(64):
            fd.offer("a", "get", int(keys[i % 4]), t_s=i * 1e-6)
            fd.offer("b", "get", int(keys[8 + i % 4]), t_s=i * 1e-6)
        fd.flush()
        return fd, st, tr, None

    fd, st, _, _ = _both(run)
    s = fd.stats()
    c = st.hub.counters
    assert c.get("frontdoor.singleflight_hits", 0) == s["collapsed"]
    assert c.get("frontdoor.shed{reason=queue_full}", 0) == s["shed"]
    assert c.get("frontdoor.ratelimited{tenant=b}", 0) == s["ratelimited"]
    admitted = sum(v for k, v in c.items()
                   if k.startswith("frontdoor.admitted"))
    assert admitted == s["ok"] + s["collapsed"]
    hw = [h for name, h in st.hub.hists.items()
          if name.startswith("frontdoor.queue_wait_us")]
    assert hw and sum(h.n for h in hw) == s["ok"]


# ------------------------------------------------------- dormant identity
def test_default_frontdoor_is_byte_invisible(data):
    keys, vals = data
    spec = TrafficSpec(
        tenants=(TenantSpec(name="a", rate_ops_per_s=300_000.0,
                            read_frac=0.7, insert_frac=0.1),),
        duration_s=0.004, seed=21)
    offered = generate(spec, keys)
    got = {}
    for P in (PORT, REF):
        for through_door in (False, True):
            st, tr = _open(P, keys, vals)
            if through_door:
                fd = P.serve.FrontDoor(st)
                recs = fd.run(offered)
                assert [r.outcome for r in recs] == ["ok"] * len(recs)
                assert len(fd.lane_arrivals()) == len(recs)
                answers = [(r.found, r.result) for r in recs]
            else:
                hs = [st.submit(o.op, o.key, o.value) for o in offered]
                st.flush()
                answers = [(bool(h.result().found[0]),
                            int(h.result().values[0])) for h in hs]
            got[P is PORT, through_door] = (
                answers, st.meter_totals().snapshot(), _trace(tr.trace),
                P.sig(st.engine.mn_state()))
    assert got[True, False] == got[True, True]
    assert got[True, True] == got[False, True] == got[False, False]


# --------------------------------------------------- open-loop sim joining
def test_lane_arrivals_align_with_trace(data):
    keys, vals = data
    spec = TrafficSpec(
        tenants=(TenantSpec(name="a", rate_ops_per_s=400_000.0,
                            keyspace=256),),
        duration_s=0.004, seed=33)
    offered = generate(spec, keys)

    def run(P):
        st, tr = _open(P, keys, vals)
        fd = P.serve.FrontDoor(st, _cfg(P, singleflight=True, window=128))
        fd.run(offered)
        return fd, st, tr, None

    fd, st, tr, _ = _both(run)
    r_fd, _, r_tr, _ = run(REF)
    recs = fd.records
    arr = np.asarray(fd.lane_arrivals())
    n_ops = sum(1 for it in tr.trace if type(it).__name__ == "OpEvent")
    assert len(arr) == n_ops == fd.stats()["lanes"]
    res = simulate_open(tr.trace, arr)
    want = r_simulate_open(r_tr.trace, np.asarray(r_fd.lane_arrivals()))
    for f in ("lat_by_op_us", "completions_by_op_s"):
        np.testing.assert_array_equal(np.asarray(getattr(res, f)),
                                      np.asarray(getattr(want, f)))
    assert res.seconds == want.seconds and res.n_ops == want.n_ops
    assert len(res.lat_by_op_us) == n_ops
    for r in recs:
        if r.outcome == "ok":
            assert res.completions_by_op_s[r.lane] >= r.release_s
        elif r.outcome == "collapsed":
            assert res.completions_by_op_s[r.lane] > 0.0
    with pytest.raises(ValueError, match="arrival"):
        simulate_open(tr.trace, arr[:-1])
