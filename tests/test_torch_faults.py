"""The failure plane of the port (``repro_torch.net.faults``,
``repro_torch.api.replication``, ``RetryLayer``, leases) against ``repro``.

Two halves:

* the 15 tests of ``tests/test_faults.py``, run against ``repro_torch``
  on the CPU (``device="cpu"``): determinism, zero lost acknowledged
  writes at K=2, the dormant plane's byte identity, K=1's degraded
  answers, drops, the pipeline through a failover, the replay's replica
  routing and fault windows, and a directory store through a split;
* parity: one seeded stream through ``repro.api.open_store`` and
  ``repro_torch.api.open_store`` for every spec of
  ``tests/_torch_fault_specs.py`` (K=2 and K=1 crashes, a generated
  schedule, a partition, ``cn_delay``, ``cn_drop``, a cached K=2 store
  that answers degraded, ``outback-dir`` twins through a split and HRW
  placement at K=3), synchronously and through a window of 64.  Answers,
  statuses, each ``OpResult``'s attribution, the pipeline's stats,
  ``meter_totals().snapshot()``, the transport traces, every ``SimResult``
  field of ``simulate(..., replicas=K)``, each replica's final
  ``mn_state`` image and the plane's state must be equal: integers and
  bytes exactly, float wait times to the last bit (they are the same
  Python float expressions).  The fault plane itself is held call for
  call against the reference's, and a schedule's JSON is the same in both
  packages.
"""

import dataclasses

import numpy as np
import pytest

from repro import api as r_api
from repro import net as r_net
from repro.net.replay import simulate as r_simulate
from repro_torch import api as t_api
from repro_torch.api import (BatchPolicy, ReplicaSetAdapter, SpecError,
                             StoreSpec, open_store)
from repro_torch.kernels import ops
from repro_torch.net import (FaultEvent, FaultPlane, FaultSchedule,
                             Transport, simulate)

from _torch_fault_specs import (POLICIES, SPECS, drive, fault_data,
                                fault_stream, replica_set, state_sig,
                                with_policy)

N = 2048


@pytest.fixture(scope="module")
def data():
    return fault_data(N)


def _open(spec, keys, vals, **kw):
    return open_store(spec, keys, vals, device="cpu", **kw)


def _crash_spec(**knobs):
    sched = FaultSchedule.single_crash(at_op=64, duration_ops=256,
                                       lease_term_ops=knobs.pop(
                                           "lease_term_ops", 128),
                                       **knobs)
    return StoreSpec("outback", load_factor=0.85, replicas=2, faults=sched)


# ---------------------------------------------------------------- schedules


def test_schedule_json_roundtrip():
    s = FaultSchedule.generate(7, 4000, replicas=3)
    rt = FaultSchedule.from_json(s.to_json())
    assert rt == s and len(rt.events) > 0


def test_schedule_validation():
    with pytest.raises(ValueError, match="kind"):
        FaultEvent("meteor", 1, 2).validate()
    with pytest.raises(ValueError):
        FaultSchedule(events=(FaultEvent("mn_crash", -1, 5),)).validate()
    with pytest.raises(ValueError, match="unknown"):
        FaultEvent.from_json_dict({"kind": "mn_crash", "at_op": 1,
                                   "duration_ops": 2, "spice": 9})


def test_spec_rejects_bad_fault_configs():
    with pytest.raises(SpecError, match="mn_state"):
        StoreSpec("race", replicas=2).validate()
    with pytest.raises(SpecError, match="replicas"):
        StoreSpec("outback", replicas=0).validate()
    with pytest.raises(SpecError, match="targets MN"):
        StoreSpec("outback", replicas=2,
                  faults=FaultSchedule.single_crash(1, 2, mn=3)).validate()


def test_plane_is_deterministic():
    sched = FaultSchedule.generate(21, 3000)
    a, b = FaultPlane(sched), FaultPlane(sched)
    seq_a, seq_b = [], []
    for plane, seq in ((a, seq_a), (b, seq_b)):
        for _ in range(3000):
            plane.tick(1)
            seq.append((plane.crash_open(0), plane.crash_open(1),
                        plane.drop_now(), round(plane.delay_us(), 6),
                        round(plane.backoff_us(2), 6)))
    assert seq_a == seq_b


# ------------------------------------------------------------- determinism


def _run_once(data):
    build_k, build_v, w_k, w_v = data
    tr = Transport()
    st = _open(_crash_spec(), build_k, build_v, transport=tr)
    for i in range(12):
        st.get_batch(build_k[i * 32:(i + 1) * 32])
        st.insert_batch(w_k[i * 8:(i + 1) * 8], w_v[i * 8:(i + 1) * 8])
    for i in range(12):  # ride past the window so resync happens in-run
        st.get_batch(build_k[i * 32:(i + 1) * 32])
    res = simulate(tr.trace, clients=2, replicas=2)
    return (tr.trace, st.meter_totals().snapshot(), res.percentiles(),
            state_sig(st.engine.mn_state()))


def test_same_seed_same_schedule_is_bit_identical(data):
    trace_a, snap_a, pct_a, state_a = _run_once(data)
    trace_b, snap_b, pct_b, state_b = _run_once(data)
    assert trace_a == trace_b
    assert snap_a == snap_b
    assert pct_a == pct_b
    assert state_a == state_b


# ------------------------------------------------- crash recovery (K = 2)


def test_zero_lost_acked_writes_at_k2(data):
    build_k, build_v, w_k, w_v = data
    st = _open(_crash_spec(), build_k, build_v)
    acked = []
    for i in range(24):
        r = st.insert_batch(w_k[i * 8:(i + 1) * 8], w_v[i * 8:(i + 1) * 8])
        stats = r.statuses or ("ok",) * 8
        for k, v, ok, case in zip(w_k[i * 8:], w_v[i * 8:], r.found, stats):
            if ok and case not in ("backoff", "unavailable"):
                acked.append((int(k), int(v)))
        st.get_batch(build_k[:16])
    for _ in range(12):  # let the window close and the resync land
        st.get_batch(build_k[:32])
    m = st.meter_totals()
    assert m.failovers >= 1, "crash never drove a failover"
    assert m.resyncs >= 1, "restart never shipped a state image"
    assert m.retries >= 1 and m.backoffs >= 1
    ak = np.asarray([k for k, _ in acked], np.uint64)
    av = np.asarray([v for _, v in acked], np.uint64)
    g = st.get_batch(ak)
    assert bool(g.found.all()), "acked write unreadable after recovery"
    assert np.array_equal(g.values, av)
    # both replicas converge to the same MN image after resync
    sigs = {state_sig(r.engine.mn_state()) for r in replica_set(st).replicas}
    assert len(sigs) == 1, "replicas diverged after crash recovery"


def test_failover_attribution_lands_on_the_opresult(data):
    build_k, build_v, _, _ = data
    st = _open(_crash_spec(), build_k, build_v)
    saw = None
    for i in range(40):
        r = st.get_batch(build_k[i * 16:(i + 1) * 16])
        if r.failovers:
            saw = r
            break
    assert saw is not None, "no call carried the failover delta"
    assert saw.retries >= 1 and saw.backoffs >= 1


def test_lease_renewals_follow_the_op_clock(data):
    build_k, build_v, _, _ = data
    spec = StoreSpec("outback", load_factor=0.85, replicas=2,
                     faults=FaultSchedule(lease_term_ops=64))
    st = _open(spec, build_k, build_v)
    st.get_batch(build_k[:32])
    first = st.meter_totals().lease_renewals
    assert first >= 1  # granted on first use
    for i in range(8):
        st.get_batch(build_k[i * 32:(i + 1) * 32])
    assert st.meter_totals().lease_renewals > first


# --------------------------------------------------------- K = 1 degraded


def test_k1_degrades_to_unavailable_then_recovers(data):
    build_k, build_v, _, _ = data
    sched = FaultSchedule.single_crash(at_op=8, duration_ops=128,
                                       max_retries=1, lease_term_ops=0)
    st = _open(StoreSpec("outback", load_factor=0.85, faults=sched),
               build_k, build_v)
    degraded = 0
    for i in range(24):
        r = st.get_batch(build_k[i * 16:(i + 1) * 16])
        if r.statuses is not None:
            degraded += r.statuses.count("unavailable")
            assert not r.found.any()  # degraded lanes answer found=False
    assert degraded > 0
    post = st.get_batch(build_k[:64])
    assert post.statuses is None and bool(post.found.all())


def test_degraded_answers_do_not_poison_the_cn_cache(data):
    build_k, build_v, _, _ = data
    sched = FaultSchedule.single_crash(at_op=4, duration_ops=48,
                                       max_retries=0, lease_term_ops=0)
    st = _open(StoreSpec("outback", load_factor=0.85, faults=sched,
                         cache_budget_bytes=1 << 15), build_k, build_v)
    for _ in range(8):
        st.get_batch(build_k[:8])
    r = st.get_batch(build_k[:8])
    assert r.statuses is None and bool(r.found.all())
    assert st.meter_totals().cache_neg_hits == 0


# ------------------------------------------------------- dormant identity


def test_dormant_plane_meters_byte_identically(data):
    build_k, build_v, w_k, w_v = data
    snaps, traces = [], []
    for spec in (StoreSpec("outback", load_factor=0.85),
                 StoreSpec("outback", load_factor=0.85,
                           faults=FaultSchedule(lease_term_ops=0))):
        tr = Transport()
        st = _open(spec, build_k, build_v, transport=tr)
        st.get_batch(build_k[:256])
        st.insert_batch(w_k[:32], w_v[:32])
        st.update_batch(build_k[:32], build_v[:32])
        st.delete_batch(w_k[:16])
        snaps.append(st.meter_totals().snapshot())
        traces.append(tr.trace)
    assert snaps[0] == snaps[1]
    assert traces[0] == traces[1]


# ---------------------------------------------------------------- pipeline


def test_pipelined_handles_resolve_through_a_failover(data):
    build_k, build_v, _, _ = data
    sched = FaultSchedule.single_crash(at_op=70, duration_ops=300,
                                       lease_term_ops=0)
    st = _open(StoreSpec("outback", load_factor=0.85, replicas=2,
                         faults=sched,
                         batch=BatchPolicy(window=64, order="relaxed")),
               build_k, build_v)
    handles = [st.submit("get", build_k[i * 32:(i + 1) * 32])
               for i in range(12)]
    st.flush()
    assert all(h.done for h in handles)
    assert sum(int(h.result().found.sum()) for h in handles) == 12 * 32
    assert st.meter_totals().failovers >= 1
    assert st.stats.unavailable_lanes == 0


# ------------------------------------------------------------------ drops


def test_drop_windows_cost_a_retry_not_an_answer(data):
    build_k, build_v, _, _ = data
    sched = FaultSchedule(events=(FaultEvent("drop", 8, 64, drop_rate=1.0),),
                          lease_term_ops=0, seed=3)
    st = _open(StoreSpec("outback", load_factor=0.85, faults=sched),
               build_k, build_v)
    for i in range(16):
        r = st.get_batch(build_k[i * 16:(i + 1) * 16])
        assert r.statuses is None or "unavailable" not in r.statuses
        assert bool(r.found.all())
    m = st.meter_totals()
    assert m.drops >= 1 and m.retries >= 1


# ------------------------------------------------------------------ replay


def test_replay_routes_replicas_and_applies_fault_windows(data):
    build_k, build_v, w_k, w_v = data
    tr = Transport()
    st = _open(_crash_spec(down_s=100e-6), build_k, build_v, transport=tr)
    for i in range(12):
        st.get_batch(build_k[i * 32:(i + 1) * 32])
        st.insert_batch(w_k[i * 8:(i + 1) * 8], w_v[i * 8:(i + 1) * 8])
    for i in range(12):
        st.get_batch(build_k[i * 32:(i + 1) * 32])
    segs = [s for ev in tr.trace if hasattr(ev, "segments")
            for s in ev.segments]
    assert {s.mn for s in segs} == {0, 1}, "multicast never reached MN 1"
    assert any(s.wait_s > 0 for s in segs), "no CN stall reached the trace"
    res = simulate(tr.trace, clients=2, replicas=2)
    assert res.fault_windows and res.fault_windows[0][2] == "mn_crash"
    av = res.availability()
    assert av["schema"] == "outback-availability/v1"
    assert len(av["availability"]) == len(av["t_s"]) == 40
    assert av["fault_windows"]
    # two runs of the same trace are bit-identical
    res2 = simulate(tr.trace, clients=2, replicas=2)
    assert np.array_equal(res.latencies_us, res2.latencies_us)


def test_directory_store_replicates_through_a_split(data):
    """outback-dir at K=2: a crash over a store that *split* during the
    window still resyncs (the restarted replica rebuilds its table list
    from the donor's shipped CN locators)."""
    build_k, build_v, w_k, w_v = data
    sched = FaultSchedule.single_crash(at_op=48, duration_ops=192,
                                       lease_term_ops=0)
    spec = StoreSpec("outback-dir", load_factor=0.85, replicas=2,
                     faults=sched, params={"initial_depth": 1})
    st = _open(spec, build_k, build_v)
    for i in range(24):  # inserts force splits inside the crash window
        st.insert_batch(w_k[i * 32:(i + 1) * 32], w_v[i * 32:(i + 1) * 32])
        st.get_batch(build_k[:16])
    for _ in range(8):
        st.get_batch(build_k[:32])
    m = st.meter_totals()
    assert m.resyncs >= 1
    g = st.get_batch(w_k[:24 * 32])
    ok = g.found
    assert bool(ok.all())
    assert np.array_equal(g.values[ok], w_v[:24 * 32][ok])
    sigs = {state_sig(r.engine.mn_state()) for r in replica_set(st).replicas}
    assert len(sigs) == 1, "directory replicas diverged through the split"


# ------------------------------------------------- parity with the reference


def _r_schedule(sched: FaultSchedule):
    return r_net.FaultSchedule.from_json(sched.to_json())


def test_schedules_have_the_reference_json():
    scheds = [FaultSchedule.generate(s, n, replicas=k)
              for s, n, k in ((0, 16, 1), (7, 4000, 3), (21, 3000, 2),
                              (2**40 + 3, 10**6, 5))]
    scheds += [FaultSchedule.single_crash(3 << 17, 1 << 17, mn=1,
                                          down_s=2e-4, lease_term_ops=4096),
               FaultSchedule(events=(
                   FaultEvent("partition", 5, 9, mn=-1, cn=2, down_s=1e-4),
                   FaultEvent("nic_saturation", 0, 4, mn=1, factor=3.0,
                              down_s=5e-5),
                   FaultEvent("cn_crash", 2, 8, cn=1, down_s=1e-4),
                   FaultEvent("cn_delay", 1, 3, cn=1, extra_us=2.5),
                   FaultEvent("cn_drop", 1, 3, cn=1, drop_rate=0.25)))]
    for s in scheds:
        r = _r_schedule(s)
        assert r.to_json() == s.to_json()
        assert FaultSchedule.from_json(r.to_json()) == s
    for s, n, k in ((0, 16, 1), (7, 4000, 3), (2**40 + 3, 10**6, 5)):
        assert FaultSchedule.generate(s, n, replicas=k).to_json() == \
            r_net.FaultSchedule.generate(s, n, replicas=k).to_json()


def test_schedule_validation_matches_reference():
    bad = [dict(kind="mn_crash", at_op=0, duration_ops=1),  # no down_s
           dict(kind="delay", at_op=0, duration_ops=1),
           dict(kind="drop", at_op=0, duration_ops=1, drop_rate=1.5),
           dict(kind="cn_delay", at_op=0, duration_ops=1, mn=1,
                extra_us=1.0),
           dict(kind="nic_saturation", at_op=0, duration_ops=1, factor=1.0,
                down_s=1.0),
           dict(kind="partition", at_op=0, duration_ops=1, mn=-2,
                down_s=1.0)]
    for d in bad:
        with pytest.raises(ValueError) as e_t:
            FaultEvent.from_json_dict(d)
        with pytest.raises(ValueError) as e_r:
            r_net.FaultEvent.from_json_dict(d)
        assert str(e_t.value) == str(e_r.value)
    overlap = dict(events=[
        dict(kind="partition", at_op=0, duration_ops=10, mn=-1, cn=0,
             down_s=1.0),
        dict(kind="partition", at_op=5, duration_ops=10, mn=1, cn=0,
             down_s=1.0)])
    with pytest.raises(ValueError) as e_t:
        FaultSchedule.from_json_dict(overlap)
    with pytest.raises(ValueError) as e_r:
        r_net.FaultSchedule.from_json_dict(overlap)
    assert str(e_t.value) == str(e_r.value)


@pytest.mark.parametrize("seed", [0, 21, 99])
def test_plane_decides_as_the_reference_call_for_call(seed):
    sched = FaultSchedule(
        events=FaultSchedule.generate(seed, 3000, replicas=3).events + (
            FaultEvent("partition", 400, 300, mn=-1, cn=1, down_s=1e-4),
            FaultEvent("partition", 900, 50, mn=2, cn=0, down_s=1e-4),
            FaultEvent("nic_saturation", 100, 700, mn=2, factor=2.0,
                       down_s=1e-4),
            FaultEvent("cn_crash", 1200, 30, cn=1, down_s=1e-4),
            FaultEvent("cn_delay", 1500, 200, cn=1, extra_us=1.5),
            FaultEvent("cn_drop", 1600, 400, cn=0, drop_rate=0.3)),
        seed=seed, lease_term_ops=64)
    t, r = FaultPlane(sched), r_net.FaultPlane(_r_schedule(sched))
    rng = np.random.default_rng(seed)
    for _ in range(2500):
        n = int(rng.integers(1, 4))
        t.tick(n)
        r.tick(n)
        mn, cn, att = (int(rng.integers(0, 3)), int(rng.integers(0, 2)),
                       int(rng.integers(0, 9)))

        def ask(p):
            out = (p.clock, p.crash_open(mn), p.cn_crash_open(cn),
                   p.partition_open(cn, mn), p.fully_partitioned(cn, 3),
                   p.delay_us(cn), p.drop_now(cn), p.backoff_us(att),
                   p.lease_due(mn),
                   [ev.to_json_dict() for ev in p.new_marks()],
                   [ev.to_json_dict() for ev in p.new_window_events()])
            if out[8]:
                p.lease_granted(mn)
            elif mn == 1 and p.clock % 7 == 0:
                p.lease_revoked(mn)
            return out

        assert ask(t) == ask(r)


def _sim_fields(res) -> dict:
    out = {}
    for f in dataclasses.fields(res):
        x = getattr(res, f.name)
        out[f.name] = ((x.dtype.str, x.tobytes()) if isinstance(x, np.ndarray)
                       else x)
    return out


def _r_adapter(store):
    adapter = store
    while not isinstance(adapter, r_api.ReplicaSetAdapter):
        adapter = adapter.inner
    return adapter


def _run(api, spec, data, calls, pipelined, tr, **kw):
    st = api.open_store(spec, data[0], data[1], transport=tr, **kw)
    try:
        return st, drive(st, calls, pipelined), None
    except RuntimeError as e:
        return st, None, str(e)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("name", list(SPECS))
def test_stream_matches_reference(data, name, policy):
    spec, shape = SPECS[name]
    t_spec = with_policy(spec, policy)
    r_spec = r_api.StoreSpec.from_json(t_spec.to_json())
    assert r_spec.to_json() == t_spec.to_json()
    calls = fault_stream(data, shape)
    r_tr, t_tr = r_net.Transport(), Transport()
    r, r_out, r_err = _run(r_api, r_spec, data, calls, policy != "sync",
                           r_tr)
    t, t_out, t_err = _run(t_api, t_spec, data, calls, policy != "sync",
                           t_tr, device="cpu")
    assert t_err == r_err
    if name == "dir_hrw_diverged" and policy == "sync":
        assert t_err is not None and "diverged" in t_err
    else:  # coalesced, the window's calls land the splits after the resync
        assert t_err is None
        assert t_out == r_out
    assert dataclasses.asdict(t.stats) == dataclasses.asdict(r.stats)
    m = t.meter_totals().snapshot()
    assert m == r.meter_totals().snapshot()
    assert [(type(e).__name__, dataclasses.astuple(e)) for e in t_tr.trace] \
        == [(type(e).__name__, dataclasses.astuple(e)) for e in r_tr.trace]
    ta, ra = replica_set(t), _r_adapter(r)
    assert (ta.primary, sorted(ta._needs_resync), ta.plane.clock,
            ta.plane._draws, ta.plane._lease_at) == \
        (ra.primary, sorted(ra._needs_resync), ra.plane.clock,
         ra.plane._draws, ra.plane._lease_at)
    for a, b in zip(ta.replicas, ra.replicas):
        assert state_sig(a.engine.mn_state()) == \
            state_sig(b.engine.mn_state())
        if spec.kind == "outback-dir":
            assert (a.engine.directory, a.engine.local_depth) == \
                (b.engine.directory, b.engine.local_depth)
    if ta.placement is not None:
        assert ta.placement._members == ra.placement._members
    k = spec.replicas
    assert _sim_fields(simulate(t_tr.trace, clients=2, replicas=k)) == \
        _sim_fields(r_simulate(r_tr.trace, clients=2, replicas=k))
    assert not any(ops.LAUNCHES.values())
    # what each spec is there to drive
    want = {"k2_crash": ("failovers", "resyncs", "retries"),
            "k1_crash": ("retries", "backoffs"),
            "generated": ("drops", "resyncs", "fault_wait_us"),
            "partition": ("resyncs",),
            "cn_delay": ("fault_wait_us",),
            "cn_drop": ("drops", "retries"),
            "k2_cache": ("backoffs", "cache_hits", "resyncs"),
            "dir_twins": ("resyncs", "lease_renewals"),
            "dir_late": ("resyncs", "lease_renewals", "backoffs"),
            "dir_hrw": ("resyncs", "lease_renewals"),
            "dir_hrw_diverged": ("lease_renewals",)}[name]
    assert all(m[f] > 0 for f in want), {f: m[f] for f in want}
    if name == "k2_cache":
        assert t.stats.unavailable_lanes > 0
    if name.startswith("dir_"):
        assert max(len(a.engine.tables) for a in ta.replicas) > 2


def test_leases_survive_split_and_rebuild(data):
    """The lease guard reaches split successors and the tables a resync
    rebuilds from the donor's image (``OutbackStore.set_lease``)."""
    spec, shape = SPECS["dir_twins"]
    st = _open(spec, data[0], data[1])
    drive(st, fault_stream(data, shape), False)
    ta = replica_set(st)
    assert ta.replicas[0].engine.resize_events, "the stream split no table"
    for i, rep in enumerate(ta.replicas):
        guards = {id(t.lease) for t in rep.engine.tables}
        assert guards == {id(rep.engine._lease)}
        assert rep.engine._lease.mn == i


def test_replicas_only_spec_keeps_the_plain_path(data):
    """A replicas-only spec gets the dormant plane (leases off): its
    meters equal the reference's, and its writes reach both replicas."""
    build_k, build_v, w_k, w_v = data
    t = _open(StoreSpec("outback", load_factor=0.85, replicas=2),
              build_k, build_v)
    r = r_api.open_store(r_api.StoreSpec("outback", load_factor=0.85,
                                         replicas=2), build_k, build_v)
    for s in (t, r):
        s.insert_batch(w_k[:16], w_v[:16])
        s.get_batch(np.concatenate([build_k[:64], w_k[:16]]))
    assert t.meter_totals().snapshot() == r.meter_totals().snapshot()
    ta = replica_set(t)
    assert ta.plane.schedule.lease_term_ops == 0
    assert len({state_sig(x.engine.mn_state()) for x in ta.replicas}) == 1


def test_open_store_refuses_events_for_another_cn(data):
    for kind in ("cn_delay", "cn_drop", "partition"):
        ev = dict(kind=kind, at_op=1, duration_ops=2, cn=1, extra_us=1.0,
                  drop_rate=0.5, down_s=1e-4)
        spec = StoreSpec("outback", replicas=2, faults=dict(events=[ev]))
        with pytest.raises(SpecError, match="targets CN 1"):
            _open(spec, data[0], data[1])
        with pytest.raises(r_api.SpecError, match="targets CN 1"):
            r_api.open_store(r_api.StoreSpec.from_json(spec.to_json()),
                             data[0], data[1])


@pytest.mark.parametrize("kw", [
    dict(kind="outback", placement="hrw", replicas=2),
    dict(kind="outback-dir", placement="hrw", placement_k=3, replicas=2),
    dict(kind="outback-dir", placement="ring"),
    dict(kind="outback", placement_k=0),
    dict(kind="race", faults={"events": []}),
    dict(kind="sharded", replicas=2),
    dict(kind="outback", replicas=2,
         faults={"events": [dict(kind="mn_crash", at_op=1, duration_ops=2,
                                 mn=2, down_s=1e-4)]}),
    dict(kind="outback", faults={"events": [], "max_retries": -1}),
    dict(kind="outback", faults={"events": [], "bogus": 1}),
])
def test_spec_errors_match_the_reference(data, kw):
    with pytest.raises(r_api.SpecError) as e_r:
        r_api.StoreSpec(**kw).validate()
    with pytest.raises(SpecError) as e_t:
        StoreSpec(**kw).validate()
    assert str(e_t.value) == str(e_r.value)
    assert "not yet ported" not in str(e_t.value)


def test_replica_set_surface(data):
    st = _open(_crash_spec(), data[0], data[1])
    ta = replica_set(st)
    assert isinstance(ta, ReplicaSetAdapter)
    assert ta.kind == "outback" and ta.verifies_keys
    assert st.engine is ta.replicas[0].engine
    assert ta.cache_hit_savings == ta.replicas[0].cache_hit_savings
    st.get_batch(data[0][:8])
    ta.reset_meters()
    assert not any(st.meter_totals().snapshot().values())
