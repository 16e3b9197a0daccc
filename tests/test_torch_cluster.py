"""The multi-CN plane of the port (``repro_torch.cluster``) against
``repro.cluster``.

The 15 tests of ``tests/test_cluster.py``, run against ``repro_torch`` on
the CPU (``device="cpu"``), each driving the same seeded scenario through
both packages: the N=1 cluster's byte identity with ``open_store``, two
CNs' coherence through a live §4.4 split, forwarding, join/leave/crash
handoffs, the ownership table and epochs, the specs' JSON and checks, the
write-combining reconciliation and ``simulate_cluster``.  Where both
packages build a cluster, its answers, ``meter_totals().snapshot()``,
every CN's trace (as ``dataclasses.astuple``), ``ClusterStats``, the
handoffs and ``state_signature(mn_state())`` must be equal; the replays'
``SimResult`` fields too.
"""

import dataclasses
import pickle
import types

import numpy as np
import pytest

from repro import api as r_api
from repro import cluster as r_cluster
from repro import net as r_net
from repro.net.chaos import state_signature as r_sig
from repro_torch import api as t_api
from repro_torch import cluster as t_cluster
from repro_torch import net as t_net
from repro_torch.api import SpecError
from repro_torch.cluster import (ClusterSpec, MembershipEvent,
                                 MembershipSchedule, OwnershipTable,
                                 ShardEpochs, cluster_of)
from repro_torch.net import FaultEvent
from repro_torch.net.chaos import state_signature as t_sig

N = 2048

REF = types.SimpleNamespace(api=r_api, cluster=r_cluster, net=r_net,
                            sig=r_sig, kw={})
PORT = types.SimpleNamespace(api=t_api, cluster=t_cluster, net=t_net,
                             sig=t_sig, kw={"device": "cpu"})


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(9)
    keys = np.unique(rng.integers(1, 1 << 62, 2 * N + 512, dtype=np.uint64))
    assert len(keys) >= 2 * N
    vals = np.arange(1, len(keys) + 1, dtype=np.uint64)
    return keys[:N], vals[:N], keys[N:2 * N], vals[N:2 * N]


def _spec(P=PORT, **kw):
    kw.setdefault("cache_budget_bytes", 32 << 10)
    return P.api.StoreSpec(kind="outback-dir", **kw)


def _cluster(P, spec, keys, vals, **kw):
    return P.cluster.cluster_of(spec, keys, vals, **kw, **P.kw)


def _state_sig(x):
    if isinstance(x, dict):
        return tuple(sorted((k, _state_sig(v)) for k, v in x.items()
                            if k != "cn"))
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return tuple(_state_sig(v) for v in x)
    return x


def _trace(trace):
    return [(type(x).__name__, dataclasses.astuple(x)) for x in trace]


def _artifacts(P, cl):
    """What a cluster run leaves behind, in a form both packages share."""
    return {"meters": cl.meter_totals().snapshot(),
            "traces": [_trace(t.trace) for t in cl.transports],
            "stats": cl.stats.snapshot(),
            "handoffs": [h.to_json_dict() for h in cl.handoffs],
            "owners": list(cl.ownership.owners),
            "fence": list(cl.ownership.fence),
            "epochs": (cl.epochs.epoch.tolist(), cl.epochs.seen.tolist(),
                       cl.epochs.bumps, cl.epochs.checks,
                       cl.epochs.stale_syncs),
            "live": sorted(cl.live),
            "clock": cl.clock,
            "state": P.sig(cl.mn_state())}


def _both(scenario, *args):
    """Run ``scenario(P, *args) -> (cluster, answers)`` in both packages
    and hold the port's artifacts and answers against the reference's."""
    t_cl, t_out = scenario(PORT, *args)
    r_cl, r_out = scenario(REF, *args)
    assert _artifacts(PORT, t_cl) == _artifacts(REF, r_cl)
    assert pickle.dumps(t_out) == pickle.dumps(r_out)
    return t_cl, t_out


def _answers(res):
    return ([int(v) for v in res.values], [bool(f) for f in res.found],
            None if res.statuses is None else list(res.statuses))


# ------------------------------------------------------- dormant contract

def test_single_cn_byte_identical_to_open_store(data):
    keys, vals, extra, evals = data

    def run(P):
        t_ref = P.net.Transport()
        ref = P.api.open_store(_spec(P), keys, vals, transport=t_ref,
                               **P.kw)
        cl = _cluster(P, _spec(P), keys, vals, n_cns=1)
        cn = cl.cns[0]
        out = []
        rng = np.random.default_rng(0)
        for step in range(6):
            idx = rng.integers(0, N, size=256)
            for st in (ref, cn):
                out.append(_answers(st.get_batch(keys[idx])))
            if step % 2:
                nv = rng.integers(1, 1 << 32, size=64).astype(np.uint64)
                for st in (ref, cn):
                    out.append(_answers(st.update_batch(keys[idx[:64]], nv)))
        for st in (ref, cn):
            out.append(_answers(st.insert_batch(extra[:128], evals[:128])))
            out.append(_answers(st.get(int(extra[0]))))
            out.append(_answers(st.delete(int(extra[1]))))
        assert ref.meter_totals().snapshot() == cl.meter_totals().snapshot()
        assert t_ref.trace == cl.transports[0].trace
        assert (pickle.dumps(_state_sig(ref.engine.mn_state()))
                == pickle.dumps(_state_sig(cl.mn_state())))
        assert P.sig(ref.engine.mn_state()) == P.sig(cl.mn_state())
        s = cl.stats.snapshot()
        assert s["forward_rpcs"] == 0 and s["handoffs"] == 0
        assert cl.epochs.stale_syncs == 0
        return cl, out

    _both(run)


# ---------------------------------------------------- coherence (property)

def _coherence_run(P, data, seed):
    keys, vals, extra, evals = data
    cl = _cluster(P, _spec(P, load_factor=0.85), keys, vals, n_cns=2)
    oracle = {int(k): int(v) for k, v in zip(keys, vals)}
    rng = np.random.default_rng(seed)
    n_start = len(cl.engine.tables)
    answers = []
    ins = 0
    for step in range(24):
        writer, reader = cl.cns[step % 2], cl.cns[(step + 1) % 2]
        idx = rng.integers(0, N, size=96)
        r = reader.get_batch(keys[idx])
        for k, v, f in zip(keys[idx], r.values, r.found):
            assert f and int(v) == oracle[int(k)]
        nv = rng.integers(1, 1 << 32, size=32).astype(np.uint64)
        w = writer.update_batch(keys[idx[:32]], nv)
        for k, v, ok in zip(keys[idx[:32]], nv, w.found):
            if ok:
                oracle[int(k)] = int(v)
        take = extra[ins:ins + 64]
        tv = evals[ins:ins + 64]
        ins += 64
        wi = writer.insert_batch(take, tv)
        for k, v, ok in zip(take, tv, wi.found):
            if ok:
                oracle[int(k)] = int(v)
        r2 = reader.get_batch(keys[idx])
        for k, v, f in zip(keys[idx], r2.values, r2.found):
            assert f, int(k)
            assert int(v) == oracle[int(k)], \
                f"stale read escaped the epoch check for key {int(k)}"
        answers.append(_answers(r2))
    assert len(cl.engine.tables) > n_start, \
        "the scenario must drive a live split"
    assert cl.epochs.bumps > 0 and cl.stats.epoch_invalidations > 0
    return cl, answers


def test_two_cn_coherence_through_live_split(data):
    cl1, a1 = _both(_coherence_run, data, 42)
    cl2, a2 = _coherence_run(PORT, data, 42)
    assert a1 == a2
    assert _artifacts(PORT, cl1) == _artifacts(PORT, cl2)


def test_non_owner_write_forwards_and_owner_read_does_not(data):
    keys, vals, _, _ = data

    def run(P):
        for seed in range(16):  # a seed where both CNs own shards
            cl = _cluster(P, _spec(P, params={"initial_depth": 3}), keys,
                          vals, n_cns=2,
                          membership=P.cluster.MembershipSchedule(seed=seed))
            if len(set(cl.ownership.owners)) == 2:
                break
        shards = cl.shards_of(keys)
        owners = cl.ownership.owners_for(shards)
        mine = keys[owners == 0][:64]
        theirs = keys[owners == 1][:64]
        assert len(mine) and len(theirs), "both CNs must own something"
        before = cl.stats.forward_rpcs
        out = [_answers(cl.cns[0].get_batch(mine))]
        assert cl.stats.forward_rpcs == before
        out.append(_answers(cl.cns[0].update_batch(
            theirs, np.arange(1, len(theirs) + 1, dtype=np.uint64))))
        assert cl.stats.forward_rpcs == before + 1
        assert cl.stats.forwarded_write_lanes >= len(theirs)
        return cl, (out, shards.tolist())

    _both(run)


# ----------------------------------------------------------------- handoff

def test_join_handoff_moves_only_affected_shard_bytes(data):
    keys, vals, _, _ = data

    def run(P):
        sched = P.cluster.MembershipSchedule.single_join(
            at_op=512, cn=3, initial=(0, 1, 2), seed=7)
        cl = _cluster(P, _spec(P, params={"initial_depth": 3}), keys, vals,
                      n_cns=4, membership=sched)
        led3_before = cl.ledgers[3].snapshot()["resp_bytes"]
        out = []
        for i in range(8):
            out.append(_answers(cl.cns[i % 3].get_batch(
                keys[i * 128:(i + 1) * 128])))
        assert 3 in cl.live
        h = [e for e in cl.handoffs if e.reason == "join"]
        assert len(h) == 1 and h[0].cn == 3 and len(h[0].moved) > 0
        expect = sum(cl.cn_half_bytes(s) for s, _o, _n in h[0].moved)
        assert h[0].bytes_moved == expect
        led3 = cl.ledgers[3].snapshot()
        assert led3["resp_bytes"] - led3_before >= expect
        assert led3["fault_wait_us"] > 0
        for _s, old, new in h[0].moved:
            assert new in cl.live and new != old
        r = cl.cns[3].get_batch(keys[:256])
        assert r.found.all()
        out.append(_answers(r))
        return cl, out

    _both(run)


def test_leave_loses_no_acked_writes(data):
    keys, vals, extra, evals = data

    def run(P):
        sched = P.cluster.MembershipSchedule.single_leave(at_op=500, cn=1,
                                                          seed=3)
        cl = _cluster(P, _spec(P), keys, vals, n_cns=2, membership=sched)
        acked = []
        w = cl.cns[1].update_batch(keys[:256],
                                   np.arange(1, 257, dtype=np.uint64))
        acked += [(int(k), int(v)) for k, v, ok in
                  zip(keys[:256], np.arange(1, 257), w.found) if ok]
        wi = cl.cns[1].insert_batch(extra[:128], evals[:128])
        acked += [(int(k), int(v)) for k, v, ok in
                  zip(extra[:128], evals[:128], wi.found) if ok]
        for i in range(4):
            cl.cns[0].get_batch(keys[256 + i * 64:256 + (i + 1) * 64])
        assert 1 not in cl.live
        assert any(e.reason == "leave" for e in cl.handoffs)
        r_dead = cl.cns[1].get_batch(keys[:8])
        assert not r_dead.found.any()
        assert set(r_dead.statuses) == {"unavailable"}
        ak = np.asarray([k for k, _ in acked], dtype=np.uint64)
        av = np.asarray([v for _, v in acked], dtype=np.uint64)
        r = cl.cns[0].get_batch(ak)
        lost = int((~(r.found & (r.values == av))).sum())
        assert lost == 0, f"{lost} acked writes lost through the leave"
        return cl, (acked, _answers(r))

    _both(run)


def test_cn_crash_degrades_then_rejoins(data):
    keys, vals, _, _ = data

    def run(P):
        sched = P.cluster.MembershipSchedule(events=(
            P.cluster.MembershipEvent("cn_crash", at_op=256, cn=1,
                                      duration_ops=512, down_s=2e-4),),
            seed=1)
        cl = _cluster(P, _spec(P), keys, vals, n_cns=2, membership=sched)
        cl.cns[0].get_batch(keys[:256])
        assert 1 not in cl.live
        r = cl.cns[1].get_batch(keys[:32])
        assert not r.found.any() and set(r.statuses) == {"unavailable"}
        assert cl.stats.rejected_lanes >= 32
        marks = [m for m in cl.transports[1].trace
                 if type(m).__name__ == "FaultMark" and m.kind == "cn_crash"]
        assert len(marks) == 1 and marks[0].down_s == pytest.approx(2e-4)
        cl.cns[0].get_batch(keys[:512])
        r2 = cl.cns[1].get_batch(keys[:32])
        assert 1 in cl.live and r2.found.all()
        reasons = [e.reason for e in cl.handoffs]
        assert "cn_crash" in reasons and "cn_restart" in reasons
        return cl, (_answers(r), _answers(r2))

    _both(run)


def test_ownership_rebalance_is_minimal_and_deterministic():
    t1 = OwnershipTable(64, live=(0, 1, 2), seed=11)
    t2 = OwnershipTable(64, live=(0, 1, 2), seed=11)
    ref = r_cluster.OwnershipTable(64, live=(0, 1, 2), seed=11)
    assert t1.owners == t2.owners == ref.owners
    before = list(t1.owners)
    moved = t1.rebalance((0, 1, 2, 3))
    assert moved == ref.rebalance((0, 1, 2, 3))
    assert all(new == 3 for _s, _o, new in moved)
    for s in range(64):
        if before[s] != t1.owners[s]:
            assert t1.owners[s] == 3
    t1.rebalance((0, 1, 2))
    assert t1.owners == before
    assert t1.snapshot() != ref.snapshot()  # the reference stayed at 4 CNs
    ref.rebalance((0, 1, 2))
    assert t1.snapshot() == ref.snapshot()


def test_shard_epochs_semantics():
    for cls in (ShardEpochs, r_cluster.ShardEpochs):
        ep = cls(4, n_cns=2)
        ep.bump(0, np.asarray([1, 2]))
        assert list(ep.stale_shards(1, np.asarray([0, 1, 2, 3]))) == [1, 2]
        assert ep.stale_shards(0, np.asarray([1, 2])).size == 0
        ep.sync(1, np.asarray([1, 2]))
        assert ep.stale_shards(1, np.asarray([1, 2])).size == 0
        ep.grow(6)
        assert ep.n_shards == 6
        assert ep.stale_shards(1, np.asarray([4, 5])).size == 0
        assert (ep.bumps, ep.checks, ep.stale_syncs) == (2, 4, 2)


# ------------------------------------------------------------ specs / JSON

def test_membership_schedule_json_roundtrip():
    sched = MembershipSchedule(
        events=(MembershipEvent("join", 100, 2),
                MembershipEvent("cn_crash", 200, 0, duration_ops=50,
                                down_s=1e-4),
                MembershipEvent("leave", 400, 1)),
        seed=9, initial=(0, 1))
    back = MembershipSchedule.from_json(sched.to_json())
    assert back == sched
    gen = MembershipSchedule.generate(5, 4096, n_cns=4)
    assert MembershipSchedule.from_json(gen.to_json()) == gen
    # the same JSON as the reference's, both ways
    assert gen.to_json() == r_cluster.MembershipSchedule.generate(
        5, 4096, n_cns=4).to_json()
    assert r_cluster.MembershipSchedule.from_json(
        sched.to_json()).to_json() == sched.to_json()


def test_cluster_spec_validation_and_roundtrip():
    spec = ClusterSpec(store=_spec(), n_cns=4, n_mns=2,
                       membership=MembershipSchedule.single_join(64, 3))
    spec.validate()
    assert ClusterSpec.from_json(spec.to_json()) == spec
    assert r_cluster.ClusterSpec.from_json(spec.to_json()).to_json() == \
        spec.to_json()
    bad = [dict(store=dict(kind="outback"), n_cns=2),
           dict(store=_spec().to_json_dict(), n_cns=0),
           dict(store=_spec().to_json_dict(), n_cns=2,
                membership=MembershipSchedule.single_join(10, 5)
                .to_json_dict()),
           dict(store=dict(kind="outback-dir", replicas=2), n_mns=2)]
    for kw in bad:
        with pytest.raises(SpecError) as e:
            ClusterSpec(**kw).validate()
        with pytest.raises(r_api.SpecError) as e_r:
            r_cluster.ClusterSpec(**kw).validate()
        assert str(e.value) == str(e_r.value)


def test_fault_schedule_cn_crash_validation(data):
    keys, vals, _, _ = data
    with pytest.raises(ValueError):
        FaultEvent("cn_crash", 10, 20, mn=1, cn=0, down_s=1e-4).validate()
    with pytest.raises(ValueError):
        FaultEvent("cn_crash", 10, 20, cn=0).validate()

    def run(P):
        sched = P.net.FaultSchedule(events=(
            P.net.FaultEvent("cn_crash", 64, 128, cn=1, down_s=1e-4),),
            lease_term_ops=32)
        P.api.StoreSpec(kind="outback-dir", faults=sched).validate()
        lifted = P.cluster.MembershipSchedule.from_faults(sched)
        assert lifted.events[0].kind == "cn_crash"
        assert lifted.events[0].duration_ops == 128
        cl = _cluster(P, P.api.StoreSpec(kind="outback-dir", faults=sched,
                                         cache_budget_bytes=16 << 10),
                      keys, vals, n_cns=2)
        out = _answers(cl.cns[0].get_batch(keys[:128]))
        assert 1 not in cl.live
        return cl, (out, lifted.to_json())

    _both(run)


# --------------------------------------- write-combining reconciliation

def _wc_run(P, data, combine):
    keys, vals, extra, _ = data
    spec = _spec(P, batch=P.api.BatchPolicy(window=512,
                                            combine_reads=combine))
    st = P.api.open_store(spec, keys, vals, **P.kw)
    answers = []
    st.submit("update", extra[:16], np.arange(1, 17, dtype=np.uint64))
    h1 = st.submit("get", extra[:16])
    st.submit("update", keys[:16], np.arange(101, 117, dtype=np.uint64))
    h2 = st.submit("get", keys[:16])
    st.submit("delete", extra[16:20])
    h3 = st.submit("get", extra[16:20])
    st.flush()
    for h in (h1, h2, h3):
        r = h.result()
        answers.append(([int(v) for v in r.values],
                        [bool(f) for f in r.found]))
    return answers, st.stats, st.meter_totals().snapshot()


def test_combined_reads_reconcile_to_uncombined_answers(data):
    a_on, s_on, m_on = _wc_run(PORT, data, combine=True)
    a_off, s_off, _ = _wc_run(PORT, data, combine=False)
    assert a_on == a_off
    assert s_on.combined_reads > 0 and s_on.reconciled_reads > 0
    assert s_off.combined_reads == 0 and s_off.reconciled_reads == 0
    assert s_on.hazard_flushes < s_off.hazard_flushes
    r_on, rs_on, rm_on = _wc_run(REF, data, combine=True)
    assert (a_on, dataclasses.asdict(s_on), m_on) == \
        (r_on, dataclasses.asdict(rs_on), rm_on)


# ----------------------------------------------------------------- replay

def _sim_fields(res):
    return (res.n_ops, res.seconds, res.latencies_us.tolist(),
            list(res.fault_windows), res.percentiles())


def test_simulate_cluster_single_cn_matches_simulate(data):
    keys, vals, _, _ = data

    def run(P):
        cl = _cluster(P, _spec(P), keys, vals, n_cns=1)
        cl.cns[0].get_batch(keys[:512])
        cl.cns[0].update_batch(keys[:64], np.arange(1, 65, dtype=np.uint64))
        trace = cl.transports[0].trace
        r1 = P.net.simulate(trace, clients=4, window=8)
        r2 = P.net.simulate_cluster([trace], clients_per_cn=4, window=8)
        assert r1.n_ops == r2.n_ops
        assert r1.seconds == pytest.approx(r2.seconds, rel=0, abs=0)
        assert np.array_equal(r1.latencies_us, r2.latencies_us)
        return cl, _sim_fields(r2)

    _both(run)


def test_simulate_cluster_is_deterministic_and_scales(data):
    keys, vals, _, _ = data

    def run(P):
        cl = _cluster(P, _spec(P, params={"initial_depth": 2}), keys, vals,
                      n_cns=4, n_mns=2)
        rng = np.random.default_rng(2)
        for step in range(12):
            idx = rng.integers(0, N, size=256)
            cl.cns[step % 4].get_batch(keys[idx])
        traces = [t.trace for t in cl.transports]
        r1 = P.net.simulate_cluster(traces, clients_per_cn=2, window=8,
                                    replicas=2)
        r2 = P.net.simulate_cluster(traces, clients_per_cn=2, window=8,
                                    replicas=2)
        assert r1.n_ops == r2.n_ops and r1.seconds == r2.seconds
        assert np.array_equal(r1.latencies_us, r2.latencies_us)
        merged = [it for t in traces for it in t]
        solo = P.net.simulate(merged, clients=2, window=8, replicas=2)
        assert r1.seconds < solo.seconds
        return cl, (_sim_fields(r1), _sim_fields(solo))

    _both(run)


def test_cluster_cn_crash_mark_records_availability_window(data):
    keys, vals, _, _ = data

    def run(P):
        sched = P.cluster.MembershipSchedule(events=(
            P.cluster.MembershipEvent("cn_crash", 128, 1, duration_ops=256,
                                      down_s=3e-4),), seed=0)
        cl = _cluster(P, _spec(P), keys, vals, n_cns=2, membership=sched)
        for i in range(6):
            cl.cns[i % 2].get_batch(keys[i * 64:(i + 1) * 64])
        res = P.net.simulate_cluster([t.trace for t in cl.transports],
                                     clients_per_cn=2, window=4)
        kinds = {k for _a, _b, k, _r in res.fault_windows}
        assert "cn_crash" in kinds
        cn_win = [w for w in res.fault_windows if w[2] == "cn_crash"]
        assert cn_win[0][1] - cn_win[0][0] == pytest.approx(3e-4)
        avail = res.availability()
        assert avail["schema"] == "outback-availability/v1"
        assert any(w[2] == "cn_crash" for w in avail["fault_windows"])
        return cl, (_sim_fields(res), avail)

    _both(run)


# ------------------------------------------------------ port-only surface

def test_cluster_entry_points_take_the_device_and_a_transport_facade(data):
    """``cluster_of`` builds the pool and every CN cache on ``device``;
    the switching transport covers every member the stack calls."""
    keys, vals, _, _ = data
    cl = cluster_of(_spec(), keys, vals, n_cns=2, device="cpu")
    assert cl.device.type == "cpu"
    assert all(c.device.type == "cpu" for c in cl.caches)
    sw = cl.switch
    for name in ("on_meter_add", "mark_resize", "mark_fault", "add_wait",
                 "begin_doorbell", "close_doorbell", "reset"):
        assert callable(getattr(sw, name))
    sw.current = 1
    sw.current_mn = 2
    sw.current_cn_dst = 0
    assert (cl.transports[1].current_mn, cl.transports[1].current_cn_dst) \
        == (2, 0)
    assert (sw.current_mn, sw.current_cn_dst) == (2, 0)
    sw.current_mn, sw.current_cn_dst, sw.current = 0, -1, 0
    # a router forwards the replica set's surface by name
    assert cl.routers[0].meter is cl.ledgers[0]
    assert cl.cns[0].telemetry is None
    spec = _spec(telemetry=t_api.TelemetryConfig())
    cl = cluster_of(spec, keys, vals, n_cns=2, device="cpu")
    assert cl.cns[1].telemetry is cl.hubs[1]
