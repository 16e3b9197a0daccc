"""The partition-tolerant cluster plane of the port (partitions, fenced
lease arbitration, HRW placement and ``repro_torch.net.chaos``) against
``repro``.

The 22 tests (24 cases) of ``tests/test_chaos.py``, run against
``repro_torch`` on the CPU (``device="cpu"``): the fault events' and
schedules' checks (the port's exceptions and messages are the
reference's), HRW placement, the fenced full cut and its replay, the
chaos harness, the fault-kind counters of the telemetry plane and the
armed-but-empty plane's byte identity.  Every chaos report is compared
with the reference's by ``==`` on ``to_json_dict()`` (invariant counts,
meter totals, ``state_sig`` of the final MN image and the telemetry
export's hash); clusters are held against the reference's meters,
traces, ``ClusterStats``, handoffs and MN image.
"""

import dataclasses
import json
import types

import numpy as np
import pytest

from repro import api as r_api
from repro import cluster as r_cluster
from repro import net as r_net
from repro import obs as r_obs
from repro.net import chaos as r_chaos
from repro_torch import api as t_api
from repro_torch import cluster as t_cluster
from repro_torch import net as t_net
from repro_torch import obs as t_obs
from repro_torch.api import SpecError, StoreSpec, open_store
from repro_torch.api.replication import ReplicaPlacement
from repro_torch.net import FaultEvent, FaultSchedule
from repro_torch.net import chaos as t_chaos
from repro_torch.net.chaos import generate_chaos, run_chaos, state_signature
from repro_torch.obs import chrome_trace, telemetry_rows

_DEGRADED = ("backoff", "unavailable")

REF = types.SimpleNamespace(api=r_api, cluster=r_cluster, net=r_net,
                            obs=r_obs, chaos=r_chaos, kw={})
PORT = types.SimpleNamespace(api=t_api, cluster=t_cluster, net=t_net,
                             obs=t_obs, chaos=t_chaos, kw={"device": "cpu"})


def _data(n, seed=9):
    rng = np.random.default_rng(seed)
    keys = rng.choice(2 ** 40, size=n, replace=False).astype(np.uint64)
    vals = rng.integers(1, 2 ** 50, size=n, dtype=np.uint64)
    return keys, vals, rng


def _part(at, dur, cn=1, mn=-1, down_s=1e-3, P=PORT):
    return P.net.FaultEvent("partition", at, dur, mn=mn, cn=cn,
                            down_s=down_s)


def _trace(trace):
    return [(type(x).__name__, dataclasses.astuple(x)) for x in trace]


def _cluster_artifacts(P, cl):
    return {"meters": cl.meter_totals().snapshot(),
            "traces": [_trace(t.trace) for t in cl.transports],
            "stats": cl.stats.snapshot(),
            "handoffs": [h.to_json_dict() for h in cl.handoffs],
            "fence": list(cl.ownership.fence),
            "state": P.chaos.state_signature(cl.mn_state())}


def _same_error(make_port, make_ref, exc=ValueError):
    with pytest.raises(exc) as e_t:
        make_port()
    with pytest.raises(Exception) as e_r:
        make_ref()
    assert type(e_t.value).__name__ == type(e_r.value).__name__
    assert str(e_t.value) == str(e_r.value)


# ---------------------------------------------------------------- validation
class TestValidation:
    def test_partition_event_shape(self):
        _part(10, 5).validate()
        _part(10, 5, mn=2).validate()
        _same_error(lambda: FaultEvent("partition", 10, 5, mn=-1,
                                       cn=0).validate(),
                    lambda: r_net.FaultEvent("partition", 10, 5, mn=-1,
                                             cn=0).validate())
        _same_error(lambda: FaultEvent("mn_crash", 10, 5, mn=-1,
                                       down_s=1e-3).validate(),
                    lambda: r_net.FaultEvent("mn_crash", 10, 5, mn=-1,
                                             down_s=1e-3).validate())

    def test_cn_kinds_reject_mn_target(self):
        _same_error(lambda: FaultEvent("cn_delay", 10, 5, mn=1, cn=0,
                                       extra_us=2.0).validate(),
                    lambda: r_net.FaultEvent("cn_delay", 10, 5, mn=1, cn=0,
                                             extra_us=2.0).validate())
        FaultEvent("cn_delay", 10, 5, cn=1, extra_us=2.0).validate()
        _same_error(lambda: FaultEvent("cn_drop", 10, 5, cn=0,
                                       drop_rate=1.5).validate(),
                    lambda: r_net.FaultEvent("cn_drop", 10, 5, cn=0,
                                             drop_rate=1.5).validate())

    def test_overlapping_windows_rejected(self):
        for evs in (lambda P: (_part(10, 20, mn=1, P=P),
                               _part(25, 10, mn=1, P=P)),
                    lambda P: (_part(10, 20, mn=-1, P=P),
                               _part(25, 10, mn=2, P=P)),
                    lambda P: (P.net.FaultEvent("cn_drop", 10, 20, cn=1,
                                                drop_rate=0.1),
                               P.net.FaultEvent("cn_drop", 15, 20, cn=1,
                                                drop_rate=0.2))):
            with pytest.raises(ValueError, match="overlap"):
                FaultSchedule(events=evs(PORT)).validate()
            _same_error(
                lambda: FaultSchedule(events=evs(PORT)).validate(),
                lambda: r_net.FaultSchedule(events=evs(REF)).validate())

    def test_disjoint_or_cross_target_windows_pass(self):
        FaultSchedule(events=(_part(10, 10, mn=1),
                              _part(30, 10, mn=1))).validate()
        FaultSchedule(events=(_part(10, 20, cn=0, mn=1),
                              _part(15, 20, cn=1, mn=1))).validate()
        FaultSchedule(events=(
            _part(10, 20, mn=1),
            FaultEvent("cn_drop", 12, 20, cn=1,
                       drop_rate=0.1))).validate()

    def test_storespec_rejects_undeployed_mn(self):
        def make(P):
            return P.api.StoreSpec(kind="outback-dir", replicas=3,
                                   faults=P.net.FaultSchedule(
                                       events=(_part(10, 5, mn=5, P=P),)))
        _same_error(lambda: make(PORT).validate(),
                    lambda: make(REF).validate(), exc=SpecError)

    def test_open_store_rejects_foreign_cn_targets(self):
        keys, vals, _ = _data(256)

        def spec(P, cn):
            return P.api.StoreSpec(kind="outback-dir", replicas=2,
                                   faults=P.net.FaultSchedule(events=(
                                       P.net.FaultEvent("cn_drop", 10, 5,
                                                        cn=cn,
                                                        drop_rate=0.2),)))
        with pytest.raises(SpecError, match="single CN"):
            open_store(spec(PORT, 1), keys, vals, device="cpu")
        with pytest.raises(r_api.SpecError) as e_r:
            r_api.open_store(spec(REF, 1), keys, vals)
        with pytest.raises(SpecError) as e_t:
            open_store(spec(PORT, 1), keys, vals, device="cpu")
        # the reference names its own package as the multi-CN path
        assert str(e_t.value) == str(e_r.value).replace(
            "repro.cluster", "repro_torch.cluster")
        open_store(spec(PORT, 0), keys, vals, device="cpu")

    def test_clusterspec_rejects_undeployed_cn(self):
        def make(P, n):
            store = P.api.StoreSpec(
                kind="outback-dir", replicas=2,
                faults=P.net.FaultSchedule(events=(_part(10, 5, cn=3,
                                                         P=P),)))
            return P.cluster.ClusterSpec(store=store, n_cns=n)
        with pytest.raises(SpecError, match="CN 3"):
            make(PORT, 2).validate()
        _same_error(lambda: make(PORT, 2).validate(),
                    lambda: make(REF, 2).validate(), exc=SpecError)
        make(PORT, 4).validate()

    def test_placement_spec_validation(self):
        for kw in (dict(kind="outback-dir", placement="rr"),
                   dict(kind="outback", placement="hrw"),
                   dict(kind="outback-dir", replicas=2, placement="hrw",
                        placement_k=3)):
            _same_error(lambda: StoreSpec(**kw).validate(),
                        lambda: r_api.StoreSpec(**kw).validate(),
                        exc=SpecError)
        spec = StoreSpec(kind="outback-dir", replicas=3, placement="hrw",
                         placement_k=2)
        spec.validate()
        rt = StoreSpec.from_json_dict(spec.to_json_dict())
        assert rt.placement == "hrw" and rt.placement_k == 2
        assert spec.to_json() == r_api.StoreSpec(
            kind="outback-dir", replicas=3, placement="hrw",
            placement_k=2).to_json()


# ----------------------------------------------------------------- placement
class TestPlacement:
    def test_hrw_deterministic_k_subset(self):
        a = ReplicaPlacement(16, 4, 2, seed=3)
        b = ReplicaPlacement(16, 4, 2, seed=3)
        ref = r_api.replication.ReplicaPlacement(16, 4, 2, seed=3)
        for s in range(16):
            m = a.members(s)
            assert m == b.members(s) == ref.members(s)
            assert len(m) == 2 == len(set(m))
            assert all(0 <= r < 4 for r in m)
        assert [a.members(s) for s in range(16)] \
            != [ReplicaPlacement(16, 4, 2, seed=4).members(s)
                for s in range(16)]
        for r in range(4):
            for s in a.shards_on(r):
                assert r in a.members(s)

    def test_split_successor_inherits_members(self):
        p = ReplicaPlacement(4, 3, 2, seed=1)
        p.extend_for_split(2)
        assert len(p) == 5
        assert p.members(4) == p.members(2)

    def test_mn_crash_resyncs_only_placed_shards(self):
        def run(P):
            keys, vals, rng = _data(1500)
            sched = P.net.FaultSchedule.single_crash(300, 200, mn=1, seed=2,
                                                     lease_term_ops=0)
            spec = P.api.StoreSpec(kind="outback-dir", replicas=3,
                                   placement="hrw", placement_k=2,
                                   faults=sched, load_factor=0.5,
                                   rng_seed=5, params={"initial_depth": 3})
            adapter, plane = P.api.build_adapter(spec, keys, vals, **P.kw)
            placed = set(adapter.placement.shards_on(1))
            assert placed and placed < set(range(len(adapter.placement)))
            installed = []
            for s, t in enumerate(adapter.replicas[1].engine.tables):
                orig = t.install_mn_state

                def spy(state, _orig=orig, _s=s):
                    installed.append(_s)
                    return _orig(state)

                t.install_mn_state = spy
            wk = rng.choice(keys, size=1200).astype(np.uint64)
            wv = rng.integers(1, 2 ** 50, size=1200, dtype=np.uint64)
            for i in range(0, 1200, 8):
                adapter.update_batch(wk[i:i + 8], wv[i:i + 8])
            assert adapter.meter_totals().resyncs > 0
            assert installed, "crash window closed without a resync"
            assert set(installed) == placed
            res = adapter.get_batch(keys[:256])
            assert res.found.all()
            return (sorted(installed), adapter.meter_totals().snapshot(),
                    res.values.tolist(),
                    [P.chaos.state_signature(r.engine.mn_state())
                     for r in adapter.replicas])

        assert run(PORT) == run(REF)


# --------------------------------------------------------- cluster fencing
def _fence_cluster(n=1200, rounds=1600, lanes=8, telemetry=False, P=PORT):
    keys, vals, rng = _data(n, seed=7)
    sched = P.net.FaultSchedule(
        events=(_part(rounds // 4, rounds // 3, cn=1, down_s=2e-3, P=P),),
        seed=3, lease_term_ops=0)
    spec = P.api.StoreSpec(kind="outback-dir", replicas=3, placement="hrw",
                           placement_k=2, faults=sched, load_factor=0.5,
                           rng_seed=5,
                           telemetry=(P.obs.TelemetryConfig() if telemetry
                                      else None))
    cl = P.cluster.cluster_of(spec, keys, vals, n_cns=2, **P.kw)
    oracle = dict(zip(keys.tolist(), vals.tolist()))
    wk = rng.choice(keys, size=rounds).astype(np.uint64)
    wv = rng.integers(1, 2 ** 50, size=rounds, dtype=np.uint64)
    acked_while_cut = 0
    for i in range(0, rounds, lanes):
        cn = (i // lanes) % 2
        ks, vs = wk[i:i + lanes], wv[i:i + lanes]
        cut_before = not cl.cn_reachable(cn)
        res = cl.cns[cn].update_batch(ks, vs)
        cut = cut_before and not cl.cn_reachable(cn)
        sts = res.statuses or ("ok",) * len(ks)
        for k, v, st in zip(ks.tolist(), vs.tolist(), sts):
            if st not in _DEGRADED:
                oracle[k] = v
                if cut:
                    acked_while_cut += 1
    for c in cl.cns:
        c.flush()
    return cl, keys, oracle, acked_while_cut


class TestClusterFencing:
    def test_full_cut_fences_then_converges(self):
        cl, keys, oracle, acked_while_cut = _fence_cluster()
        st = cl.stats
        assert acked_while_cut == 0, "split-brain acked writes"
        assert st.partition_arbitrations == 1
        assert st.fenced_write_lanes > 0
        assert st.fenced_rpcs >= 1
        assert st.view_syncs == 1
        assert cl.ledgers[1].fenced_writes == st.fenced_write_lanes
        assert cl.meter_totals().fenced_writes == st.fenced_write_lanes
        reasons = [h.reason for h in cl.handoffs]
        assert "partition" in reasons and "heal" in reasons
        for c in range(2):
            for i in range(0, len(keys), 64):
                ks = keys[i:i + 64]
                res = cl.cns[c].get_batch(ks)
                assert res.found.all()
                assert all(v == oracle[k] for k, v in
                           zip(ks.tolist(), res.values.tolist()))
        r_cl, _, r_oracle, r_cut = _fence_cluster(P=REF)
        assert (oracle, acked_while_cut) == (r_oracle, r_cut)
        for c in range(2):  # the reference's cluster got the same sweep
            for i in range(0, len(keys), 64):
                r_cl.cns[c].get_batch(keys[i:i + 64])
        assert _cluster_artifacts(PORT, cl) == _cluster_artifacts(REF, r_cl)

    def test_single_link_cut_no_arbitration(self):
        def run(P):
            keys, vals, rng = _data(900)
            sched = P.net.FaultSchedule(
                events=(_part(200, 300, cn=1, mn=1, down_s=1e-3, P=P),),
                seed=3, lease_term_ops=0)
            spec = P.api.StoreSpec(kind="outback-dir", replicas=3,
                                   placement="hrw", placement_k=2,
                                   faults=sched, load_factor=0.5, rng_seed=5)
            cl = P.cluster.cluster_of(spec, keys, vals, n_cns=2, **P.kw)
            oracle = dict(zip(keys.tolist(), vals.tolist()))
            wk = rng.choice(keys, size=1200).astype(np.uint64)
            wv = rng.integers(1, 2 ** 50, size=1200, dtype=np.uint64)
            for i in range(0, 1200, 8):
                cn = (i // 8) % 2
                ks, vs = wk[i:i + 8], wv[i:i + 8]
                res = cl.cns[cn].update_batch(ks, vs)
                sts = res.statuses or ("ok",) * len(ks)
                for k, v, st in zip(ks.tolist(), vs.tolist(), sts):
                    if st not in _DEGRADED:
                        oracle[k] = v
            cl.cns[0].flush(), cl.cns[1].flush()
            assert cl.stats.partition_arbitrations == 0
            assert cl.stats.fenced_write_lanes == 0
            res = cl.cns[0].get_batch(keys)
            assert res.found.all()
            assert all(v == oracle[k]
                       for k, v in zip(keys.tolist(), res.values.tolist()))
            return _cluster_artifacts(P, cl)

        assert run(PORT) == run(REF)

    def test_replay_partition_per_link(self):
        cl, _keys, _oracle, _ = _fence_cluster(n=800, rounds=800)
        res = t_net.simulate_cluster([t.trace for t in cl.transports],
                                     replicas=3)
        parts = [w for w in res.fault_windows if w[2] == "partition"]
        fences = [w for w in res.fault_windows if w[2] == "fenced"]
        assert len(parts) == 1 and parts[0][3] == 1
        assert parts[0][1] - parts[0][0] == pytest.approx(2e-3)
        assert len(fences) == 1 and fences[0][0] == fences[0][1]
        res2 = t_net.simulate_cluster([t.trace for t in cl.transports],
                                      replicas=3)
        assert res.fault_windows == res2.fault_windows
        assert np.array_equal(res.latencies_us, res2.latencies_us)
        r_cl, _, _, _ = _fence_cluster(n=800, rounds=800, P=REF)
        r_res = r_net.simulate_cluster([t.trace for t in r_cl.transports],
                                       replicas=3)
        assert res.fault_windows == r_res.fault_windows
        assert res.latencies_us.tolist() == r_res.latencies_us.tolist()
        assert res.seconds == r_res.seconds

    def test_single_store_partition_stalls_replay(self):
        def run(P):
            keys, vals, rng = _data(600)
            sched = P.net.FaultSchedule(
                events=(_part(150, 200, cn=0, down_s=5e-3, P=P),),
                seed=1, lease_term_ops=0)
            spec = P.api.StoreSpec(kind="outback-dir", replicas=2,
                                   faults=sched, load_factor=0.5, rng_seed=5)
            tr = P.net.Transport()
            st = P.api.open_store(spec, keys, vals, transport=tr, **P.kw)
            for i in range(0, 800, 8):
                idx = rng.integers(0, len(keys), size=8)
                st.get_batch(keys[idx])
            st.flush()
            res = P.net.simulate(tr.trace, replicas=2)
            parts = [w for w in res.fault_windows if w[2] == "partition"]
            assert parts, "partition window missing from the replay"
            assert res.seconds >= 5e-3
            return (_trace(tr.trace), res.seconds, res.fault_windows,
                    res.latencies_us.tolist())

        assert run(PORT) == run(REF)


# -------------------------------------------------------------------- chaos
class TestChaos:
    def test_generated_schedules_are_valid_and_sequential(self):
        for seed in range(6):
            sched = generate_chaos(seed, 2000)
            sched.validate()
            evs = sorted(sched.events, key=lambda e: e.at_op)
            for a, b in zip(evs, evs[1:]):
                assert a.at_op + a.duration_ops <= b.at_op
            assert evs[0].kind == "partition" and evs[0].mn == -1
            assert sched.to_json() == r_chaos.generate_chaos(
                seed, 2000).to_json()

    @pytest.mark.parametrize("seed", (1, 2, 3))
    def test_invariants_hold(self, seed):
        rep = run_chaos(seed, n_ops=1400, n_keys=600, device="cpu")
        assert rep.passed, rep.failures
        assert rep.lost_acked_writes == 0
        assert rep.split_brain_acked_writes == 0
        assert rep.linearizability_violations == 0
        assert rep.partition_arbitrations >= 1
        assert rep.acked_writes > 0 and rep.heal_checks >= 1
        json.dumps(rep.to_json_dict())
        assert rep.to_json_dict() == r_chaos.run_chaos(
            seed, n_ops=1400, n_keys=600).to_json_dict()

    def test_same_seed_bit_identical(self):
        a = run_chaos(5, n_ops=1200, n_keys=500, telemetry=True,
                      device="cpu")
        b = run_chaos(5, n_ops=1200, n_keys=500, telemetry=True,
                      device="cpu")
        assert a.meters == b.meters
        assert a.state_sig == b.state_sig
        assert a.telemetry_sig == b.telemetry_sig
        rows_a = [r for h in a.cluster.hubs for r in telemetry_rows(h)]
        rows_b = [r for h in b.cluster.hubs for r in telemetry_rows(h)]
        assert json.dumps(rows_a, sort_keys=True) \
            == json.dumps(rows_b, sort_keys=True)
        da, db = a.to_json_dict(), b.to_json_dict()
        assert da == db
        r = r_chaos.run_chaos(5, n_ops=1200, n_keys=500, telemetry=True)
        rows_r = [x for h in r.cluster.hubs for x in r_obs.telemetry_rows(h)]
        assert json.dumps(rows_a, sort_keys=True) \
            == json.dumps(rows_r, sort_keys=True)
        assert da == r.to_json_dict()


# ------------------------------------------------------------- observability
class TestTelemetry:
    def test_fault_kind_counters_single_store(self):
        def run(P):
            keys, vals, rng = _data(600)
            sched = P.net.FaultSchedule(
                events=(P.net.FaultEvent("delay", 100, 80, extra_us=3.0),
                        P.net.FaultEvent("cn_drop", 260, 80, cn=0,
                                         drop_rate=0.2),
                        _part(420, 120, cn=0, mn=1, P=P)),
                seed=1, lease_term_ops=0)
            spec = P.api.StoreSpec(kind="outback-dir", replicas=2,
                                   faults=sched, load_factor=0.5,
                                   telemetry=P.obs.TelemetryConfig())
            st = P.api.open_store(spec, keys, vals, **P.kw)
            for _ in range(0, 700, 8):
                idx = rng.integers(0, len(keys), size=8)
                st.get_batch(keys[idx])
            st.flush()
            c = st.telemetry.counters
            assert c.get("faults{kind=delay}") == 1
            assert c.get("faults{kind=cn_drop}") == 1
            assert c.get("faults{kind=partition}") == 1
            return json.dumps(P.obs.telemetry_rows(st.telemetry),
                              sort_keys=True)

        assert run(PORT) == run(REF)

    def test_cluster_fence_counters_on_target_hub(self):
        cl, _keys, _oracle, _ = _fence_cluster(telemetry=True)
        merged = {}
        for h in cl.hubs:
            for k, v in h.counters.items():
                merged[k] = merged.get(k, 0) + v
        assert merged.get("faults{kind=partition}") == 1
        assert cl.hubs[1].counters.get("faults{kind=fenced}") == 1
        assert cl.hubs[1].counters.get("cluster.fenced_writes") \
            == cl.stats.fenced_write_lanes
        r_cl, _, _, _ = _fence_cluster(telemetry=True, P=REF)
        for h, r in zip(cl.hubs, r_cl.hubs):
            assert json.dumps(telemetry_rows(h), sort_keys=True) == \
                json.dumps(r_obs.telemetry_rows(r), sort_keys=True)

    def test_chrome_trace_fault_track_has_partition(self):
        def run(P, ct):
            keys, vals, rng = _data(500)
            sched = P.net.FaultSchedule(
                events=(_part(100, 150, cn=0, down_s=2e-3, P=P),),
                seed=1, lease_term_ops=0)
            spec = P.api.StoreSpec(kind="outback-dir", replicas=2,
                                   faults=sched, load_factor=0.5)
            tr = P.net.Transport()
            st = P.api.open_store(spec, keys, vals, transport=tr, **P.kw)
            for _ in range(0, 500, 8):
                idx = rng.integers(0, len(keys), size=8)
                st.get_batch(keys[idx])
            st.flush()
            return ct(tr.trace, replicas=2)

        doc = run(PORT, chrome_trace)
        slices = [e for e in doc["traceEvents"]
                  if e.get("pid") == 3 and e.get("name") == "partition"]
        assert slices and slices[0]["dur"] == pytest.approx(2e3)
        assert json.dumps(doc, sort_keys=True) == json.dumps(
            run(REF, r_obs.chrome_trace), sort_keys=True)


# ------------------------------------------------------------------ dormancy
class TestDormant:
    def test_armed_empty_plane_is_byte_identical(self):
        keys, vals, rng = _data(1200, seed=11)
        plain = StoreSpec(kind="outback-dir", load_factor=0.85, rng_seed=2)
        armed = StoreSpec(kind="outback-dir", load_factor=0.85, rng_seed=2,
                          placement="hrw", placement_k=1,
                          faults=FaultSchedule(lease_term_ops=0))
        a = t_cluster.cluster_of(plain, keys, vals, n_cns=2, device="cpu")
        b = t_cluster.cluster_of(armed, keys, vals, n_cns=2, device="cpu")
        wk = rng.choice(keys, size=1000).astype(np.uint64)
        wv = rng.integers(1, 2 ** 50, size=1000, dtype=np.uint64)
        for i in range(0, 1000, 16):
            cn = (i // 16) % 2
            for cl in (a, b):
                cl.cns[cn].update_batch(wk[i:i + 16], wv[i:i + 16])
                cl.cns[1 - cn].get_batch(wk[i:i + 16])
        for cl in (a, b):
            for c in cl.cns:
                c.flush()
        assert a.meter_totals().snapshot() == b.meter_totals().snapshot()
        for i in range(2):
            assert a.transports[i].trace == b.transports[i].trace
        assert state_signature(a.mn_state()) == state_signature(b.mn_state())
        assert b.stats.partition_arbitrations == 0
        assert b.stats.fenced_write_lanes == 0
        r = r_cluster.cluster_of(
            r_api.StoreSpec(kind="outback-dir", load_factor=0.85,
                            rng_seed=2), keys, vals, n_cns=2)
        for i in range(0, 1000, 16):
            cn = (i // 16) % 2
            r.cns[cn].update_batch(wk[i:i + 16], wv[i:i + 16])
            r.cns[1 - cn].get_batch(wk[i:i + 16])
        assert _cluster_artifacts(PORT, a) == _cluster_artifacts(REF, r)


# ------------------------------------------------------ the port's own rules
@pytest.mark.parametrize("seed", (1, 2, 3))
def test_default_chaos_report_matches_reference(seed):
    """``run_chaos(seed)`` at its defaults gives the reference's report."""
    assert run_chaos(seed, device="cpu").to_json_dict() == \
        r_chaos.run_chaos(seed).to_json_dict()


def test_state_signature_refuses_tensors_and_hashes_images():
    import torch
    keys, vals, _ = _data(400)
    st = open_store(StoreSpec(kind="outback-dir", load_factor=0.85), keys,
                    vals, device="cpu")
    ref = r_api.open_store(r_api.StoreSpec(kind="outback-dir",
                                           load_factor=0.85), keys, vals)
    assert state_signature(st.engine.mn_state()) == \
        r_chaos.state_signature(ref.engine.mn_state())
    with pytest.raises(TypeError, match="tensor"):
        state_signature({"a": torch.zeros(2)})
