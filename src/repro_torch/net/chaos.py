"""``repro_torch.net.chaos`` — seeded chaos schedules + invariant harness.

The port of ``repro.net.chaos``: host Python over a
:class:`repro_torch.cluster.Cluster` whose MN pool lives on the device.
Given a seed, :func:`run_chaos` gives the reference's
:class:`ChaosReport`, field for field, on the card and on the CPU.

Composes the whole partition-tolerant plane under one deterministic
stress loop: :func:`generate_chaos` derives a randomized-but-seeded
script of ``partition`` / ``mn_crash`` / ``cn_crash`` / ``delay`` /
``drop`` / ``cn_delay`` / ``cn_drop`` windows (sequential, with heal
gaps — the overlap rules in :meth:`FaultSchedule.validate` hold by
construction), and :func:`run_chaos` drives a mixed read/update/delete/
re-insert workload round-robin over a live multi-CN
:class:`repro_torch.cluster.Cluster` while checking the safety invariants a
disaggregated KVS must keep through every window:

* **zero lost acked writes** — every write the store acknowledged is
  visible in the post-heal converged state (host-oracle comparison);
* **zero split-brain acked writes** — a CN whose every MN link is cut
  never gets a write acknowledged (its calls degrade to BACKOFF, and
  its first post-heal write on a re-arbitrated shard is *fenced*);
* **per-key linearizability** — every acknowledged read returns exactly
  the host oracle's current value (single-threaded drive loop, so the
  oracle is the linearization);
* **availability floor** — degraded answers (BACKOFF/UNAVAILABLE) stay
  a bounded fraction of all lanes: the cluster serves around every
  fault, it never stalls on one.

Everything is a pure function of the seed: two runs of the same seed
produce bit-identical meter totals, final MN state signatures, and
telemetry exports.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import torch

from repro_torch.net.faults import FaultEvent, FaultSchedule, _mix64, _unit

_DEGRADED = ("backoff", "unavailable")


def generate_chaos(seed: int, n_ops: int, *, n_cns: int = 2,
                   replicas: int = 3, n_windows: int = 5,
                   **knobs) -> FaultSchedule:
    """Derive a sequential fault script from ``seed`` alone.

    The op-clock span ``[0, n_ops)`` is cut into ``n_windows + 1``
    equal slots; each slot opens one seeded window in its first half
    and heals for the rest, so windows never overlap (schedule
    validation holds by construction), every window is followed by a
    quiet period the harness can verify invariants in, and a fully-cut
    CN always heals before the next window opens.  Partitions are
    drawn twice as often as the other kinds — they are what this plane
    exists to survive.  ``knobs`` forward to :class:`FaultSchedule`
    (timeouts, retry curve, lease term).
    """
    if n_windows < 1:
        return FaultSchedule(seed=seed, **knobs)
    slot = max(int(n_ops) // (n_windows + 1), 32)
    kinds = ("partition", "partition", "mn_crash", "cn_crash",
             "delay", "drop", "cn_delay", "cn_drop")
    events = []
    for w in range(n_windows):
        at = slot // 2 + w * slot
        dur = slot // 4 + _mix64(seed, w, 2) % max(slot // 4, 1)
        # window 0 is always a full-cut partition: every script must
        # exercise lease arbitration + fencing, whatever the seed draws
        kind = ("partition" if w == 0
                else kinds[_mix64(seed, w, 1) % len(kinds)])
        cn = _mix64(seed, w, 3) % max(n_cns, 1)
        mn = _mix64(seed, w, 4) % max(replicas, 1)
        if kind == "partition":
            # half the draws cut every link (full isolation -> lease
            # arbitration + fencing), half cut a single link
            link = (-1 if w == 0 or _mix64(seed, w, 5) % 2 == 0
                    else mn)
            events.append(FaultEvent("partition", at, dur, mn=link, cn=cn,
                                     down_s=0.5e-3 + 1e-3 * _unit(seed, w, 6)))
        elif kind == "mn_crash":
            events.append(FaultEvent("mn_crash", at, dur, mn=mn,
                                     down_s=150e-6 + 100e-6 * _unit(seed, w, 6)))
        elif kind == "cn_crash":
            events.append(FaultEvent("cn_crash", at, dur, cn=cn,
                                     down_s=150e-6 + 100e-6 * _unit(seed, w, 6)))
        elif kind == "delay":
            events.append(FaultEvent("delay", at, dur,
                                     extra_us=2.0 + 6.0 * _unit(seed, w, 6)))
        elif kind == "drop":
            events.append(FaultEvent("drop", at, dur,
                                     drop_rate=0.05 + 0.2 * _unit(seed, w, 6)))
        elif kind == "cn_delay":
            events.append(FaultEvent("cn_delay", at, dur, cn=cn,
                                     extra_us=2.0 + 6.0 * _unit(seed, w, 6)))
        else:  # cn_drop
            events.append(FaultEvent("cn_drop", at, dur, cn=cn,
                                     drop_rate=0.05 + 0.2 * _unit(seed, w, 6)))
    sched = FaultSchedule(events=tuple(events), seed=seed, **knobs)
    sched.validate()
    return sched


def state_signature(obj) -> str:
    """Deterministic sha256 over a (possibly nested) state image —
    dicts, sequences, numpy arrays, scalars, and plain objects (hashed
    via their ``__dict__``).  Used to compare final MN states across
    runs without materialising both in memory.  A tensor has no stable
    ``__dict__`` to hash, so one inside ``obj`` raises: ``mn_state()``
    images are host numpy."""
    h = hashlib.sha256()

    def feed(x) -> None:
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                h.update(str(k).encode())
                feed(x[k])
        elif isinstance(x, (list, tuple)):
            h.update(b"[")
            for v in x:
                feed(v)
            h.update(b"]")
        elif isinstance(x, np.ndarray):
            h.update(str(x.dtype).encode())
            h.update(str(x.shape).encode())
            h.update(np.ascontiguousarray(x).tobytes())
        elif isinstance(x, (bool, int, float, str, bytes,
                            np.integer, np.floating)):
            h.update(repr(x).encode())
        elif x is None:
            h.update(b"~")
        elif isinstance(x, torch.Tensor):
            raise TypeError("state_signature needs a host image (numpy "
                            "arrays and Python scalars), got a tensor")
        else:
            h.update(type(x).__name__.encode())
            feed(vars(x))

    feed(obj)
    return h.hexdigest()


@dataclasses.dataclass
class ChaosReport:
    """One chaos run's invariant verdicts + determinism signatures.

    ``to_json_dict`` is the ``outback-chaos/v1`` schema; the live
    :class:`Cluster` is attached as ``report.cluster`` (not serialised) for
    further inspection.
    """

    seed: int
    n_cns: int
    replicas: int
    placement_k: int
    n_windows: int
    kinds: dict
    lanes: int
    acked_writes: int
    degraded_lanes: int
    availability: float
    heal_checks: int
    lost_acked_writes: int
    split_brain_acked_writes: int
    linearizability_violations: int
    fenced_write_lanes: int
    partition_arbitrations: int
    view_syncs: int
    meters: dict
    state_sig: str
    telemetry_sig: str | None
    failures: list
    passed: bool

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["schema"] = "outback-chaos/v1"
        return d


def run_chaos(seed: int, *, n_cns: int = 2, replicas: int = 3,
              placement_k: int = 2, n_keys: int = 1200, n_ops: int = 3000,
              n_windows: int = 5, batch: int = 8,
              availability_floor: float = 0.5,
              telemetry: bool = False,
              schedule: FaultSchedule | None = None,
              device=None) -> ChaosReport:
    """Drive one seeded chaos run and check every invariant.

    Builds an ``n_cns``-CN cluster over a ``replicas``-wide MN pool with
    per-shard HRW placement (``placement_k`` copies per shard), injects
    :func:`generate_chaos`'s script (or ``schedule``), and round-robins
    a seeded read/update/delete/re-insert workload over every CN —
    including dead or partitioned ones, whose degraded answers are the
    availability cost being measured.  A host-side oracle dict applies
    exactly the acknowledged mutations; acknowledged reads are checked
    against it online, a sample read-back runs after every window heals,
    and a final full sweep on every CN asserts bit-exact convergence.  The
    cluster's MN pool and CN caches live on ``device`` (CUDA unless the
    caller passes ``device="cpu"``).
    """
    sched = schedule if schedule is not None else generate_chaos(
        seed, n_ops, n_cns=n_cns, replicas=replicas, n_windows=n_windows)
    tele = None
    if telemetry:
        from repro_torch.obs import TelemetryConfig
        tele = TelemetryConfig()
    from repro_torch.api.registry import StoreSpec
    from repro_torch.cluster import cluster_of
    spec = StoreSpec(kind="outback-dir", replicas=replicas,
                     placement="hrw", placement_k=placement_k,
                     faults=sched, load_factor=0.5, rng_seed=seed,
                     telemetry=tele)

    rng = np.random.default_rng(_mix64(seed, 0xC4A05) & 0xFFFFFFFF)
    keys = rng.choice(2 ** 40, size=n_keys, replace=False).astype(np.uint64)
    vals = rng.integers(1, 2 ** 50, size=n_keys, dtype=np.uint64)
    cl = cluster_of(spec, keys, vals, n_cns=n_cns, device=device)
    oracle = dict(zip(keys.tolist(), vals.tolist()))
    deleted: list[int] = []

    lanes = acked_writes = degraded = 0
    lin_violations = split_brain = 0
    heal_checks = 0
    ends = sorted(ev.at_op + ev.duration_ops for ev in sched.events)
    next_heal = 0

    def acked(st: str) -> bool:
        return st not in _DEGRADED and st != "frozen"

    def check_reads(ks, res) -> None:
        nonlocal lin_violations
        sts = res.statuses or ("ok",) * len(ks)
        for k, v, f, st in zip(ks.tolist(), res.values.tolist(),
                               res.found.tolist(), sts):
            if st in _DEGRADED:
                continue
            want = oracle.get(k)
            if (want is None) != (not f) or (want is not None and v != want):
                lin_violations += 1

    def sample(pool, k):
        pool = sorted(pool)
        if len(pool) <= k:
            return np.asarray(pool, dtype=np.uint64)
        idx = rng.choice(len(pool), size=k, replace=False)
        return np.asarray([pool[i] for i in idx], dtype=np.uint64)

    step = 0
    last_end = ends[-1] if ends else 0
    while cl.clock < last_end + 4 * batch or step * batch < n_ops:
        if step * batch > 4 * max(n_ops, last_end):
            break  # hard cap; availability accounting surfaces the stall
        cn = step % n_cns
        store = cl.cns[cn]
        r = rng.random()
        cut_before = not cl.cn_reachable(cn)
        if r < 0.5:  # read
            ks = sample(oracle, batch) if oracle else sample(deleted, batch)
            res = store.get_batch(ks)
            check_reads(ks, res)
            sts = res.statuses or ("ok",) * len(ks)
            degraded += sum(1 for st in sts if st in _DEGRADED)
            lanes += len(ks)
        elif r < 0.85 and oracle:  # update
            ks = sample(oracle, batch)
            vs = rng.integers(1, 2 ** 50, size=len(ks), dtype=np.uint64)
            res = store.update_batch(ks, vs)
            sts = res.statuses or ("ok",) * len(ks)
            cut = cut_before and not cl.cn_reachable(cn)
            for k, v, st in zip(ks.tolist(), vs.tolist(), sts):
                if acked(st):
                    oracle[k] = v
                    acked_writes += 1
                    if cut:
                        split_brain += 1
                else:
                    degraded += st in _DEGRADED
            lanes += len(ks)
        elif r < 0.925 and len(oracle) > batch:  # delete
            ks = sample(oracle, max(batch // 2, 1))
            res = store.delete_batch(ks)
            sts = res.statuses or ("ok",) * len(ks)
            cut = cut_before and not cl.cn_reachable(cn)
            for k, f, st in zip(ks.tolist(), res.found.tolist(), sts):
                if acked(st) and f:
                    del oracle[k]
                    deleted.append(k)
                    acked_writes += 1
                    if cut:
                        split_brain += 1
                else:
                    degraded += st in _DEGRADED
            lanes += len(ks)
        elif deleted:  # re-insert a previously deleted key
            ks = sample(deleted, max(batch // 2, 1))
            vs = rng.integers(1, 2 ** 50, size=len(ks), dtype=np.uint64)
            res = store.insert_batch(ks, vs)
            sts = res.statuses or ("ok",) * len(ks)
            cut = cut_before and not cl.cn_reachable(cn)
            for k, v, st in zip(ks.tolist(), vs.tolist(), sts):
                if acked(st):
                    oracle[k] = v
                    deleted.remove(k)
                    acked_writes += 1
                    if cut:
                        split_brain += 1
                else:
                    degraded += st in _DEGRADED
            lanes += len(ks)
        step += 1
        # post-heal read-back: a sample from every CN once the clock is
        # safely past a window's close
        while next_heal < len(ends) and cl.clock > ends[next_heal] + 8 * batch:
            next_heal += 1
            heal_checks += 1
            if oracle:
                ks = sample(oracle, 32)
                for c in range(n_cns):
                    res = cl.cns[c].get_batch(ks)
                    check_reads(ks, res)
                    lanes += len(ks)

    for c in cl.cns:
        c.flush()

    # final convergence sweep: every key (live and deleted), every CN,
    # against the oracle — an acked-but-lost write or a split-brain
    # survivor shows up here as a mismatch
    lost = 0
    all_keys = np.asarray(sorted(set(oracle) | set(deleted)), dtype=np.uint64)
    for c in range(n_cns):
        for i in range(0, len(all_keys), 64):
            ks = all_keys[i:i + 64]
            res = cl.cns[c].get_batch(ks)
            sts = res.statuses or ("ok",) * len(ks)
            for k, v, f, st in zip(ks.tolist(), res.values.tolist(),
                                   res.found.tolist(), sts):
                if st in _DEGRADED:
                    lost += 1  # post-heal reads must all serve
                    continue
                want = oracle.get(k)
                if (want is None) != (not f) \
                        or (want is not None and v != want):
                    lost += 1

    kinds: dict[str, int] = {}
    for ev in sched.events:
        kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
    stats = cl.stats
    availability = 1.0 - (degraded / max(lanes, 1))
    failures = []
    if lost:
        failures.append(f"lost_acked_writes={lost}")
    if split_brain:
        failures.append(f"split_brain_acked_writes={split_brain}")
    if lin_violations:
        failures.append(f"linearizability_violations={lin_violations}")
    if availability < availability_floor:
        failures.append(f"availability={availability:.3f} < "
                        f"floor={availability_floor}")

    tele_sig = None
    if telemetry:
        from repro_torch.obs.export import telemetry_rows
        rows = []
        for hub in cl.hubs:
            if hub is not None:
                rows.extend(telemetry_rows(hub))
        tele_sig = hashlib.sha256(
            json.dumps(rows, sort_keys=True).encode()).hexdigest()

    report = ChaosReport(
        seed=seed, n_cns=n_cns, replicas=replicas, placement_k=placement_k,
        n_windows=len(sched.events), kinds=kinds, lanes=lanes,
        acked_writes=acked_writes, degraded_lanes=degraded,
        availability=availability, heal_checks=heal_checks,
        lost_acked_writes=lost, split_brain_acked_writes=split_brain,
        linearizability_violations=lin_violations,
        fenced_write_lanes=stats.fenced_write_lanes,
        partition_arbitrations=stats.partition_arbitrations,
        view_syncs=stats.view_syncs,
        meters=cl.meter_totals().snapshot(),
        state_sig=state_signature(cl.mn_state()),
        telemetry_sig=tele_sig,
        failures=failures, passed=not failures)
    report.cluster = cl
    return report


__all__ = ["ChaosReport", "generate_chaos", "run_chaos", "state_signature"]
