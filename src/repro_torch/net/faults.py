"""``repro_torch.net.faults`` — deterministic fault injection for the
recovery plane.

The port of ``repro.net.faults``: host Python, no device work, the same
classes, the same JSON and the same decisions call for call, so one
schedule drives a store of either package through the same outcomes.

The failure model lives in **two planes** that must agree:

* the **host plane** — engines + the ``repro_torch.api`` stack —
  *decides* outcomes: which calls see a dead MN and answer with
  ``"backoff"`` statuses, which requests are dropped on the wire, when a
  lease must be renewed, when the CN fails over.  Its clock is the **op
  clock**: a monotone count of protocol calls, advanced by
  :meth:`FaultPlane.tick`.  No wall clock, no RNG — every "random"
  decision (drop draws, backoff jitter) is a splitmix64 hash of
  ``(schedule.seed, draw counter)``, so two runs over the same workload
  make byte-identical decisions.
* the **sim plane** — :func:`repro_torch.net.replay.simulate` — *times*
  those outcomes.  The host plane annotates the trace (``Segment.mn``
  replica routing, ``Segment.wait_s`` CN-side stalls,
  :class:`repro_torch.net.transport.FaultMark` windows) and the replay
  turns them into queueing delay, paused replica servers, and
  NIC-saturation service stretches.

A :class:`FaultSchedule` is a frozen, JSON-round-trippable value (it
rides inside ``StoreSpec``); a :class:`FaultPlane` is the mutable oracle
one store instance consults.  Replaying the same schedule against the
same workload reproduces the same trace, percentiles, and final store
state.
"""

from __future__ import annotations

import dataclasses
import json

_FAULT_KINDS = ("mn_crash", "delay", "drop", "nic_saturation", "cn_crash",
                "partition", "cn_delay", "cn_drop")
# Kinds whose target is an MN replica index (validated against the
# deployed replica count) vs a CN index (validated against the deployed
# CN count by the cluster plane / ``open_store``).  ``partition`` names a
# CN<->MN *link pair* and appears in both sets.
MN_TARGET_KINDS = frozenset(("mn_crash", "nic_saturation", "partition"))
CN_TARGET_KINDS = frozenset(("cn_crash", "partition", "cn_delay", "cn_drop"))
_MASK = (1 << 64) - 1


def _mix64(*words: int) -> int:
    """splitmix64 over a word sequence — the only "randomness" source.

    Pure-int (no numpy) so the host plane never allocates; feeding the
    same words always yields the same 64-bit value.
    """
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h + (w & _MASK) + 0x9E3779B97F4A7C15) & _MASK
        z = h
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
        h = z ^ (z >> 31)
    return h


def _unit(*words: int) -> float:
    """Deterministic draw in [0, 1) from the word sequence."""
    return _mix64(*words) / float(1 << 64)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One fault window, anchored on the host-plane op clock.

    ``at_op``/``duration_ops`` bound the window in protocol calls (the
    deterministic host clock); ``down_s``/``factor`` describe its
    sim-plane footprint, carried into the trace via ``FaultMark``.

    Kinds:

    * ``"mn_crash"`` — replica ``mn`` is unreachable for the window.
      Calls that need it answer ``"backoff"``; the replay pauses that
      replica's CPU+NIC servers for ``down_s``.
    * ``"delay"`` — every call inside the window stalls ``extra_us``
      at the CN before posting (completion delay / congestion).
    * ``"drop"`` — each call inside the window is lost *before* MN
      application with probability ``drop_rate`` (seeded draw), so a
      retry is always state-safe: no store mutation happened.
    * ``"nic_saturation"`` — replica ``mn``'s NIC service times stretch
      by ``factor`` for ``down_s`` of sim time (incast window).
    * ``"cn_crash"`` — compute node ``cn`` is dead for the window.  The
      node is the *client* side, so no MN server pauses: the cluster
      plane (the reference's ``repro.cluster``, not ported yet) answers
      its calls ``"unavailable"`` locally and hands its shards to the
      survivors (ownership failover); the mark is recorded for sim-plane
      reporting only.
    * ``"partition"`` — the network link between compute node ``cn`` and
      MN replica ``mn`` is cut for the window (``mn=-1`` cuts every link
      from that CN).  Both endpoints stay alive: the CN's calls that
      need the cut replica answer ``"backoff"``, and when the CN is
      fully cut the cluster plane re-arbitrates its shard leases onto
      the survivors with a fencing-token bump (DINOMO-style — the stale
      owner's post-heal writes are *fenced*, never applied).  The replay
      stalls recorded segments per link for ``down_s``.
    * ``"cn_delay"`` — like ``"delay"`` but only calls issued *by*
      compute node ``cn`` stall ``extra_us`` before posting.
    * ``"cn_drop"`` — like ``"drop"`` but only calls issued by compute
      node ``cn`` are drop candidates (seeded draw on ``drop_rate``).
    """

    kind: str
    at_op: int
    duration_ops: int
    mn: int = 0
    down_s: float = 0.0
    factor: float = 1.0
    extra_us: float = 0.0
    drop_rate: float = 0.0
    cn: int = 0

    def validate(self) -> None:
        """Raise ``ValueError`` on an inexpressible window."""
        if self.kind not in _FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_FAULT_KINDS}")
        if self.at_op < 0 or self.duration_ops <= 0:
            raise ValueError("fault window needs at_op >= 0 and "
                             "duration_ops >= 1")
        if self.mn < 0 and not (self.kind == "partition" and self.mn == -1):
            raise ValueError("mn replica index must be >= 0 "
                             "(partition allows mn=-1: cut every link)")
        if self.mn > 0 and self.kind in ("cn_crash", "cn_delay", "cn_drop"):
            raise ValueError(f"{self.kind} targets a CN (use the 'cn' "
                             f"field); leave 'mn' at 0")
        if self.cn < 0:
            raise ValueError("cn compute-node index must be >= 0")
        if self.kind in ("mn_crash", "cn_crash", "partition") \
                and self.down_s <= 0:
            raise ValueError(f"{self.kind} needs down_s > 0 "
                             f"(sim-plane outage)")
        if self.kind == "nic_saturation" and (self.factor <= 1.0
                                              or self.down_s <= 0):
            raise ValueError("nic_saturation needs factor > 1 and down_s > 0")
        if self.kind in ("delay", "cn_delay") and self.extra_us <= 0:
            raise ValueError(f"{self.kind} needs extra_us > 0")
        if self.kind in ("drop", "cn_drop") \
                and not (0.0 < self.drop_rate <= 1.0):
            raise ValueError(f"{self.kind} needs 0 < drop_rate <= 1")

    def target(self) -> tuple:
        """The (kind-scoped) entity this window acts on — the overlap
        unit for :meth:`FaultSchedule.validate`.

        ``partition`` windows target a CN<->MN link pair; MN kinds target
        a replica; CN kinds target a compute node; global ``delay`` /
        ``drop`` windows target the whole deployment.
        """
        if self.kind == "partition":
            return ("link", self.cn, self.mn)
        if self.kind in ("cn_crash", "cn_delay", "cn_drop"):
            return ("cn", self.cn)
        if self.kind in ("mn_crash", "nic_saturation"):
            return ("mn", self.mn)
        return ("all",)

    def open_at(self, clock: int) -> bool:
        return self.at_op <= clock < self.at_op + self.duration_ops

    def to_json_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()}

    @classmethod
    def from_json_dict(cls, d: dict) -> "FaultEvent":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown FaultEvent fields: {sorted(extra)}")
        ev = cls(**d)
        ev.validate()
        return ev


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A seeded, replayable fault script plus the CN-side recovery knobs.

    Everything a CN needs to survive the script rides along so a spec is
    self-contained: the completion timeout, the jittered-backoff curve
    (FlexChain's BACKOFF idiom — degraded answers, never blocking), the
    failover trigger, and the MN lease term.  ``FaultSchedule()`` (no
    events) is the **dormant** schedule: the retry/replica machinery is
    installed but never fires, and meter totals stay byte-identical to a
    store built without it (asserted by the ``faults`` bench suite).

    Lease semantics (checked at the Transport boundary by
    ``ReplicaSetAdapter``): the CN holds one lease per MN replica,
    granted on first use and renewed every ``lease_term_ops`` of op
    clock with one small two-sided RT (heartbeat-style).  At failover
    the CN first waits ``lease_wait_us`` — a conservative full drain of
    the dead primary's outstanding lease — before acquiring a lease on
    the new primary, so two CNs can never both believe they own writes.
    ``lease_term_ops=0`` disables leasing.
    """

    events: tuple = ()
    seed: int = 0
    timeout_us: float = 100.0       # CN completion timeout per attempt
    backoff_base_us: float = 4.0    # first retry backoff (pre-jitter)
    backoff_cap_us: float = 512.0   # exponential backoff ceiling
    max_retries: int = 8            # attempts before degrading to "unavailable"
    failover_after: int = 1         # dead-primary retries before failing over
    lease_term_ops: int = 4096      # renew cadence on the op clock; 0 = off
    lease_wait_us: float = 50.0     # drain wait for a dead primary's lease

    def __post_init__(self):
        evs = tuple(FaultEvent.from_json_dict(e) if isinstance(e, dict) else e
                    for e in self.events)
        object.__setattr__(self, "events", evs)

    def validate(self) -> None:
        """Raise ``ValueError`` on a schedule the planes cannot honour."""
        for ev in self.events:
            if not isinstance(ev, FaultEvent):
                raise ValueError(f"events must be FaultEvent, got {type(ev)}")
            ev.validate()
        # Reject overlapping windows of the same kind on the same target:
        # the oracles would double-apply them (summed delays, doubled
        # drop draws) or shadow one another (crash windows), which is
        # never what a schedule author meant.  A ``partition`` with
        # ``mn=-1`` covers every link from its CN, so it conflicts with
        # any same-CN partition window.
        by_bucket: dict = {}
        for ev in self.events:
            by_bucket.setdefault((ev.kind,) + ev.target(), []).append(ev)
            if ev.kind == "partition":
                by_bucket.setdefault(("partition*", ev.cn), []).append(ev)
        def _reject(a, b):
            raise ValueError(
                f"overlapping {a.kind!r} windows on target {a.target()}"
                f" / {b.target()}: [{a.at_op}, {a.at_op + a.duration_ops})"
                f" and [{b.at_op}, {b.at_op + b.duration_ops})")

        for key, evs in by_bucket.items():
            if key[0] == "partition*":
                # Only the wildcard-vs-specific case; same-link (and
                # wildcard-wildcard) pairs are caught by their exact
                # bucket above.
                for a in (e for e in evs if e.mn == -1):
                    for b in (e for e in evs if e.mn != -1):
                        if a.at_op < b.at_op + b.duration_ops \
                                and b.at_op < a.at_op + a.duration_ops:
                            _reject(a, b)
                continue
            evs = sorted(evs, key=lambda e: (e.at_op, e.duration_ops))
            for a, b in zip(evs, evs[1:]):
                if b.at_op < a.at_op + a.duration_ops:
                    _reject(a, b)
        if self.timeout_us < 0 or self.backoff_base_us < 0 \
                or self.backoff_cap_us < self.backoff_base_us:
            raise ValueError("need timeout_us >= 0 and "
                             "0 <= backoff_base_us <= backoff_cap_us")
        if self.max_retries < 0 or self.failover_after < 1:
            raise ValueError("need max_retries >= 0 and failover_after >= 1")
        if self.lease_term_ops < 0 or self.lease_wait_us < 0:
            raise ValueError("lease knobs must be >= 0")

    # ------------------------------------------------------------- JSON
    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["events"] = [ev.to_json_dict() for ev in self.events]
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "FaultSchedule":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown FaultSchedule fields: {sorted(extra)}")
        sched = cls(**d)
        sched.validate()
        return sched

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FaultSchedule":
        return cls.from_json_dict(json.loads(s))

    # ----------------------------------------------------- conveniences
    @classmethod
    def single_crash(cls, at_op: int, duration_ops: int, *, mn: int = 0,
                     down_s: float = 200e-6, seed: int = 0,
                     **knobs) -> "FaultSchedule":
        """The canonical bench scenario: one MN crash/restart window."""
        return cls(events=(FaultEvent("mn_crash", at_op, duration_ops, mn=mn,
                                      down_s=down_s),),
                   seed=seed, **knobs)

    @classmethod
    def generate(cls, seed: int, n_ops: int, *, replicas: int = 2,
                 **knobs) -> "FaultSchedule":
        """Derive a mixed crash+delay+drop script from ``seed`` alone.

        Window placement is a pure function of ``(seed, n_ops)`` so a
        recorded spec regenerates the identical script.  The crash lands
        in the middle half of the workload on a seeded replica; a delay
        and a drop window land in the quarters around it.
        """
        span = max(n_ops, 16)
        crash_at = span // 4 + _mix64(seed, 1) % max(span // 2, 1)
        crash_len = max(span // 16, 4)
        ev = (FaultEvent("mn_crash", crash_at, crash_len,
                         mn=_mix64(seed, 2) % max(replicas, 1),
                         down_s=150e-6 + 100e-6 * _unit(seed, 3)),
              FaultEvent("delay", span // 8, max(span // 20, 2),
                         extra_us=2.0 + 6.0 * _unit(seed, 4)),
              FaultEvent("drop", 3 * span // 4, max(span // 20, 2),
                         drop_rate=0.1 + 0.3 * _unit(seed, 5)))
        return cls(events=ev, seed=seed, **knobs)


class FaultPlane:
    """The host-plane oracle one store instance consults per call.

    Holds the op clock, the per-replica lease grants, and the monotone
    draw counter behind drop decisions.  All queries are pure functions
    of (schedule, clock, draw counter) — replaying the same call
    sequence replays the same answers.
    """

    def __init__(self, schedule: FaultSchedule) -> None:
        schedule.validate()
        self.schedule = schedule
        self.clock = 0
        self._draws = 0
        self._announced: set = set()   # event ids already FaultMark'ed
        self._counted: set = set()     # event ids already telemetry-counted
        self._lease_at: dict[int, int] = {}  # replica -> clock of last grant

    # ------------------------------------------------------------ clock
    def tick(self, n: int = 1) -> None:
        """Advance the op clock by ``n`` protocol calls."""
        self.clock += int(n)

    # ---------------------------------------------------------- windows
    def crash_open(self, mn: int) -> bool:
        """Is replica ``mn`` inside an ``mn_crash`` window right now?"""
        return any(ev.kind == "mn_crash" and ev.mn == mn
                   and ev.open_at(self.clock) for ev in self.schedule.events)

    def cn_crash_open(self, cn: int) -> bool:
        """Is compute node ``cn`` inside a ``cn_crash`` window right now?

        MN-only deployments never ask; the cluster plane consults this
        (plus its own membership schedule) to fail a dead CN's calls
        locally and hand its shards over.
        """
        return any(ev.kind == "cn_crash" and ev.cn == cn
                   and ev.open_at(self.clock) for ev in self.schedule.events)

    def partition_open(self, cn: int, mn: int) -> bool:
        """Is the ``cn`` <-> replica ``mn`` link inside a ``partition``
        window right now?  (``mn=-1`` windows cut every link from cn.)"""
        return any(ev.kind == "partition" and ev.cn == cn
                   and ev.mn in (-1, mn) and ev.open_at(self.clock)
                   for ev in self.schedule.events)

    def fully_partitioned(self, cn: int, n_mns: int) -> bool:
        """Can compute node ``cn`` reach *no* MN replica right now?"""
        return n_mns > 0 and all(self.partition_open(cn, r)
                                 for r in range(n_mns))

    def delay_us(self, cn: int = 0) -> float:
        """Summed CN-side stall of every open ``delay`` window, plus
        every open ``cn_delay`` window targeting calling node ``cn``."""
        return sum(ev.extra_us for ev in self.schedule.events
                   if ((ev.kind == "delay"
                        or (ev.kind == "cn_delay" and ev.cn == cn))
                       and ev.open_at(self.clock)))

    def drop_now(self, cn: int = 0) -> bool:
        """Seeded draw: is this call lost before MN application?

        ``drop`` windows apply to every caller; ``cn_drop`` windows only
        to calls issued by node ``cn``.  The draw counter advances only
        inside an open drop window, so a no-drop workload consumes no
        draws and stays byte-identical.
        """
        for ev in self.schedule.events:
            if (ev.kind == "drop"
                    or (ev.kind == "cn_drop" and ev.cn == cn)) \
                    and ev.open_at(self.clock):
                self._draws += 1
                if _unit(self.schedule.seed, self.clock,
                         self._draws) < ev.drop_rate:
                    return True
        return False

    def new_marks(self):
        """Events whose window just opened and that the sim plane must
        see (crash + NIC + partition windows); each is yielded exactly
        once."""
        out = []
        for i, ev in enumerate(self.schedule.events):
            if ev.kind in ("mn_crash", "nic_saturation", "partition") \
                    and i not in self._announced and ev.open_at(self.clock):
                self._announced.add(i)
                out.append(ev)
        return out

    def new_window_events(self):
        """*Every* event whose window just opened, yielded exactly once —
        the telemetry plane counts these as ``faults{kind=...}``.

        Separate announce set from :meth:`new_marks` so trace marks and
        telemetry counters can be consumed by different layers.
        """
        out = []
        for i, ev in enumerate(self.schedule.events):
            if i not in self._counted and ev.open_at(self.clock):
                self._counted.add(i)
                out.append(ev)
        return out

    # ---------------------------------------------------------- backoff
    def backoff_us(self, attempt: int) -> float:
        """Jittered exponential backoff for retry round ``attempt``.

        ``min(cap, base * 2^attempt)`` scaled by a seeded jitter in
        [0.5, 1.0) — decorrelated retries without wall-clock randomness.
        """
        s = self.schedule
        raw = min(s.backoff_cap_us, s.backoff_base_us * (2.0 ** attempt))
        return raw * (0.5 + 0.5 * _unit(s.seed, self.clock, attempt, 0xB0FF))

    # ----------------------------------------------------------- leases
    def lease_due(self, mn: int) -> bool:
        """Must the CN renew its lease on replica ``mn`` before using it?

        True on first use and every ``lease_term_ops`` thereafter
        (heartbeat renewal on the op clock); always False when leasing
        is disabled.
        """
        term = self.schedule.lease_term_ops
        if term <= 0:
            return False
        at = self._lease_at.get(mn)
        return at is None or self.clock - at >= term

    def lease_granted(self, mn: int) -> None:
        """Record a renewal: replica ``mn``'s lease now dates from the
        current clock."""
        self._lease_at[mn] = self.clock

    def lease_revoked(self, mn: int) -> None:
        """Forget a lease (the CN failed away from ``mn``)."""
        self._lease_at.pop(mn, None)


__all__ = ["CN_TARGET_KINDS", "FaultEvent", "FaultPlane", "FaultSchedule",
           "MN_TARGET_KINDS"]
