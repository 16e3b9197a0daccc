"""``repro_torch.cluster.membership`` — deterministic elastic-membership
scripts (the port of ``repro.cluster.membership``, the same JSON).

The multi-CN plane mirrors the failure plane's two-plane split
(``repro_torch.net.faults``): membership changes
are *decided* on the cluster's **op clock** — a monotone count of
protocol lanes entering any CN's stack — and *timed* by the replay
engine from the trace annotations the handoff leaves behind (bulk-read
segments, lease-drain waits, ``cn_crash`` FaultMarks).  No wall clock,
no RNG: the only "randomness" is splitmix64 over ``(seed, ...)``, so a
recorded :class:`MembershipSchedule` replays the identical join/leave
timeline, shard moves, and meter totals.

A schedule is a frozen, JSON-round-trippable value (it rides inside
``repro_torch.cluster.ClusterSpec``); the :class:`repro_torch.cluster.Cluster`
runtime is the mutable consumer.  ``MembershipSchedule()`` (no events)
is the **dormant** schedule: with one CN it reduces the cluster to the
plain ``open_store`` stack byte-for-byte (dormant-plane contract #3).
"""

from __future__ import annotations

import dataclasses
import json

from repro_torch.net.faults import FaultSchedule, _mix64, _unit

_MEMBER_KINDS = ("join", "leave", "cn_crash")


@dataclasses.dataclass(frozen=True)
class MembershipEvent:
    """One membership change, anchored on the cluster op clock.

    Kinds:

    * ``"join"`` — CN ``cn`` enters the cluster at ``at_op``: the
      ownership table rebalances over the new live set and the joiner
      bulk-fetches only its newly-owned shards' CN half (DMPH seeds +
      othello arrays) under a lease-gated cutover.
    * ``"leave"`` — CN ``cn`` departs cleanly at ``at_op``: survivors
      absorb its shards the same way; every write it acked is already
      durable at the MN pool, so nothing is lost.
    * ``"cn_crash"`` — CN ``cn`` dies at ``at_op`` and restarts (rejoins)
      after ``duration_ops``; ``down_s`` is its sim-plane footprint
      (recorded as a ``FaultMark`` on the dead CN's trace).  Same
      failover as a leave, plus a rejoin handoff at window close.
    """

    kind: str
    at_op: int
    cn: int
    duration_ops: int = 0
    down_s: float = 0.0

    def validate(self) -> None:
        """Raise ``ValueError`` on an inexpressible event."""
        if self.kind not in _MEMBER_KINDS:
            raise ValueError(f"unknown membership kind {self.kind!r}; "
                             f"expected one of {_MEMBER_KINDS}")
        if self.at_op < 0 or self.cn < 0:
            raise ValueError("membership event needs at_op >= 0 and cn >= 0")
        if self.kind == "cn_crash":
            if self.duration_ops < 1 or self.down_s <= 0:
                raise ValueError("cn_crash needs duration_ops >= 1 and "
                                 "down_s > 0 (sim-plane outage)")
        elif self.duration_ops != 0:
            raise ValueError(f"{self.kind} is instantaneous; "
                             f"duration_ops must be 0")

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json_dict(cls, d: dict) -> "MembershipEvent":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown MembershipEvent fields: "
                             f"{sorted(extra)}")
        ev = cls(**d)
        ev.validate()
        return ev


@dataclasses.dataclass(frozen=True)
class MembershipSchedule:
    """A seeded, replayable membership script.

    ``initial`` names the CN ids live when the cluster opens (``None``
    means all of them); ``seed`` feeds both generated scripts and the
    ownership table's rendezvous hash, so the same schedule always maps
    the same shards to the same CNs.
    """

    events: tuple = ()
    seed: int = 0
    initial: tuple | None = None

    def __post_init__(self):
        evs = tuple(MembershipEvent.from_json_dict(e) if isinstance(e, dict)
                    else e for e in self.events)
        object.__setattr__(self, "events", evs)
        if self.initial is not None:
            object.__setattr__(self, "initial",
                               tuple(sorted(int(c) for c in self.initial)))

    def validate(self, n_cns: int | None = None) -> None:
        """Raise ``ValueError`` on a script the cluster cannot honour."""
        for ev in self.events:
            if not isinstance(ev, MembershipEvent):
                raise ValueError(f"events must be MembershipEvent, "
                                 f"got {type(ev)}")
            ev.validate()
            if n_cns is not None and ev.cn >= n_cns:
                raise ValueError(f"event targets CN {ev.cn} but the cluster "
                                 f"deploys {n_cns} CN(s)")
        if self.initial is not None:
            if not self.initial:
                raise ValueError("initial live set must be non-empty")
            if any(c < 0 for c in self.initial):
                raise ValueError("initial CN ids must be >= 0")
            if n_cns is not None and any(c >= n_cns for c in self.initial):
                raise ValueError(f"initial live set names a CN >= {n_cns}")

    # ------------------------------------------------------------- JSON
    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["events"] = [ev.to_json_dict() for ev in self.events]
        d["initial"] = None if self.initial is None else list(self.initial)
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "MembershipSchedule":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown MembershipSchedule fields: "
                             f"{sorted(extra)}")
        init = d.get("initial")
        sched = cls(events=tuple(d.get("events", ())),
                    seed=int(d.get("seed", 0)),
                    initial=None if init is None else tuple(init))
        sched.validate()
        return sched

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "MembershipSchedule":
        return cls.from_json_dict(json.loads(s))

    # ----------------------------------------------------- conveniences
    @classmethod
    def single_join(cls, at_op: int, cn: int, *, initial=None,
                    seed: int = 0) -> "MembershipSchedule":
        """The canonical scale-out scenario: one CN joins mid-run."""
        return cls(events=(MembershipEvent("join", at_op, cn),),
                   seed=seed, initial=initial)

    @classmethod
    def single_leave(cls, at_op: int, cn: int, *,
                     seed: int = 0) -> "MembershipSchedule":
        """The canonical scale-in scenario: one CN departs mid-run."""
        return cls(events=(MembershipEvent("leave", at_op, cn),), seed=seed)

    @classmethod
    def generate(cls, seed: int, n_ops: int, *,
                 n_cns: int = 2) -> "MembershipSchedule":
        """Derive a churn script from ``seed`` alone (like
        ``FaultSchedule.generate``): one crash/restart window in the
        middle half plus a clean leave in the final quarter, both on
        seeded non-overlapping CNs so the cluster never empties."""
        span = max(n_ops, 16)
        crash_cn = _mix64(seed, 1) % max(n_cns, 1)
        leave_cn = (crash_cn + 1 + _mix64(seed, 2)
                    % max(n_cns - 1, 1)) % max(n_cns, 1)
        ev = (MembershipEvent("cn_crash",
                              span // 4 + _mix64(seed, 3) % max(span // 4, 1),
                              crash_cn, duration_ops=max(span // 8, 4),
                              down_s=150e-6 + 100e-6 * _unit(seed, 4)),
              MembershipEvent("leave", 3 * span // 4, leave_cn))
        return cls(events=ev, seed=seed)

    @classmethod
    def from_faults(cls, faults: FaultSchedule, *,
                    initial=None) -> "MembershipSchedule":
        """Lift the ``cn_crash`` events out of a fault schedule.

        The CN-side fault-injection satellite: a ``FaultSchedule`` riding
        a ``StoreSpec`` may now carry ``cn_crash`` windows; this converts
        them so the cluster can kill a CN mid-run off the same script
        that crashes MNs.  Each window's ``duration_ops``/``down_s``
        carry over; the restart is the window close."""
        evs = tuple(MembershipEvent("cn_crash", ev.at_op, ev.cn,
                                    duration_ops=ev.duration_ops,
                                    down_s=ev.down_s)
                    for ev in faults.events if ev.kind == "cn_crash")
        return cls(events=evs, seed=faults.seed, initial=initial)


__all__ = ["MembershipEvent", "MembershipSchedule"]
