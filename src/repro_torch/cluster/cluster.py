"""``repro_torch.cluster.cluster`` — N per-CN stacks over one shared MN pool.

The port of ``repro.cluster.cluster``: host logic over the port's stack.
The shared MN pool is one engine adapter on the cluster's device (CUDA
unless the caller passes ``device="cpu"``), so every CN's misses run the
port's ``ludo_lookup`` and ``slot_unpack`` kernels; routing, ownership,
epochs and handoffs stay on the host, and a key's shard is hashed with
``hashing.hash64_32_np`` (no device op).  The runtime composes three
pieces this package adds — a
:class:`~repro_torch.cluster.membership.MembershipSchedule` (op-clock
join/leave/crash script), an
:class:`~repro_torch.cluster.ownership.OwnershipTable` (rendezvous-hashed
shard -> owning CN, O(shards moved) rebalance) and
:class:`~repro_torch.cluster.coherence.ShardEpochs` (per-shard invalidation
epochs) — around the *existing* single-CN machinery:

* one shared engine adapter (the MN pool:
  ``repro_torch.api.registry.build_adapter`` — replica-wrapped when the
  spec carries faults), fed by a :class:`SwitchingTransport` so every wire
  event lands on the calling CN's own trace;
* per CN ``i``: a full ``Pipeline -> Meter -> EpochGate -> CNCache ->
  [Retry ->] CNRouter`` stack with its own ``CommMeter`` ledger,
  ``CNKeyCache``, ``Transport``, and (if the spec asks) ``TelemetryHub``
  carrying ``cn=i`` dims.

**Dormant-plane contract**: a Cluster of N=1 with an empty membership
schedule is byte-identical to the ``open_store`` path — same CommMeter
totals, same recorded trace, same final MN state.  Every cluster-only
mechanism (epoch gate, ownership, forwarding, handoff) is either pure
host-plane bookkeeping or fires only when a second CN exists.

Routing rules (the coherence contract, ``docs/CLUSTER.md``):

* reads: any CN may serve any shard from its cache *after* the epoch
  check; misses go to the MN pool directly (one-sided — the MN doesn't
  care who reads).  A non-owner's miss additionally pays one batched
  CN->CN forward RPC to the owner (location + admission), recorded on
  the requester's trace with ``Segment.cn_dst`` so the replay queues it
  on the owner's RPC thread.
* writes: non-owners forward to the owner the same way; the owning CN
  multicasts an invalidation **epoch bump** piggybacked on the write's
  existing round trips (zero extra wire), and every other CN drops its
  cached entries for the shard at its next epoch check.
* membership change: the ownership table rebalances; each destination
  CN bulk-reads only the moved shards' CN half (DMPH seeds + othello
  arrays — the §4.4 locator-fetch shape) and waits out the old owner's
  lease (the replica failover's drain) before serving — O(shards
  moved), never O(keys).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.api.pipeline import PipelineLayer
from repro_torch.api.protocol import OpResult
from repro_torch.api.registry import SpecError, StoreSpec, build_adapter
from repro_torch.api.replication import UNAVAILABLE, ReplicaSetAdapter
from repro_torch.api.stack import (CNCacheLayer, MeterLayer, RetryLayer,
                                   StoreLayer)
from repro_torch.cluster.coherence import ShardEpochs
from repro_torch.cluster.membership import MembershipSchedule
from repro_torch.cluster.ownership import OwnershipTable
from repro_torch.core.cn_cache import CNKeyCache
from repro_torch.core.hashing import hash64_32, hash64_32_np, split_u64
from repro_torch.core.meter import MSG_BYTES, CommMeter
from repro_torch.core.outback import resolve_device
from repro_torch.core.store import _DIR_SEED
from repro_torch.net.faults import CN_TARGET_KINDS
from repro_torch.net.transport import Transport

# CN->CN forward RPC shape: one padded request/response pair per batched
# forward, plus per-lane key/value payload riding inside it.
_FWD_KEY_BYTES = 8
_FWD_LANE_RESP_BYTES = 16


class SwitchingTransport:
    """One transport facade multiplexing the shared engine's wire events
    onto per-CN traces.

    The engine meters hold exactly one sink; in a cluster that sink is
    this switch, and the active :class:`CNRouter` points ``current`` at
    its CN around every engine call — so each wire event, resize mark,
    fault mark, and CN-side wait lands on the trace of the CN that
    issued it.  With one CN everything delegates to ``transports[0]``
    unconditionally, which is what keeps the dormant plane byte-exact.

    ``hub_sinks`` (optional, one per CN) fans the same events into each
    CN's TelemetryHub wire sink under its ``cn=i`` dims.
    """

    def __init__(self, transports, hub_sinks=None) -> None:
        self.transports = list(transports)
        self.current = 0
        self.hub_sinks = hub_sinks

    @property
    def _t(self):
        return self.transports[self.current]

    # ------------------------------------------------- Transport surface
    def on_meter_add(self, n, **kw) -> None:
        self._t.on_meter_add(n, **kw)
        if self.hub_sinks is not None:
            self.hub_sinks[self.current].on_meter_add(n, **kw)

    def mark_resize(self, n_live) -> None:
        self._t.mark_resize(n_live)

    def mark_fault(self, kind, **kw) -> None:
        self._t.mark_fault(kind, **kw)

    def add_wait(self, seconds) -> None:
        self._t.add_wait(seconds)

    def begin_doorbell(self):
        return self._t.begin_doorbell()

    def close_doorbell(self, token) -> None:
        self._t.close_doorbell(token)

    @property
    def current_mn(self):
        return self._t.current_mn

    @current_mn.setter
    def current_mn(self, value) -> None:
        self._t.current_mn = value

    @property
    def current_cn_dst(self):
        return self._t.current_cn_dst

    @current_cn_dst.setter
    def current_cn_dst(self, value) -> None:
        self._t.current_cn_dst = value

    def reset(self) -> None:
        for t in self.transports:
            t.reset()


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Frozen, JSON-round-trippable description of a cluster deployment.

    ``store`` is the per-CN :class:`StoreSpec` (must be the directory
    kind — ownership is a per-directory-shard property); ``n_cns`` the
    compute-node count; ``n_mns`` the width of the shared MN pool
    (shard's home MN = ``shard % n_mns`` — pure striping, only legal
    without MN replication); ``membership`` the elastic script;
    ``lease_wait_us`` the cutover drain charged per handoff destination
    (the replica failover's lease-drain idiom).
    """

    store: StoreSpec
    n_cns: int = 1
    n_mns: int = 1
    membership: MembershipSchedule | None = None
    lease_wait_us: float = 50.0

    def __post_init__(self):
        if isinstance(self.store, dict):
            object.__setattr__(self, "store",
                               StoreSpec.from_json_dict(self.store))
        if isinstance(self.membership, dict):
            object.__setattr__(
                self, "membership",
                MembershipSchedule.from_json_dict(self.membership))

    def validate(self) -> None:
        self.store.validate()
        if getattr(self.store, "kind", None) != "outback-dir":
            raise SpecError(
                f"cluster needs the directory kind ('outback-dir') so "
                f"ownership maps to directory shards; got "
                f"{self.store.kind!r}")
        if not isinstance(self.n_cns, int) or self.n_cns < 1:
            raise SpecError(f"n_cns must be an int >= 1, got {self.n_cns!r}")
        if not isinstance(self.n_mns, int) or self.n_mns < 1:
            raise SpecError(f"n_mns must be an int >= 1, got {self.n_mns!r}")
        if self.n_mns > 1 and (self.store.replicas > 1
                               or self.store.faults is not None):
            raise SpecError("n_mns > 1 stripes shards over the MN pool and "
                            "cannot compose with MN replication/faults "
                            "(replica routing owns Segment.mn)")
        if self.lease_wait_us < 0:
            raise SpecError("lease_wait_us must be >= 0")
        if self.membership is not None:
            if not isinstance(self.membership, MembershipSchedule):
                raise SpecError(
                    f"membership must be a MembershipSchedule (or its JSON "
                    f"dict), got {type(self.membership).__name__}")
            try:
                self.membership.validate(self.n_cns)
            except ValueError as e:
                raise SpecError(str(e)) from e
        if self.store.faults is not None:
            for ev in self.store.faults.events:
                if ev.kind in CN_TARGET_KINDS and ev.cn >= self.n_cns:
                    raise SpecError(f"{ev.kind} targets CN {ev.cn} but the "
                                    f"cluster deploys {self.n_cns} CN(s)")

    # ------------------------------------------------------------- JSON
    def to_json_dict(self) -> dict:
        return {"store": self.store.to_json_dict(),
                "n_cns": self.n_cns, "n_mns": self.n_mns,
                "membership": (None if self.membership is None
                               else self.membership.to_json_dict()),
                "lease_wait_us": self.lease_wait_us}

    @classmethod
    def from_json_dict(cls, d: dict) -> "ClusterSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise SpecError(f"unknown ClusterSpec fields: {sorted(extra)}")
        spec = cls(**d)
        spec.validate()
        return spec

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ClusterSpec":
        return cls.from_json_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class HandoffEvent:
    """One completed ownership reconfiguration."""

    at_op: int
    reason: str        # "join" | "leave" | "cn_crash" | "cn_restart"
    #                  # | "partition" (fully-cut CN arbitrated away)
    #                  # | "heal" (fenced CN re-synced its view)
    cn: int            # the node that joined/left/crashed/restarted
    moved: tuple       # ((shard, old_owner, new_owner), ...)
    bytes_moved: int   # summed CN-half bytes bulk-read by destinations

    def to_json_dict(self) -> dict:
        return {"at_op": self.at_op, "reason": self.reason, "cn": self.cn,
                "moved": [list(m) for m in self.moved],
                "bytes_moved": self.bytes_moved}


@dataclasses.dataclass
class ClusterStats:
    """Always-on host-plane counters (no meter/trace footprint)."""

    forwarded_read_lanes: int = 0
    forwarded_write_lanes: int = 0
    forward_rpcs: int = 0
    rejected_lanes: int = 0      # lanes answered "unavailable" (dead CN)
    handoffs: int = 0
    shards_moved: int = 0
    handoff_bytes: int = 0
    epoch_invalidations: int = 0  # cache entries dropped by epoch checks
    # partition / fencing plane (all stay 0 without partition windows)
    partition_arbitrations: int = 0  # fully-cut CNs whose leases moved
    fenced_write_lanes: int = 0  # stale-epoch write lanes rejected at MN
    fenced_rpcs: int = 0         # fence-rejected RPCs (1 per fenced call)
    view_syncs: int = 0          # stale ownership views refreshed post-heal

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class EpochGate(StoreLayer):
    """Per-CN membership + coherence gate (sits above the CN cache).

    Every protocol call first ticks the cluster op clock (driving
    membership events), then rejects dead-CN calls with degraded
    ``"unavailable"`` answers (no wire, no cache probe — a dead CN
    serves nothing), then runs the epoch check: stale shards' cached
    entries are dropped *before* the cache layer below may serve them.
    With one CN no epoch is ever foreign and the gate is pure
    pass-through.
    """

    def __init__(self, inner, cluster: "Cluster", cn: int) -> None:
        super().__init__(inner)
        self.cluster = cluster
        self.cn = cn

    def _gate(self, keys: np.ndarray, n: int):
        cl = self.cluster
        cl.on_op(self.cn, n)
        if not cl.cn_active(self.cn):
            cl.stats.rejected_lanes += n
            return OpResult(values=np.zeros(n, np.uint64),
                            found=np.zeros(n, bool),
                            statuses=(UNAVAILABLE,) * n)
        cl.epoch_sync(self.cn, keys)
        return None

    # ------------------------------------------------------------- reads
    def get(self, key: int) -> OpResult:
        r = self._gate(np.asarray([key], np.uint64), 1)
        return r if r is not None else self.inner.get(key)

    def get_batch(self, keys, *,
                  resolve_makeup: bool | None = None) -> OpResult:
        keys = np.asarray(keys, dtype=np.uint64)
        r = self._gate(keys, len(keys))
        if r is not None:
            return r
        return self.inner.get_batch(keys, resolve_makeup=resolve_makeup)

    # ---------------------------------------------------------- mutations
    def insert(self, key: int, value: int) -> OpResult:
        r = self._gate(np.asarray([key], np.uint64), 1)
        return r if r is not None else self.inner.insert(key, value)

    def update(self, key: int, value: int) -> OpResult:
        r = self._gate(np.asarray([key], np.uint64), 1)
        return r if r is not None else self.inner.update(key, value)

    def delete(self, key: int) -> OpResult:
        r = self._gate(np.asarray([key], np.uint64), 1)
        return r if r is not None else self.inner.delete(key)

    def insert_batch(self, keys, values) -> OpResult:
        keys = np.asarray(keys, dtype=np.uint64)
        r = self._gate(keys, len(keys))
        return r if r is not None else self.inner.insert_batch(keys, values)

    def update_batch(self, keys, values) -> OpResult:
        keys = np.asarray(keys, dtype=np.uint64)
        r = self._gate(keys, len(keys))
        return r if r is not None else self.inner.update_batch(keys, values)

    def delete_batch(self, keys) -> OpResult:
        keys = np.asarray(keys, dtype=np.uint64)
        r = self._gate(keys, len(keys))
        return r if r is not None else self.inner.delete_batch(keys)


class CNRouter(StoreLayer):
    """CN ``i``'s routing stage over the shared MN adapter.

    Owns the per-CN ledger meter (forwards, handoff bulk reads, cache
    savings land here; its sink is the CN's own transport) and, around
    every delegated engine call, points the cluster's
    :class:`SwitchingTransport` at this CN so the shared engine's wire
    events record on the right trace.  Lanes owned by another live CN
    pay one batched CN->CN forward RPC per destination; with ``n_mns >
    1`` lanes are grouped by their shard's home MN and the group's
    replica index is stamped into the segments (``Segment.mn``) for the
    replay's MN-pool routing.

    The reference's router reaches the shared adapter's members through
    ``__getattr__``; here the ones the stages above call (``primary``,
    ``can_failover``, ``failover`` for the retry stage) are forwarded by
    name, like every ``StoreLayer`` member.
    """

    def __init__(self, cluster: "Cluster", cn: int) -> None:
        super().__init__(cluster.shared)
        self.cluster = cluster
        self.cn = cn
        self.ledger = cluster.ledgers[cn]

    # ------------------------------------------------- adapter surface
    @property
    def meter(self) -> CommMeter:
        return self.ledger

    def meter_totals(self) -> CommMeter:
        return self.cluster.meter_totals()

    def reset_meters(self) -> None:
        self.cluster.reset_meters()

    def bind_cache(self, cache) -> None:
        self.cluster.shared.bind_cache(cache)

    # the replica set's failover surface (the retry stage drives it)
    @property
    def primary(self) -> int:
        return self.inner.primary

    def can_failover(self) -> bool:
        return self.inner.can_failover()

    def failover(self) -> bool:
        return self.inner.failover()

    # ------------------------------------------------------ forwarding
    def _charge_forwards(self, owners: np.ndarray, write: bool) -> None:
        cl = self.cluster
        foreign = owners != self.cn
        if not foreign.any():
            return
        t = cl.transports[self.cn]
        for dst in np.unique(owners[foreign]):
            nj = int((owners == dst).sum())
            t.current_cn_dst = int(dst)
            self.ledger.add(1, rts=1, req=MSG_BYTES + _FWD_KEY_BYTES * nj,
                            resp=MSG_BYTES + _FWD_LANE_RESP_BYTES * nj)
            t.current_cn_dst = -1
            cl.stats.forward_rpcs += 1
        n_fwd = int(foreign.sum())
        if write:
            cl.stats.forwarded_write_lanes += n_fwd
        else:
            cl.stats.forwarded_read_lanes += n_fwd

    # --------------------------------------------------------- fencing
    def _stale_lanes(self, view: tuple, shards: np.ndarray) -> int:
        """Write lanes whose shard's live fencing token moved past the
        token in this CN's frozen snapshot (``view``)."""
        fence = view[1]
        live_fence = self.cluster.ownership.fence
        n_stale = 0
        for s in np.unique(shards):
            s = int(s)
            if s >= len(fence) or fence[s] != live_fence[s]:
                n_stale += int((shards == s).sum())
        return n_stale

    def _fence_reject(self, n_stale: int) -> None:
        """The MN boundary compared this CN's lease epoch against the
        shard's fencing token and refused the write: one small RPC pair
        crossed the wire, nothing was applied, nothing is acked."""
        cl = self.cluster
        self.ledger.add(1, rts=1, req=MSG_BYTES, resp=MSG_BYTES)
        self.ledger.fenced_writes += n_stale
        cl.stats.fenced_write_lanes += n_stale
        cl.stats.fenced_rpcs += 1
        cl.transports[self.cn].mark_fault("fenced", cn=self.cn)
        hub = cl.hubs[self.cn]
        if hub is not None:
            hub.count("cluster.fenced_writes", n_stale)
            hub.count("faults", kind="fenced")

    def _dispatch(self, op: str, keys, values, resolve_makeup,
                  scalar: bool) -> OpResult:
        inner = self.inner
        if scalar:
            k = int(keys[0])
            if op == "get":
                return inner.get(k)
            if op == "insert":
                return inner.insert(k, int(values[0]))
            if op == "update":
                return inner.update(k, int(values[0]))
            return inner.delete(k)
        if op == "get":
            return inner.get_batch(keys, resolve_makeup=resolve_makeup)
        if op == "insert":
            return inner.insert_batch(keys, values)
        if op == "update":
            return inner.update_batch(keys, values)
        return inner.delete_batch(keys)

    def _route(self, op: str, keys, values=None, resolve_makeup=None,
               scalar: bool = False) -> OpResult:
        cl = self.cluster
        keys = np.asarray(keys, dtype=np.uint64)
        shards = cl.shards_of(keys)
        write = op != "get"
        view = cl.stale_views.get(self.cn)
        if write and view is not None and cl.cn_reachable(self.cn):
            # the link healed but this CN still routes from its frozen
            # snapshot: the first write touching a re-arbitrated shard
            # is fenced at the MN boundary, which forces the view sync;
            # the call then re-routes on the authoritative table below
            n_stale = self._stale_lanes(view, shards)
            if n_stale:
                self._fence_reject(n_stale)
                cl.heal_view(self.cn)
                view = None
        if cl.n_live > 1:
            owners = cl.ownership.owners_for(shards)
            if view is not None:
                # a partitioned/stale CN routes from its snapshot
                vo = np.asarray(view[0], dtype=np.int64)
                in_view = shards < len(vo)
                owners = np.where(in_view,
                                  vo[np.minimum(shards, len(vo) - 1)],
                                  owners)
            self._charge_forwards(owners, write)
        cl.switch.current = self.cn
        if cl.n_mns <= 1:
            res = self._dispatch(op, keys, values, resolve_makeup, scalar)
        else:
            res = self._dispatch_pooled(op, keys, values, shards,
                                        resolve_makeup, scalar)
        cl.after_engine_call()
        if write:
            cl.epoch_bump(self.cn, shards)
        return res

    def _dispatch_pooled(self, op, keys, values, shards, resolve_makeup,
                         scalar) -> OpResult:
        """Group lanes by their shard's home MN (``shard % n_mns``) and
        stamp each group's replica index into its segments."""
        cl = self.cluster
        t = cl.transports[self.cn]
        homes = np.asarray(shards, dtype=np.int64) % cl.n_mns
        uniq = np.unique(homes)
        if len(uniq) == 1:
            t.current_mn = int(uniq[0])
            try:
                return self._dispatch(op, keys, values, resolve_makeup,
                                      scalar)
            finally:
                t.current_mn = 0
        n = len(keys)
        out_v = np.zeros(n, np.uint64)
        out_f = np.zeros(n, bool)
        statuses: list | None = None
        for mn in uniq:
            m = homes == mn
            t.current_mn = int(mn)
            try:
                sub = self._dispatch(op, keys[m],
                                     None if values is None
                                     else np.asarray(values)[m],
                                     resolve_makeup, False)
            finally:
                t.current_mn = 0
            out_v[m] = sub.values
            out_f[m] = sub.found
            if sub.statuses is not None:
                if statuses is None:
                    statuses = ["ok"] * n
                for pos, st in zip(np.flatnonzero(m), sub.statuses):
                    statuses[pos] = st
        return OpResult(values=out_v, found=out_f,
                        statuses=None if statuses is None
                        else tuple(statuses))

    # --------------------------------------------------------- protocol
    def get(self, key: int) -> OpResult:
        return self._route("get", np.asarray([key], np.uint64), scalar=True)

    def get_batch(self, keys, *,
                  resolve_makeup: bool | None = None) -> OpResult:
        return self._route("get", keys, resolve_makeup=resolve_makeup)

    def insert(self, key: int, value: int) -> OpResult:
        return self._route("insert", np.asarray([key], np.uint64),
                           np.asarray([value], np.uint64), scalar=True)

    def update(self, key: int, value: int) -> OpResult:
        return self._route("update", np.asarray([key], np.uint64),
                           np.asarray([value], np.uint64), scalar=True)

    def delete(self, key: int) -> OpResult:
        return self._route("delete", np.asarray([key], np.uint64),
                           scalar=True)

    def insert_batch(self, keys, values) -> OpResult:
        return self._route("insert", keys, values)

    def update_batch(self, keys, values) -> OpResult:
        return self._route("update", keys, values)

    def delete_batch(self, keys) -> OpResult:
        return self._route("delete", keys)


class Cluster:
    """The multi-CN runtime: N per-CN stacks over one shared MN pool.

    ``cluster.cns[i]`` is CN ``i``'s assembled
    :class:`~repro_torch.api.protocol.PipelinedKVStore` — the same surface
    ``open_store`` returns, so a caller drives a cluster exactly like a
    single store.  ``cluster.transports[i]`` /
    ``cluster.ledgers[i]`` / ``cluster.caches[i]`` / ``cluster.hubs[i]``
    expose the per-CN planes; :meth:`meter_totals` merges the pool +
    every ledger into the cluster-wide accounting.  The pool and every
    CN cache live on ``device`` (CUDA unless the caller passes
    ``device="cpu"``; it raises when CUDA is absent).
    """

    def __init__(self, spec: ClusterSpec, keys, values, *,
                 device=None) -> None:
        spec.validate()
        self.device = device = resolve_device(device)
        self.spec = spec
        sspec = spec.store
        n = spec.n_cns
        self.n_mns = spec.n_mns
        self.stats = ClusterStats()
        self.handoffs: list[HandoffEvent] = []
        self.clock = 0

        self.transports = [Transport() for _ in range(n)]
        if sspec.telemetry is not None:
            from repro_torch.obs import TelemetryHub
            self.hubs = [TelemetryHub(sspec.telemetry) for _ in range(n)]
            hub_sinks = [h.wire_sink(cn=i) for i, h in enumerate(self.hubs)]
        else:
            self.hubs = [None] * n
            hub_sinks = None
        self.switch = SwitchingTransport(self.transports, hub_sinks)
        self.shared, self.retry_plane = build_adapter(
            sspec, keys, values, device=device, transport=self.switch)
        if isinstance(self.shared, ReplicaSetAdapter):
            # CN-scoped fault windows (partition / cn_delay / cn_drop)
            # need to know which CN is calling the shared adapter
            self.shared.cn_source = lambda: self.switch.current

        # ledgers first: CNRouter construction reads them
        self.ledgers = []
        for i in range(n):
            led = CommMeter()
            led.sink = self.transports[i]
            if self.hubs[i] is not None:
                led.add_sink(self.hubs[i].wire_sink(cn=i, src="cn"))
            self.ledgers.append(led)

        # membership: schedule events + any cn_crash windows riding the
        # store spec's fault schedule (the CN-side fault-injection seam)
        sched = spec.membership or MembershipSchedule()
        events = list(sched.events)
        if sspec.faults is not None:
            events.extend(MembershipSchedule.from_faults(sspec.faults).events)
        self._events = sorted(events, key=lambda ev: (ev.at_op, ev.cn))
        self._next_ev = 0
        # partition arbitration: fully-cut CNs lose their shard leases to
        # the survivors (fence bump); they keep routing from a frozen
        # ownership snapshot until their first post-heal write is fenced
        self._partition_evs = tuple(sorted(
            (ev for ev in (sspec.faults.events if sspec.faults is not None
                           else ()) if ev.kind == "partition"),
            key=lambda ev: (ev.at_op, ev.cn, ev.mn)))
        self._next_part = 0
        self.stale_views: dict[int, tuple] = {}  # cn -> ownership.snapshot()
        self._mn_pool_width = max(1, sspec.replicas)
        initial = sched.initial if sched.initial is not None else range(n)
        self.live: set[int] = set(int(c) for c in initial)
        self.crashed: dict[int, int] = {}  # cn -> clock of its restart

        eng = self.engine
        self.ownership = OwnershipTable(len(eng.tables), self.live,
                                        seed=sched.seed)
        self.epochs = ShardEpochs(len(eng.tables), n)
        self._n_tables = len(eng.tables)
        self._last_dir = list(eng.directory)

        self.caches = []
        self.routers = []
        self.cns = []
        for i in range(n):
            router = CNRouter(self, i)
            self.routers.append(router)
            inner = router
            if self.retry_plane is not None:
                inner = RetryLayer(inner, self.retry_plane,
                                   transport=self.transports[i],
                                   hub=self.hubs[i])
            cache = (CNKeyCache(sspec.cache_budget_bytes, device=device)
                     if sspec.cache_budget_bytes else None)
            self.caches.append(cache)
            if cache is not None:
                inner = CNCacheLayer(inner, cache, hub=self.hubs[i])
            inner = EpochGate(inner, self, i)
            inner = MeterLayer(inner, hub=self.hubs[i])
            self.cns.append(PipelineLayer(inner, policy=sspec.batch,
                                          transport=self.transports[i],
                                          hub=self.hubs[i]))

    # --------------------------------------------------------- topology
    @property
    def n_cns(self) -> int:
        return len(self.cns)

    @property
    def n_live(self) -> int:
        return len(self.live)

    @property
    def engine(self):
        return self.shared.engine

    def cn_active(self, cn: int) -> bool:
        return cn in self.live

    def owner_of(self, shard: int) -> int:
        return self.ownership.owner(shard)

    def shards_of(self, keys: np.ndarray) -> np.ndarray:
        """Vectorised key -> directory-shard routing (the engine's own
        extendible-hashing map, read without metering; hashed on the host
        with the numpy twin of the directory hash, so routing launches
        nothing)."""
        eng = self.engine
        lo, hi = split_u64(np.asarray(keys, dtype=np.uint64))
        e = (hash64_32_np(lo, hi, _DIR_SEED).astype(np.int64)
             & ((1 << eng.global_depth) - 1))
        return np.asarray(eng.directory, dtype=np.int64)[e]

    def cn_half_bytes(self, shard: int) -> int:
        """On-wire size of one shard's CN half: (num_buckets, seed-array
        length, othello length) header + DMPH seeds + both othello word
        arrays — the same payload §4.4's locator refetch meters."""
        return 8 + 8 + 8 + self.engine.tables[shard].cn.memory_bytes()

    # ------------------------------------------------------- accounting
    def meter_totals(self) -> CommMeter:
        m = self.shared.meter_totals()
        for led in self.ledgers:
            m.merge(led)
        return m

    def reset_meters(self) -> None:
        self.shared.reset_meters()
        for led in self.ledgers:
            led.reset()

    def mn_state(self) -> dict:
        return self.engine.mn_state()

    # -------------------------------------------------------- op clock
    def on_op(self, cn: int, n: int) -> None:
        """Advance the cluster op clock by ``n`` lanes and fire any due
        membership events (called by every CN's gate, pre-serve)."""
        self.clock += int(n)
        self._process_events()
        if self.retry_plane is not None and self.hubs[cn] is not None:
            # per-kind fault counters: each window counted once, on the
            # targeted CN's hub when the kind is CN-scoped
            for ev in self.retry_plane.new_window_events():
                tgt = (ev.cn if ev.kind in CN_TARGET_KINDS
                       and 0 <= ev.cn < len(self.hubs) else cn)
                self.hubs[tgt].count("faults", kind=ev.kind)

    def _process_events(self) -> None:
        # crash windows that just closed: the node restarts and rejoins
        for cn in [c for c, until in self.crashed.items()
                   if self.clock >= until]:
            del self.crashed[cn]
            self.live.add(cn)
            self._reconfigure("cn_restart", cn)
        while (self._next_ev < len(self._events)
               and self._events[self._next_ev].at_op <= self.clock):
            ev = self._events[self._next_ev]
            self._next_ev += 1
            self._apply_event(ev)
        while (self._next_part < len(self._partition_evs)
               and self._partition_evs[self._next_part].at_op <= self.clock):
            ev = self._partition_evs[self._next_part]
            self._next_part += 1
            self._on_partition(ev)

    def _apply_event(self, ev) -> None:
        if ev.kind == "join":
            if ev.cn in self.live:
                return
            self.live.add(ev.cn)
            self._reconfigure("join", ev.cn)
        elif ev.kind == "leave":
            if ev.cn not in self.live:
                return
            self.live.discard(ev.cn)
            self._reconfigure("leave", ev.cn)
        else:  # cn_crash
            if ev.cn not in self.live:
                return
            self.live.discard(ev.cn)
            self.crashed[ev.cn] = ev.at_op + ev.duration_ops
            self.transports[ev.cn].mark_fault("cn_crash", mn=ev.cn,
                                              down_s=ev.down_s)
            self._reconfigure("cn_crash", ev.cn)

    # ----------------------------------------------- partition fencing
    def _cut_links(self, cn: int, at: int) -> set:
        """MN replica indices whose link to ``cn`` is cut at op ``at``
        (computed from the schedule — host plane, no wire)."""
        cut: set[int] = set()
        for ev in self._partition_evs:
            if ev.cn == cn and ev.open_at(at):
                if ev.mn == -1:
                    cut.update(range(self._mn_pool_width))
                else:
                    cut.add(ev.mn)
        return cut

    def _on_partition(self, ev) -> None:
        """A partition window just opened.  If it leaves ``ev.cn`` with
        no route to *any* MN replica, the survivors arbitrate its shard
        leases away (rendezvous rebalance + fence bump) and the cut CN
        keeps routing from a frozen snapshot of the ownership table —
        the split-brain setup the fencing tokens exist to defuse."""
        if len(self._cut_links(ev.cn, ev.at_op)) < self._mn_pool_width:
            return  # partial cut: per-link backoff only, no arbitration
        if (ev.cn not in self.live or self.n_live <= 1
                or ev.cn in self.stale_views):
            return
        self.stale_views[ev.cn] = self.ownership.snapshot()
        self._reconfigure("partition", ev.cn,
                          live_set=self.live - {ev.cn})
        self.stats.partition_arbitrations += 1

    def cn_reachable(self, cn: int) -> bool:
        """True when CN ``cn`` has a live link to at least one MN
        replica (on the fault plane's clock, which runs with the engine
        calls — so reachability flips exactly when the wire does)."""
        if self.retry_plane is None:
            return True
        return not self.retry_plane.fully_partitioned(cn,
                                                      self._mn_pool_width)

    def heal_view(self, cn: int) -> None:
        """CN ``cn`` just had a write fenced: it refetches the ownership
        table (one small one-sided READ), drops its stale snapshot, and
        rejoins the ownership map — shards whose rendezvous winner it is
        come back with another fence bump, handoff-metered as usual."""
        self.ledgers[cn].add(1, rts=1, req=16, resp=MSG_BYTES,
                             one_sided=True)
        self.stats.view_syncs += 1
        del self.stale_views[cn]
        self._reconfigure("heal", cn)

    # ---------------------------------------------------------- handoff
    def _reconfigure(self, reason: str, cn: int, live_set=None) -> None:
        """DINOMO-style ownership handoff after a membership change.

        Rebalances the table over the new live set; each destination CN
        bulk-reads the CN half of just the shards it gained (one
        one-sided §4.4-shaped fetch: poll + bulk READ + FAA) and waits
        out the previous owner's lease before serving — the same drain
        ``ReplicaSetAdapter.failover`` charges.  Cost is O(shards
        moved); the key count never appears.  ``live_set`` overrides the
        target membership (partition arbitration hands a fully-cut CN's
        shards to ``live - {cn}`` while the CN itself stays notionally
        live so its post-heal calls reach the fencing check).
        """
        live = set(self.live if live_set is None else live_set)
        # CNs still fully cut keep their arbitrated-away state: don't
        # hand shards back to a node that cannot reach any replica
        still_cut = {c for c in self.stale_views if not self.cn_reachable(c)}
        if live - still_cut:
            live -= still_cut
        if not live:
            self.handoffs.append(HandoffEvent(self.clock, reason, cn, (), 0))
            return
        moved = self.ownership.rebalance(live)
        by_dst: dict[int, list] = {}
        for s, _old, new in moved:
            by_dst.setdefault(new, []).append(s)
        total = 0
        for dst in sorted(by_dst):
            shards = by_dst[dst]
            b = sum(self.cn_half_bytes(s) for s in shards)
            total += b
            led = self.ledgers[dst]
            led.add(1, rts=3, req=16, resp=b, one_sided=True)
            wait_us = self.spec.lease_wait_us
            if wait_us > 0:
                led.fault_wait_us += int(round(wait_us))
                self.transports[dst].add_wait(wait_us * 1e-6)
            hub = self.hubs[dst]
            if hub is not None:
                span = hub.begin_span("handoff", reason, len(shards),
                                      trigger=reason)
                span.annotate(shards=len(shards), bytes_moved=b,
                              from_event_cn=cn)
        self.stats.handoffs += 1
        self.stats.shards_moved += len(moved)
        self.stats.handoff_bytes += total
        self.handoffs.append(
            HandoffEvent(self.clock, reason, cn, tuple(moved), total))

    # -------------------------------------------------------- coherence
    def epoch_sync(self, cn: int, keys: np.ndarray) -> None:
        """Drop CN ``cn``'s cached entries for any shard it is behind on
        (runs above the cache layer, so a stale entry can never be
        served), then catch its seen-epochs up."""
        shards = self.shards_of(keys)
        stale = self.epochs.stale_shards(cn, shards)
        if stale.size == 0:
            return
        cache = self.caches[cn]
        if cache is not None:
            # the cache's entries are device lanes: the predicate routes
            # them on the cache's device, as the store's split sync does
            eng = self.engine
            stale_tbl = torch.zeros(len(eng.tables), dtype=torch.bool)
            stale_tbl[torch.from_numpy(np.asarray(stale, np.int64))] = True
            stale_tbl = stale_tbl.to(cache.device)
            dir_mask = (1 << eng.global_depth) - 1
            directory = torch.tensor(eng.directory, dtype=torch.int64,
                                     device=cache.device)

            def routed_to_stale(k_lo, k_hi):
                e = hash64_32(k_lo, k_hi, _DIR_SEED) & dir_mask
                return stale_tbl[directory[e]]

            self.stats.epoch_invalidations += \
                cache.invalidate_where(routed_to_stale)
        self.epochs.sync(cn, stale)

    def epoch_bump(self, cn: int, shards: np.ndarray) -> None:
        """CN ``cn`` completed a write touching ``shards``: multicast the
        invalidation epoch (piggybacked on the write's round trips —
        zero extra wire; other CNs apply it at their next epoch
        check)."""
        self.epochs.bump(cn, np.unique(np.asarray(shards, dtype=np.int64)))

    # ------------------------------------------------------ split sync
    def after_engine_call(self) -> None:
        """Extend ownership/epochs after §4.4 splits grew the directory.

        Successors inherit the parent's owner (the split rebuilt both
        halves at the owning CN), and start at epoch 0 with every CN
        current — the split's own sync point already invalidated every
        bound CN cache.
        """
        eng = self.engine
        n_new = len(eng.tables)
        if n_new == self._n_tables:
            return
        directory = list(eng.directory)
        old_dir = self._last_dir
        old_mask = len(old_dir) - 1
        for idx in range(self._n_tables, n_new):
            parent = None
            for e, tv in enumerate(directory):
                if tv == idx:
                    parent = old_dir[e & old_mask]
                    break
            if parent is None or parent >= len(self.ownership.owners):
                parent = 0  # unreachable table: park it on CN 0's owner
            self.ownership.extend_for_split(int(parent))
        self.epochs.grow(n_new)
        self._n_tables = n_new
        self._last_dir = directory


def cluster_of(spec, keys, values, *, n_cns: int | None = None,
               n_mns: int | None = None,
               membership: MembershipSchedule | None = None,
               lease_wait_us: float | None = None, device=None) -> Cluster:
    """Open a cluster from a :class:`ClusterSpec` or a plain
    :class:`StoreSpec` plus overrides (the registry-companion entry
    point: ``cluster_of(spec, keys, values, n_cns=8)``), on ``device``
    (CUDA unless the caller passes ``device="cpu"``)."""
    if isinstance(spec, ClusterSpec):
        cspec = spec
        if any(v is not None for v in (n_cns, n_mns, membership,
                                       lease_wait_us)):
            cspec = dataclasses.replace(
                cspec,
                n_cns=n_cns if n_cns is not None else cspec.n_cns,
                n_mns=n_mns if n_mns is not None else cspec.n_mns,
                membership=(membership if membership is not None
                            else cspec.membership),
                lease_wait_us=(lease_wait_us if lease_wait_us is not None
                               else cspec.lease_wait_us))
    else:
        cspec = ClusterSpec(
            store=spec, n_cns=n_cns if n_cns is not None else 1,
            n_mns=n_mns if n_mns is not None else 1,
            membership=membership,
            lease_wait_us=(lease_wait_us if lease_wait_us is not None
                           else 50.0))
    return Cluster(cspec, keys, values, device=device)


__all__ = ["CNRouter", "Cluster", "ClusterSpec", "ClusterStats", "EpochGate",
           "HandoffEvent", "SwitchingTransport", "cluster_of"]
