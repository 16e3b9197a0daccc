"""K-way replication of the memory-heavy MN component, with CN-driven
failover.

The port of ``repro.api.replication``, host logic over the port's engine
adapters: the same decisions, meter events and trace annotations, call for
call.  Each replica's MN arrays stay on the engine's device; a resync
ships a host image (``mn_state()`` → ``install_mn_state()``), as in the
reference.

Outback's split design makes replication cheap to reason about: the
compute-heavy locator lives on the CN, so replicating the store means
replicating only the **memory-heavy MN half** — slot arrays + ``seeds_mn``,
the KV heap, and the overflow cache (``OutbackShard.mn_state``).  The
:class:`ReplicaSetAdapter` here wraps K identically-built engine adapters
(same spec + rng seed ⇒ identical initial state; engine construction never
meters, so the trace stays clean) behind the ordinary ``KVStore`` surface:

* **Reads** go to the primary replica only (1 RT, unchanged profile).
* **Writes** are CN-driven multicast: the CN posts the mutation to every
  *live* replica (K wire ops — each replica's meter counts its copy, the
  honest cost of K-safety).  A write is **acknowledged iff applied at
  ≥ 1 live replica**, which with K ≥ 2 yields zero lost acknowledged
  writes: any single crash leaves a live copy of every acked write.
* **Crash windows** (``FaultPlane.crash_open``) make calls that need a
  dead replica answer whole-call ``"backoff"`` — no wire traffic, no state
  change — for the :class:`repro_torch.api.stack.RetryLayer` above to
  absorb (retry, jittered backoff, failover).
* **Restarts** are detected on the op clock: the first call after a
  replica's crash window closes re-installs the full MN image from a live
  replica (``install_mn_state``), charged as one one-sided bulk READ of
  ``mn_state_bytes`` — ownership moves in O(state shipped), not O(ops
  missed).
* **Leases** gate every use of a replica: the CN renews per
  ``FaultSchedule.lease_term_ops`` (one attached small RT, heartbeat
  style), and failover first waits out the dead primary's lease
  (``lease_wait_us``) so two CNs can never both believe they own writes.
  The same guard object is installed as the engines' ``lease`` hook so a
  Makeup-Get seed refresh — the one place a CN *learns* MN state —
  revalidates at the transport boundary.

Determinism: every decision comes from the :class:`repro_torch.net.faults`
oracle (op-clock windows + seeded draws); meter identity on the no-fault
path is byte-for-byte because a dormant plane never fires and all
failure-plane meter fields default to zero.  A telemetry hub (``hub``,
set by ``CNStack.assemble``) counts fault windows, fault waits, resyncs,
failovers and per-replica write lanes, as the reference's does.
"""

from __future__ import annotations

import numpy as np

from repro_torch.api.protocol import OpResult, status_result
from repro_torch.core.meter import MSG_BYTES, CommMeter
from repro_torch.core.store import _dir_hash
from repro_torch.net.faults import FaultPlane, _mix64

BACKOFF = "backoff"
UNAVAILABLE = "unavailable"


def backoff_result(n: int) -> OpResult:
    """A whole-call BACKOFF answer: nothing found, nothing changed."""
    return status_result((BACKOFF,) * int(n), np.zeros(int(n), bool))


def is_backoff(res: OpResult) -> bool:
    """True when a result is a retryable whole-call BACKOFF answer."""
    return res.statuses is not None and len(res.statuses) > 0 \
        and res.statuses[0] == BACKOFF


class ShardLease:
    """The engines' ``lease`` hook: revalidate before trusting MN state.

    Installed on every Outback table of every replica; fires when a
    Makeup-Get is about to refresh CN-cached seeds from MN memory.  If
    the lease on that replica is due, one small two-sided RT is attached
    to the op being served (heartbeat piggyback) and the grant recorded
    — at most one renewal per op-clock tick, so the scalar and batched
    makeup paths meter identically.
    """

    def __init__(self, plane: FaultPlane, mn: int):
        self.plane = plane
        self.mn = mn

    def on_seed_refresh(self, shard) -> None:
        if self.plane.lease_due(self.mn):
            shard.meter.add(0, rts=1, req=MSG_BYTES, resp=MSG_BYTES,
                            attach=True)
            shard.meter.lease_renewals += 1
            self.plane.lease_granted(self.mn)


class ReplicaPlacement:
    """Seeded per-shard replica sets over the MN pool (HRW placement).

    FlexKV's per-shard flexibility applied to replication (PAPERS.md):
    instead of mirroring the whole MN image onto K deterministic twins,
    each *directory shard* is placed on ``k`` of the ``n_mns`` replicas
    by rendezvous hashing — deterministic, coordination-free, and
    minimal.  An MN crash then degrades only the shards placed there,
    and resync ships only those shards' MN halves
    (``OutbackShard.mn_state``), not the full image.

    §4.4 split successors inherit the parent's member set (the split
    rebuilt both halves from data living on the parent's members), so
    key->member routing through *any* replica's directory stays correct
    even before the placement table learns about the child.
    """

    def __init__(self, n_shards: int, n_mns: int, k: int,
                 seed: int = 0) -> None:
        if not 1 <= k <= n_mns:
            raise ValueError(f"placement needs 1 <= k <= n_mns, "
                             f"got k={k}, n_mns={n_mns}")
        self.n_mns = int(n_mns)
        self.k = int(k)
        self.seed = int(seed)
        self._members = [self._place(s) for s in range(int(n_shards))]

    def _place(self, shard: int) -> tuple:
        ranked = sorted(range(self.n_mns),
                        key=lambda m: _mix64(self.seed, 0x9CE, shard, m),
                        reverse=True)
        return tuple(ranked[:self.k])

    def __len__(self) -> int:
        return len(self._members)

    def members(self, shard: int) -> tuple:
        """The ``k`` MN replicas hosting ``shard``, preference-ordered."""
        return self._members[shard]

    def shards_on(self, mn: int) -> list:
        """Every shard placed on replica ``mn`` (the resync set)."""
        return [s for s, ms in enumerate(self._members) if mn in ms]

    def extend_for_split(self, parent: int) -> None:
        """A §4.4 split appended a successor: it inherits the parent's
        member set (no cross-MN bytes move at split time)."""
        self._members.append(self._members[parent])


class ReplicaSetAdapter:
    """K identically-built adapters behind one ``KVStore`` surface.

    Sits where a single engine adapter would in the stack (below the
    retry stage); ``.engine`` resolves to the current primary's engine so
    benchmarks keep timing internals.  ``meter_totals`` merges the CN-side
    ledger with every replica's meters (the ``ShardedAdapter`` precedent),
    so multicast writes honestly report K× wire cost.

    With a :class:`ReplicaPlacement` the set runs in **per-shard mode**:
    reads route to a shard's first usable member, writes multicast to
    its member set only, and resync ships only the placed shards' MN
    halves.  ``cn_source`` (a callable returning the calling compute
    node's id; the cluster plane points it at its transport switch)
    scopes ``partition`` / ``cn_delay`` / ``cn_drop`` windows to the CN
    actually issuing the call.
    """

    def __init__(self, replicas: list, spec, plane: FaultPlane,
                 transport=None, placement: ReplicaPlacement | None = None):
        if not replicas:
            raise ValueError("need at least one replica")
        self.replicas = list(replicas)
        self.spec = spec
        self.plane = plane
        self.transport = transport
        self.placement = placement
        self.cn_source = None   # callable () -> calling CN id; None -> 0
        self.primary = 0
        # telemetry hub (pure observer); CNStack.assemble assigns it when
        # the spec carries a TelemetryConfig — every use below is guarded.
        self.hub = None
        self._meter = CommMeter()  # CN-side ledger (fault attribution)
        self._needs_resync: set[int] = set()
        self._install_leases()
        if placement is not None:
            eng = self.replicas[0].engine
            self._n_tables = len(eng.tables)
            self._last_dir = list(eng.directory)

    # ----------------------------------------------------- uniform surface
    @property
    def kind(self):
        return self.replicas[0].kind

    @property
    def verifies_keys(self):
        return self.replicas[0].verifies_keys

    @property
    def cache_hit_savings(self):
        return self.replicas[0].cache_hit_savings

    @property
    def cache_neg_savings(self):
        return self.replicas[0].cache_neg_savings

    @property
    def engine(self):
        return self.replicas[self.primary].engine

    @property
    def telemetry(self):
        """The stack's ``repro_torch.obs.TelemetryHub``, or ``None``."""
        return self.hub

    @property
    def meter(self) -> CommMeter:
        return self._meter

    def meter_totals(self) -> CommMeter:
        m = CommMeter()
        m.merge(self._meter)
        for r in self.replicas:
            m.merge(r.meter_totals())
        return m

    def reset_meters(self) -> None:
        self._meter.reset()
        for r in self.replicas:
            r.reset_meters()

    def bind_cache(self, cache) -> None:
        for r in self.replicas:
            r.bind_cache(cache)

    # ------------------------------------------------------- fault machinery
    def _install_leases(self) -> None:
        """Hang a ShardLease off every replica engine that supports it."""
        if self.plane.schedule.lease_term_ops <= 0:
            return
        for i, r in enumerate(self.replicas):
            guard = ShardLease(self.plane, i)
            eng = r.engine
            if hasattr(eng, "set_lease"):        # directory store
                eng.set_lease(guard)
            elif hasattr(eng, "lease"):          # single shard
                eng.lease = guard

    def _live(self) -> list[int]:
        return [i for i in range(len(self.replicas))
                if not self.plane.crash_open(i)]

    def _cn(self) -> int:
        """The compute node issuing the current call (0 outside a
        cluster); scopes partition / cn_delay / cn_drop windows."""
        return 0 if self.cn_source is None else int(self.cn_source())

    def _usable(self, i: int, cn: int) -> bool:
        """Can CN ``cn`` serve from replica ``i`` right now?  Requires
        the replica alive, the link up, and no pending resync (a replica
        that missed writes must never answer)."""
        return (not self.plane.crash_open(i)
                and not self.plane.partition_open(cn, i)
                and i not in self._needs_resync)

    def _pre_call(self, n: int) -> int:
        """Per-protocol-call housekeeping on the op clock.

        Advances the clock, announces newly-opened crash/NIC/partition
        windows to the trace (FaultMarks), applies open delay windows as a
        CN-side wait, and resyncs any replica whose crash/partition window
        just closed.  Returns the calling CN id.
        """
        self.plane.tick(max(1, int(n)))
        cn = self._cn()
        if self.transport is not None:
            for ev in self.plane.new_marks():
                if ev.kind == "partition":
                    self.transport.mark_fault("partition", mn=ev.mn,
                                              down_s=ev.down_s, cn=ev.cn)
                else:
                    self.transport.mark_fault(ev.kind,
                                              mn=ev.mn % len(self.replicas),
                                              down_s=ev.down_s,
                                              factor=ev.factor)
        if self.hub is not None:
            for ev in self.plane.new_window_events():
                self.hub.count("faults", kind=ev.kind)
        for i in range(len(self.replicas)):
            if self.plane.crash_open(i):
                self._needs_resync.add(i)
                self.plane.lease_revoked(i)  # a dead MN's lease lapses
        d_us = self.plane.delay_us(cn)
        if d_us > 0:
            self._charge_wait(d_us)
        live_reach = [i for i in self._live()
                      if not self.plane.partition_open(cn, i)]
        if live_reach and all(i in self._needs_resync for i in live_reach):
            # every reachable replica missed writes (overlapping outages):
            # deterministically crown the lowest-indexed one the authority
            # so resync can make progress instead of livelocking.
            self._needs_resync.discard(live_reach[0])
        for i in sorted(self._needs_resync):
            if not self.plane.crash_open(i) \
                    and not self.plane.partition_open(cn, i):
                if self._resync(i):
                    self._needs_resync.discard(i)
        return cn

    def _charge_wait(self, wait_us: float) -> None:
        self._meter.fault_wait_us += int(round(wait_us))
        if self.transport is not None:
            self.transport.add_wait(wait_us * 1e-6)
        if self.hub is not None:
            self.hub.hist("replica.fault_wait_us").record(wait_us)
            self.hub.annotate(fault_wait_us=wait_us)

    def _resync(self, i: int) -> bool:
        """Re-install replica ``i``'s MN half from a live replica.

        Charged as one one-sided bulk READ of the state image (the
        restarted MN pulls from a peer, DINOMO-style); the CN then treats
        the replica as live again.  Under a :class:`ReplicaPlacement`
        only the shards placed on ``i`` are shipped, each from a live
        member of its own set.  Returns True when the replica is synced
        (defer — False — while no donor is reachable); a single-replica
        deployment has nothing to copy and is trivially synced.
        """
        if len(self.replicas) == 1:
            return True
        cn = self._cn()
        donors = [j for j in self._live()
                  if j != i and j not in self._needs_resync
                  and not self.plane.partition_open(cn, j)]
        if not donors:
            return False  # nobody to copy from yet; retry on a later call
        dst = self.replicas[i].engine
        if self.placement is not None:
            shards = self.placement.shards_on(i)
            pairs = []
            total = 0
            for s in shards:
                d = next((m for m in self.placement.members(s)
                          if m in donors), None)
                if d is None:
                    return False  # a placed shard has no live donor yet
                src = self.replicas[d].engine
                if len(src.tables) != len(dst.tables):
                    raise RuntimeError(
                        "hrw placement cannot per-shard resync after a "
                        "directory split diverged replica table numbering;"
                        " size the store so splits cannot fire, or use "
                        "placement='twins'")
                pairs.append((s, src))
                total += int(src.tables[s].mn_state_bytes())
            for s, src in pairs:
                dst.tables[s].install_mn_state(src.tables[s].mn_state())
            state_bytes = total
        else:
            src = self.replicas[donors[0] if self.primary not in donors
                                else self.primary].engine
            dst.install_mn_state(src.mn_state())
            state_bytes = int(src.mn_state_bytes())
        if self.transport is not None:
            self.transport.current_mn = i
        self.replicas[i].meter.add(1, rts=1, req=16, resp=state_bytes,
                                   one_sided=True)
        if self.transport is not None:
            self.transport.current_mn = 0
        self._meter.resyncs += 1
        if self.hub is not None:
            self.hub.count("replica.resyncs", mn=i)
            self.hub.count("replica.resync_bytes", state_bytes, mn=i)
            self.hub.annotate(resyncs=1, resync_bytes=state_bytes)
        return True

    def _lease_check(self, i: int) -> None:
        """Transport-boundary lease gate: renew before using replica ``i``."""
        if self.plane.lease_due(i):
            r = self.replicas[i]
            r.meter.add(0, rts=1, req=MSG_BYTES, resp=MSG_BYTES, attach=True)
            r.meter.lease_renewals += 1
            self._meter.lease_renewals += 1
            self.plane.lease_granted(i)

    # ------------------------------------------------------------- failover
    def can_failover(self) -> bool:
        """Any live replica other than the current primary?  Per-shard
        placement has no global primary to move — reads already route
        around dead members — so it never fails over."""
        if self.placement is not None:
            return False
        return any(i != self.primary for i in self._live())

    def failover(self) -> bool:
        """Switch reads to the next live replica (CN-driven).

        Waits out the dead primary's lease first (``lease_wait_us`` —
        conservative full drain so no two owners coexist), revokes it,
        and moves the primary cursor.  The new primary's lease is granted
        by the next call's :meth:`_lease_check`.  Returns False when no
        live replica exists (the retry stage keeps backing off).
        """
        live = [i for i in self._live() if i != self.primary]
        if not live:
            return False
        nxt = min(live)
        if self.plane.schedule.lease_term_ops > 0:
            self._charge_wait(self.plane.schedule.lease_wait_us)
        self.plane.lease_revoked(self.primary)
        self.primary = nxt
        self._meter.failovers += 1
        if self.hub is not None:
            self.hub.count("replica.failovers")
            self.hub.annotate(failovers=1, failover_to=f"mn{nxt}")
        return True

    # ------------------------------------------------------------ internals
    def _serve_read(self, n: int, call) -> OpResult:
        """Route a read to the primary; BACKOFF when it is dead/dropped
        or its link from the calling CN is partitioned."""
        cn = self._pre_call(n)
        p = self.primary
        if not self._usable(p, cn):
            self._meter.backoffs += n
            return backoff_result(n)
        if self.plane.drop_now(cn):
            self._meter.drops += n
            self._meter.backoffs += n
            return backoff_result(n)
        self._lease_check(p)
        if self.transport is not None:
            self.transport.current_mn = p
        try:
            return call(self.replicas[p])
        finally:
            if self.transport is not None:
                self.transport.current_mn = 0

    def _serve_write(self, n: int, call) -> OpResult:
        """Multicast a mutation to every reachable live replica.

        The answer comes from the lowest-indexed reachable replica
        (replicas are deterministic twins, so any live copy answers
        identically); dead replicas are marked for resync, and so is any
        live replica the calling CN's partition hides — it missed this
        write and must not serve until repaired.  Acknowledged ⇔ applied
        at ≥ 1 reachable live replica.
        """
        cn = self._pre_call(n)
        usable = [i for i in self._live() if i not in self._needs_resync]
        reach = [i for i in usable
                 if not self.plane.partition_open(cn, i)]
        if not reach:
            self._meter.backoffs += n
            return backoff_result(n)
        if self.plane.drop_now(cn):
            self._meter.drops += n
            self._meter.backoffs += n
            return backoff_result(n)
        for i in usable:
            if i not in reach:
                self._needs_resync.add(i)   # cut link: missed this write
        self._lease_check(reach[0])
        if self.hub is not None:
            for i in reach:
                self.hub.count("replica.write_lanes", n, mn=i)
            self.hub.annotate(write_replicas=len(reach))
        res = None
        try:
            for i in reach:
                if self.transport is not None:
                    self.transport.current_mn = i
                r = call(self.replicas[i])
                if i == reach[0]:
                    res = r
        finally:
            if self.transport is not None:
                self.transport.current_mn = 0
        return res

    # ------------------------------------------------- per-shard placement
    def _shards_of(self, keys: np.ndarray) -> np.ndarray:
        """Key -> directory-shard routing through replica 0's directory
        (CN-side math, never metered).  Split successors inherit their
        parent's member set, so any replica's directory yields the
        correct members even when table numbering has not caught up."""
        eng = self.replicas[0].engine
        e = _dir_hash(keys) & ((1 << eng.global_depth) - 1)
        return np.asarray(eng.directory, dtype=np.int64)[e]

    def _placement_shard(self, s: int) -> int:
        """Clamp a shard id the placement table has not grown to yet
        (split child seen before ``_after_placed_write``) onto a valid
        entry; the child inherits the parent's members, and parents are
        always in range."""
        return s if s < len(self.placement) else self._parent_of(s)

    def _parent_of(self, s: int) -> int:
        eng = self.replicas[0].engine
        old_dir, old_mask = self._last_dir, len(self._last_dir) - 1
        for e, tv in enumerate(eng.directory):
            if tv == s:
                p = old_dir[e & old_mask]
                if p < len(self.placement):
                    return int(p)
        return 0

    def _after_placed_write(self) -> None:
        """Extend the placement table after §4.4 splits grew replica 0's
        directory (successors inherit the parent's member set)."""
        eng = self.replicas[0].engine
        n_new = len(eng.tables)
        if n_new == self._n_tables:
            return
        directory = list(eng.directory)
        old_dir, old_mask = self._last_dir, len(self._last_dir) - 1
        for idx in range(self._n_tables, n_new):
            parent = 0
            for e, tv in enumerate(directory):
                if tv == idx:
                    parent = old_dir[e & old_mask]
                    break
            self.placement.extend_for_split(
                int(parent) if parent < len(self.placement) else 0)
        self._n_tables = n_new
        self._last_dir = directory

    def _merge_groups(self, n: int, groups) -> OpResult:
        """Reassemble per-replica sub-results into one lane-ordered
        OpResult (the reference cluster plane's ``_dispatch_pooled`` idiom)."""
        if len(groups) == 1 and len(groups[0][0]) == n:
            return groups[0][1]
        out_v = np.zeros(n, np.uint64)
        out_f = np.zeros(n, bool)
        statuses: list | None = None
        for idx, sub in groups:
            out_v[idx] = sub.values
            out_f[idx] = sub.found
            if sub.statuses is not None:
                if statuses is None:
                    statuses = ["ok"] * n
                for pos, st in zip(idx, sub.statuses):
                    statuses[pos] = st
        return OpResult(values=out_v, found=out_f,
                        statuses=None if statuses is None
                        else tuple(statuses))

    def _placed_read(self, keys: np.ndarray, subcall) -> OpResult:
        """Per-shard read routing: each lane goes to the first usable
        member of its shard's replica set; a lane with no usable member
        degrades the whole call to BACKOFF (state-safe to retry)."""
        keys = np.asarray(keys, dtype=np.uint64)
        n = len(keys)
        cn = self._pre_call(n)
        if self.plane.drop_now(cn):
            self._meter.drops += n
            self._meter.backoffs += n
            return backoff_result(n)
        shards = self._shards_of(keys)
        srv_of: dict[int, int] = {}
        for s in np.unique(shards):
            ms = self.placement.members(self._placement_shard(int(s)))
            srv = next((m for m in ms if self._usable(m, cn)), -1)
            if srv < 0:
                self._meter.backoffs += n
                return backoff_result(n)
            srv_of[int(s)] = srv
        servers = np.asarray([srv_of[int(s)] for s in shards],
                             dtype=np.int64)
        groups = []
        try:
            for r in np.unique(servers):
                idx = np.flatnonzero(servers == r)
                self._lease_check(int(r))
                if self.transport is not None:
                    self.transport.current_mn = int(r)
                groups.append((idx, subcall(self.replicas[int(r)],
                                            keys[idx])))
        finally:
            if self.transport is not None:
                self.transport.current_mn = 0
        return self._merge_groups(n, groups)

    def _placed_write(self, keys: np.ndarray, values, subcall) -> OpResult:
        """Per-shard write multicast: each lane is applied at every
        reachable member of its shard's replica set, answered by the
        lowest-indexed one.  If any lane's member set is entirely
        unreachable the whole call backs off *before* anything applies
        (retries stay state-safe); members hidden by a partition are
        marked for resync — they missed the write.
        """
        keys = np.asarray(keys, dtype=np.uint64)
        n = len(keys)
        cn = self._pre_call(n)
        if self.plane.drop_now(cn):
            self._meter.drops += n
            self._meter.backoffs += n
            return backoff_result(n)
        shards = self._shards_of(keys)
        vals = None if values is None else np.asarray(values, np.uint64)
        plans = []      # (lane_idx, members, reachable_members)
        missed: set[int] = set()
        for s in np.unique(shards):
            ms = self.placement.members(self._placement_shard(int(s)))
            reach = [m for m in ms if self._usable(m, cn)]
            if not reach:
                self._meter.backoffs += n
                return backoff_result(n)
            missed.update(m for m in ms
                          if m not in reach
                          and not self.plane.crash_open(m))
            plans.append((np.flatnonzero(shards == s), ms, reach))
        self._needs_resync.update(missed)
        groups = []
        try:
            for idx, _ms, reach in plans:
                self._lease_check(reach[0])
                if self.hub is not None:
                    for m in reach:
                        self.hub.count("replica.write_lanes", len(idx),
                                       mn=m)
                sub = None
                for m in reach:
                    if self.transport is not None:
                        self.transport.current_mn = m
                    r = subcall(self.replicas[m], keys[idx],
                                None if vals is None else vals[idx])
                    if m == reach[0]:
                        sub = r
                groups.append((idx, sub))
        finally:
            if self.transport is not None:
                self.transport.current_mn = 0
        self._after_placed_write()
        return self._merge_groups(n, groups)

    # ------------------------------------------------------------- protocol
    def get(self, key: int) -> OpResult:
        if self.placement is not None:
            return self._placed_read(
                np.asarray([key], np.uint64),
                lambda r, ks: r.get(int(ks[0])))
        return self._serve_read(1, lambda r: r.get(key))

    def get_batch(self, keys, *,
                  resolve_makeup: bool | None = None) -> OpResult:
        if self.placement is not None:
            return self._placed_read(
                keys, lambda r, ks: r.get_batch(
                    ks, resolve_makeup=resolve_makeup))
        return self._serve_read(
            len(keys), lambda r: r.get_batch(keys,
                                             resolve_makeup=resolve_makeup))

    def insert(self, key: int, value: int) -> OpResult:
        if self.placement is not None:
            return self._placed_write(
                np.asarray([key], np.uint64), np.asarray([value], np.uint64),
                lambda r, ks, vs: r.insert(int(ks[0]), int(vs[0])))
        return self._serve_write(1, lambda r: r.insert(key, value))

    def update(self, key: int, value: int) -> OpResult:
        if self.placement is not None:
            return self._placed_write(
                np.asarray([key], np.uint64), np.asarray([value], np.uint64),
                lambda r, ks, vs: r.update(int(ks[0]), int(vs[0])))
        return self._serve_write(1, lambda r: r.update(key, value))

    def delete(self, key: int) -> OpResult:
        if self.placement is not None:
            return self._placed_write(
                np.asarray([key], np.uint64), None,
                lambda r, ks, vs: r.delete(int(ks[0])))
        return self._serve_write(1, lambda r: r.delete(key))

    def insert_batch(self, keys, values) -> OpResult:
        if self.placement is not None:
            return self._placed_write(
                keys, values, lambda r, ks, vs: r.insert_batch(ks, vs))
        return self._serve_write(
            len(keys), lambda r: r.insert_batch(keys, values))

    def update_batch(self, keys, values) -> OpResult:
        if self.placement is not None:
            return self._placed_write(
                keys, values, lambda r, ks, vs: r.update_batch(ks, vs))
        return self._serve_write(
            len(keys), lambda r: r.update_batch(keys, values))

    def delete_batch(self, keys) -> OpResult:
        if self.placement is not None:
            return self._placed_write(
                keys, None, lambda r, ks, vs: r.delete_batch(ks))
        return self._serve_write(
            len(keys), lambda r: r.delete_batch(keys))


__all__ = ["BACKOFF", "UNAVAILABLE", "ReplicaPlacement", "ReplicaSetAdapter",
           "ShardLease", "backoff_result", "is_backoff"]
