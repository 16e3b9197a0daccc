"""The CN-side stack: ``Pipeline → Meter → [CNCache →] [Retry →]
adapter (→ Transport)``.

The port of ``repro.api.stack``: the meter, CN-cache and retry stages, the
transport binding and the composition root, each with the reference's
telemetry hooks (a ``repro_torch.obs.TelemetryHub`` passed as ``hub``;
``None`` keeps the plane dormant).  The hooks read only what a stage
already holds on the host: they add no device op and no host-device copy.

* **Meter** (:class:`MeterLayer`) — stamps per-call attribution (round
  trips, wire bytes, Makeup-Get continuations, cache hits, retries,
  backoffs, failovers) onto every ``OpResult`` from the store's merged
  meter deltas.
* **CNCache** (:class:`CNCacheLayer`) — the hot-key front
  (``repro_torch.core.cn_cache``): probe on the device before the wire,
  answer hits locally, forward misses with full Makeup-Get resolution (the
  cache only learns resolved truths, never a degraded answer), keep
  coherence on every mutation, and join the engine's split-time
  invalidation via ``adapter.bind_cache``.
* **Retry** (:class:`RetryLayer`) — the recovery stage above a
  ``repro_torch.api.replication.ReplicaSetAdapter``: it absorbs the
  ``"backoff"`` answers the set gives while an MN replica is down or a
  request was dropped (timeout + seeded jittered backoff), fails over
  after ``failover_after`` dead-primary rounds, and answers
  ``"unavailable"`` once the retry budget is spent (answer, never block).
* **Pipeline** (``repro_torch.api.pipeline.PipelineLayer``) — the
  submission/completion plane, outermost; it opens a doorbell window in
  the bound transport's trace around each flush of a ``window > 1``
  policy.  In-flight ``OpHandle``s resolve *through* a failover.
* **Transport** (innermost, :class:`TransportBinding`) — a
  ``repro_torch.net.Transport`` plugged into every engine meter's ``sink``
  at construction (the factories pass it down, so split successors
  inherit it), so the op stream replays on the simulated RDMA clock.
  Cache hits never reach the trace.

For Outback kinds the cache layer charges the same ``CACHE_*_SAVINGS``
into the same engine meter as a store built with an internal cache
(``cn_cache=`` / ``cn_cache_budget_bytes=``), so the two report identical
totals; each baseline's adapter declares its own protocol's savings.

:class:`StoreLayer` forwards the protocol's members (``spec``,
``telemetry``, ``meter``, the ops, the meter accessors, ``bind_cache``
and the ``sharded`` kind's ``mesh_state``) as real attributes and
methods, not through ``__getattr__``, so a layer satisfies the
runtime-checkable ``KVStore`` protocol under Python 3.12's static member
lookup.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.protocol import OpResult
from repro_torch.api.replication import UNAVAILABLE, is_backoff
from repro_torch.core.cn_cache import CNKeyCache
from repro_torch.core.hashing import split_u64

_M32 = np.uint64(0xFFFFFFFF)
_NOT_APPLIED = ("frozen", "backoff", "unavailable")


class StoreLayer:
    """Base middleware: wraps an inner KVStore and forwards each protocol
    member to it explicitly; subclasses override the ops they change."""

    hub = None  # the stack's TelemetryHub, on the layers that carry one

    def __init__(self, inner):
        self.inner = inner
        self.spec = inner.spec
        # the stack's CN hot-key cache (a CNCacheLayer's), or None
        self.cache = getattr(inner, "cache", None)

    # ------------------------------------------------ forwarded attributes
    @property
    def telemetry(self):
        """The stack's ``repro_torch.obs.TelemetryHub``, or ``None`` (the
        dormant plane)."""
        return self.hub if self.hub is not None else self.inner.telemetry

    @property
    def engine(self):
        return self.inner.engine

    @property
    def meter(self):
        return self.inner.meter

    @property
    def verifies_keys(self) -> bool:
        """False for a kind whose Gets do not read stored data back
        (dummy): callers skip answer checks against their oracle."""
        return self.inner.verifies_keys

    @property
    def cache_hit_savings(self) -> dict:
        return self.inner.cache_hit_savings

    @property
    def cache_neg_savings(self) -> dict:
        return self.inner.cache_neg_savings

    # ------------------------------------------------------ forwarded ops
    def get_batch(self, keys, *, resolve_makeup: bool | None = None):
        return self.inner.get_batch(keys, resolve_makeup=resolve_makeup)

    def insert_batch(self, keys, values) -> OpResult:
        return self.inner.insert_batch(keys, values)

    def update_batch(self, keys, values) -> OpResult:
        return self.inner.update_batch(keys, values)

    def delete_batch(self, keys) -> OpResult:
        return self.inner.delete_batch(keys)

    def get(self, key: int) -> OpResult:
        return self.inner.get(key)

    def insert(self, key: int, value: int) -> OpResult:
        return self.inner.insert(key, value)

    def update(self, key: int, value: int) -> OpResult:
        return self.inner.update(key, value)

    def delete(self, key: int) -> OpResult:
        return self.inner.delete(key)

    def meter_totals(self):
        return self.inner.meter_totals()

    def reset_meters(self) -> None:
        self.inner.reset_meters()

    def bind_cache(self, cache) -> None:
        """Join the engine's split-time cache invalidation (a
        ``CNCacheLayer`` above this one calls it)."""
        self.inner.bind_cache(cache)

    def mesh_state(self):
        """The ``sharded`` kind's stacked state with every mutated shard
        re-installed (``ShardedAdapter.mesh_state``); other kinds have
        none and raise ``AttributeError``."""
        return self.inner.mesh_state()


class RetryLayer(StoreLayer):
    """BACKOFF/retry stage: the recovery protocol above a replica set.

    Wraps every protocol op in a retry loop: a ``"backoff"`` answer (the
    serving MN is crashed, or the request was dropped on the wire) costs
    one completion timeout plus a seeded jittered backoff
    (``FaultPlane.backoff_us`` — deterministic, replayable), charged to
    the meter as ``fault_wait_us`` and to the trace as a posting stall on
    the retried op.  After ``failover_after`` rounds against a *crashed*
    primary the layer drives ``inner.failover()``; once ``max_retries``
    rounds are spent it answers degraded — ``"unavailable"`` statuses,
    ``found=False``, no exception, no state change — so callers (and
    pipelined ``OpHandle``s) always resolve.  On the no-fault path the
    wrap is a pure pass-through: no meter event, no trace event.
    """

    def __init__(self, inner, plane, transport=None, hub=None):
        super().__init__(inner)
        self.plane = plane
        self.transport = transport
        self.hub = hub

    def _with_retry(self, n: int, call) -> OpResult:
        res = call()
        if not is_backoff(res):
            return res
        sched = self.plane.schedule
        meter = self.inner.meter
        hub = self.hub
        for attempt in range(sched.max_retries):
            wait_us = sched.timeout_us + self.plane.backoff_us(attempt)
            meter.fault_wait_us += int(round(wait_us))
            if self.transport is not None:
                self.transport.add_wait(wait_us * 1e-6)
            if hub is not None:
                hub.count("retry.backoff_rounds")
                hub.hist("retry.backoff_wait_us").record(int(round(wait_us)))
                hub.annotate(backoff_rounds=1,
                             backoff_wait_us=int(round(wait_us)))
            if (attempt + 1 >= sched.failover_after
                    and self.plane.crash_open(self.inner.primary)
                    and self.inner.can_failover()):
                self.inner.failover()
            meter.retries += n
            res = call()
            if not is_backoff(res):
                return res
        if hub is not None:
            hub.count("retry.unavailable_lanes", n)
            hub.annotate(unavailable_lanes=n)
        return OpResult(values=np.zeros(n, np.uint64),
                        found=np.zeros(n, bool),
                        statuses=(UNAVAILABLE,) * n)

    def get(self, key: int) -> OpResult:
        return self._with_retry(1, lambda: self.inner.get(key))

    def get_batch(self, keys, *,
                  resolve_makeup: bool | None = None) -> OpResult:
        return self._with_retry(len(keys), lambda: self.inner.get_batch(
            keys, resolve_makeup=resolve_makeup))

    def insert(self, key: int, value: int) -> OpResult:
        return self._with_retry(1, lambda: self.inner.insert(key, value))

    def update(self, key: int, value: int) -> OpResult:
        return self._with_retry(1, lambda: self.inner.update(key, value))

    def delete(self, key: int) -> OpResult:
        return self._with_retry(1, lambda: self.inner.delete(key))

    def insert_batch(self, keys, values) -> OpResult:
        return self._with_retry(
            len(keys), lambda: self.inner.insert_batch(keys, values))

    def update_batch(self, keys, values) -> OpResult:
        return self._with_retry(
            len(keys), lambda: self.inner.update_batch(keys, values))

    def delete_batch(self, keys) -> OpResult:
        return self._with_retry(
            len(keys), lambda: self.inner.delete_batch(keys))


class CNCacheLayer(StoreLayer):
    """CN hot-key cache stage: hits answered locally, misses forwarded
    with Makeup-Get resolution, coherence kept on every mutation.

    Cache accounting lands in the *engine's* meter (``inner.meter``) so a
    stack-built store and one with an internal cache report identical
    totals, and ``saved_*`` attribution stays next to the wire counters it
    offsets.  The probe runs on the cache's device; the answers come to the
    host as an ``OpResult``, and the hub's hit/miss counts come from that
    host copy."""

    def __init__(self, inner, cache: CNKeyCache, hub=None):
        super().__init__(inner)
        self.cache = cache
        self.hub = hub
        inner.bind_cache(cache)  # engine-side sync points (resize)

    # ---------------------------------------------------------------- gets
    def get(self, key: int) -> OpResult:
        meter = self.inner.meter
        state, val = self.cache.lookup(int(key))
        if state == "hit":
            meter.add_cache_hit(1, **self.inner.cache_hit_savings)
            if self.hub is not None:
                self.hub.on_cache(1, 0, 0)
                self.hub.annotate(cache_hits=1)
            return OpResult(values=np.asarray([val], np.uint64),
                            found=np.asarray([True]))
        if state == "neg":
            meter.add_cache_hit(1, neg=True, **self.inner.cache_neg_savings)
            if self.hub is not None:
                self.hub.on_cache(0, 1, 0)
                self.hub.annotate(cache_neg_hits=1)
            return OpResult(values=np.zeros(1, np.uint64),
                            found=np.asarray([False]))
        if self.hub is not None:
            self.hub.on_cache(0, 0, 1)
        res = self.inner.get(key)
        if res.statuses is None:  # degraded answers teach the cache nothing
            self.cache.fill(int(key), res.value)
        return res

    def get_batch(self, keys, *,
                  resolve_makeup: bool | None = None) -> OpResult:
        keys = np.asarray(keys, dtype=np.uint64)
        lo, hi = split_u64(keys)
        hit_t, neg_t, c_vlo, c_vhi = self.cache.probe_batch(lo, hi)
        host = torch.stack([hit_t.to(torch.int32), neg_t.to(torch.int32),
                            c_vlo, c_vhi]).cpu().numpy()  # one copy
        hit, neg = host[0] != 0, host[1] != 0
        # charge the savings the avoided Get would have cost on THIS
        # kind's wire (the adapter declares its protocol's shape)
        meter = self.inner.meter
        meter.add_cache_hit(int(hit.sum()), **self.inner.cache_hit_savings)
        meter.add_cache_hit(int(neg.sum()), neg=True,
                            **self.inner.cache_neg_savings)
        if self.hub is not None:
            n_hit, n_neg = int(hit.sum()), int(neg.sum())
            n_miss = len(keys) - n_hit - n_neg
            self.hub.on_cache(n_hit, n_neg, n_miss)
            self.hub.annotate(cache_hits=n_hit, cache_neg_hits=n_neg,
                              cache_misses=n_miss)
        c_v = host[2:].view(np.uint32).astype(np.uint64)
        values = (c_v[1] << np.uint64(32)) | c_v[0]
        found = hit.copy()
        miss = ~hit & ~neg
        if miss.any():
            # default: misses go down the stack with the full §4.3.1
            # resolution so the cache (and the caller) only ever learn
            # resolved truths; an explicit False is honoured (raw 1-RT
            # stream)
            if resolve_makeup is None:
                resolve_makeup = True
            sub = self.inner.get_batch(keys[miss],
                                       resolve_makeup=resolve_makeup)
            values[miss] = sub.values
            found[miss] = sub.found
            if sub.statuses is not None:
                # a degraded whole-call answer from the retry stage: those
                # lanes resolved nothing, and observing them would poison
                # the cache with false negatives, so only the lanes the
                # cache answered itself are observed again, and the lane
                # statuses surface to the caller
                mi = iter(sub.statuses)
                statuses = tuple(next(mi) if m else "ok" for m in miss)
                learned = hit | neg
                if learned.any():
                    self.cache.observe_batch(
                        lo[learned], hi[learned],
                        (values[learned] & _M32).astype(np.uint32),
                        (values[learned] >> np.uint64(32)).astype(np.uint32),
                        found[learned], hit[learned], neg[learned])
                return OpResult(values=values, found=found,
                                statuses=statuses)
        self.cache.observe_batch(
            lo, hi, (values & _M32).astype(np.uint32),
            (values >> np.uint64(32)).astype(np.uint32), found, hit, neg)
        return OpResult(values=values, found=found)

    # ----------------------------------------------------------- mutations
    def insert(self, key: int, value: int) -> OpResult:
        res = self.inner.insert(key, value)
        if res.status not in _NOT_APPLIED:
            self.cache.note_insert(int(key), int(value))
        return res

    def update(self, key: int, value: int) -> OpResult:
        res = self.inner.update(key, value)
        if bool(res.found[0]):
            self.cache.note_update(int(key), int(value))
        return res

    def delete(self, key: int) -> OpResult:
        res = self.inner.delete(key)
        if bool(res.found[0]):
            self.cache.note_delete(int(key))
        return res

    def insert_batch(self, keys, values) -> OpResult:
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.uint64)
        res = self.inner.insert_batch(keys, values)
        done = np.asarray([c not in _NOT_APPLIED for c in res.statuses],
                          bool)
        self.cache.note_insert_batch(keys[done], values[done])
        return res

    def update_batch(self, keys, values) -> OpResult:
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.uint64)
        res = self.inner.update_batch(keys, values)
        self.cache.note_update_batch(keys[res.found], values[res.found])
        return res

    def delete_batch(self, keys) -> OpResult:
        keys = np.asarray(keys, dtype=np.uint64)
        res = self.inner.delete_batch(keys)
        self.cache.note_delete_batch(keys[res.found])
        return res


class MeterLayer(StoreLayer):
    """Stamps per-call meter deltas onto each OpResult.

    With a telemetry hub attached it also forwards each call's
    attribution to ``hub.on_op`` under its op kind and annotates the
    active span, reading only the deltas it already computed, so metered
    results are byte-identical with the hub on or off."""

    def __init__(self, inner, hub=None):
        super().__init__(inner)
        self.hub = hub

    def _attributed(self, n: int, call, op: str = "get") -> OpResult:
        before = self.inner.meter_totals()
        res = call()
        after = self.inner.meter_totals()
        res.round_trips = after.round_trips - before.round_trips
        res.req_bytes = after.req_bytes - before.req_bytes
        res.resp_bytes = after.resp_bytes - before.resp_bytes
        # every lane opens one meter op; Makeup-Get continuations open one
        # more each (clamped at zero)
        res.makeups = max(0, (after.ops - before.ops) - n)
        res.cache_hits = after.cache_hits - before.cache_hits
        res.cache_neg_hits = after.cache_neg_hits - before.cache_neg_hits
        # failure-plane attribution (all-zero deltas on the no-fault path)
        res.retries = after.retries - before.retries
        res.backoffs = after.backoffs - before.backoffs
        res.failovers = after.failovers - before.failovers
        hub = self.hub
        if hub is not None:
            hub.on_op(op, n, round_trips=res.round_trips,
                      req_bytes=res.req_bytes, resp_bytes=res.resp_bytes,
                      makeups=res.makeups, retries=res.retries,
                      backoffs=res.backoffs, failovers=res.failovers)
            hub.annotate(round_trips=res.round_trips,
                         req_bytes=res.req_bytes, resp_bytes=res.resp_bytes,
                         makeups=res.makeups)
        return res

    def get(self, key: int) -> OpResult:
        return self._attributed(1, lambda: self.inner.get(key), "get")

    def get_batch(self, keys, *,
                  resolve_makeup: bool | None = None) -> OpResult:
        return self._attributed(len(keys), lambda: self.inner.get_batch(
            keys, resolve_makeup=resolve_makeup), "get")

    def insert(self, key: int, value: int) -> OpResult:
        return self._attributed(1, lambda: self.inner.insert(key, value),
                                "insert")

    def update(self, key: int, value: int) -> OpResult:
        return self._attributed(1, lambda: self.inner.update(key, value),
                                "update")

    def delete(self, key: int) -> OpResult:
        return self._attributed(1, lambda: self.inner.delete(key), "delete")

    def insert_batch(self, keys, values) -> OpResult:
        return self._attributed(
            len(keys), lambda: self.inner.insert_batch(keys, values),
            "insert")

    def update_batch(self, keys, values) -> OpResult:
        return self._attributed(
            len(keys), lambda: self.inner.update_batch(keys, values),
            "update")

    def delete_batch(self, keys) -> OpResult:
        return self._attributed(
            len(keys), lambda: self.inner.delete_batch(keys), "delete")


@dataclasses.dataclass(frozen=True)
class TransportBinding:
    """The innermost stage, made explicit: a ``repro_torch.net.Transport``
    bound to every engine meter's ``sink`` at construction (the factories
    pass it down, so split successors inherit it), kept as a stack member
    so the assembled order reads off the object; the pipeline stage marks
    its doorbell windows in the same transport."""

    transport: object | None = None


@dataclasses.dataclass(frozen=True)
class CNStack:
    """Composition root for the CN-side stack; ``open_store`` builds one
    per store.  ``cache`` (a ``CNKeyCache`` on the engine's device, or
    ``None``) inserts the cache stage; ``retry`` (a
    ``repro_torch.net.faults.FaultPlane``, set by the registry whenever the
    spec carries a ``FaultSchedule`` or ``replicas > 1``) inserts the
    recovery stage directly above the (replica-set) adapter; ``policy`` (a
    ``BatchPolicy``, or ``None`` for the synchronous ``BatchPolicy.sync()``)
    shapes the pipeline stage, so the assembled order reads ``Pipeline →
    Meter → [CNCache →] [Retry →] adapter (→ Transport)``; ``hub`` (a
    ``repro_torch.obs.TelemetryHub``, or ``None``) is handed to every stage
    and to the adapter."""

    cache: CNKeyCache | None = None
    transport_binding: TransportBinding = TransportBinding()
    policy: object | None = None  # BatchPolicy; None -> sync()
    retry: object | None = None   # FaultPlane; None -> no retry stage
    hub: object | None = None     # a TelemetryHub; None -> dormant plane

    def assemble(self, adapter):
        from repro_torch.api.pipeline import PipelineLayer  # import cycle
        store = adapter
        if self.hub is not None:
            adapter.hub = self.hub  # the replica set's annotations
        if self.retry is not None:
            store = RetryLayer(store, self.retry,
                               transport=self.transport_binding.transport,
                               hub=self.hub)
        if self.cache is not None:
            store = CNCacheLayer(store, self.cache, hub=self.hub)
        return PipelineLayer(MeterLayer(store, hub=self.hub),
                             policy=self.policy,
                             transport=self.transport_binding.transport,
                             hub=self.hub)
