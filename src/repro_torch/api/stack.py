"""The composable CN-side stack: ``Pipeline → Meter → adapter``.

The port of ``repro.api.stack``, first slice: the meter stage and the
composition root.  The reference's CN-cache and retry stages, and a live
transport below the engine, are not ported yet; ``open_store`` refuses
specs that need them, and :class:`TransportBinding` holds no transport.

* **Meter** (:class:`MeterLayer`) — stamps per-call attribution (round
  trips, wire bytes, Makeup-Get continuations, cache hits) onto every
  ``OpResult`` from the store's merged meter deltas.
* **Pipeline** (``repro_torch.api.pipeline.PipelineLayer``) — the
  submission/completion plane, outermost.

:class:`StoreLayer` forwards the protocol's members (``spec``,
``telemetry``, ``meter``, the ops, the meter accessors) as real attributes
and methods, not through ``__getattr__``, so a layer satisfies the
runtime-checkable ``KVStore`` protocol under Python 3.12's static member
lookup.
"""

from __future__ import annotations

import dataclasses

from repro_torch.api.protocol import OpResult


class StoreLayer:
    """Base middleware: wraps an inner KVStore and forwards each protocol
    member to it explicitly; subclasses override the ops they change."""

    telemetry = None  # the telemetry plane is not ported: always dormant

    def __init__(self, inner):
        self.inner = inner
        self.spec = inner.spec

    # ------------------------------------------------ forwarded attributes
    @property
    def engine(self):
        return self.inner.engine

    @property
    def meter(self):
        return self.inner.meter

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


class MeterLayer(StoreLayer):
    """Stamps per-call meter deltas onto each OpResult."""

    def _attributed(self, n: int, call) -> OpResult:
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
        return res

    def get(self, key: int) -> OpResult:
        return self._attributed(1, lambda: self.inner.get(key))

    def get_batch(self, keys, *,
                  resolve_makeup: bool | None = None) -> OpResult:
        return self._attributed(len(keys), lambda: self.inner.get_batch(
            keys, resolve_makeup=resolve_makeup))

    def insert(self, key: int, value: int) -> OpResult:
        return self._attributed(1, lambda: self.inner.insert(key, value))

    def update(self, key: int, value: int) -> OpResult:
        return self._attributed(1, lambda: self.inner.update(key, value))

    def delete(self, key: int) -> OpResult:
        return self._attributed(1, lambda: self.inner.delete(key))

    def insert_batch(self, keys, values) -> OpResult:
        return self._attributed(len(keys),
                                lambda: self.inner.insert_batch(keys, values))

    def update_batch(self, keys, values) -> OpResult:
        return self._attributed(len(keys),
                                lambda: self.inner.update_batch(keys, values))

    def delete_batch(self, keys) -> OpResult:
        return self._attributed(len(keys),
                                lambda: self.inner.delete_batch(keys))


@dataclasses.dataclass(frozen=True)
class TransportBinding:
    """The innermost stage's place in the stack.  The simulated RDMA
    transport is not ported yet, so it binds nothing."""

    transport: object | None = None


@dataclasses.dataclass(frozen=True)
class CNStack:
    """Composition root for the CN-side stack; ``open_store`` builds one
    per store.  ``policy`` (a ``BatchPolicy``, or ``None`` for the
    synchronous ``BatchPolicy.sync()``) shapes the pipeline stage, so the
    assembled order reads ``Pipeline → Meter → adapter``."""

    transport_binding: TransportBinding = TransportBinding()
    policy: object | None = None  # BatchPolicy; None -> sync()

    def assemble(self, adapter):
        from repro_torch.api.pipeline import PipelineLayer  # import cycle
        return PipelineLayer(MeterLayer(adapter), policy=self.policy)
