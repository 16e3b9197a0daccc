"""Engine adapters: ``repro_torch.core`` stores behind the uniform ``KVStore``.

The port of ``repro.api.adapters``, kind ``outback`` only.  An adapter owns
no policy: it translates the engine's native call surface (device tensors,
``GetResult``, case strings and bool masks) into the protocol's
batched-first ``OpResult`` ops, and exposes the raw engine as ``.engine``.
Batched mutations delegate to the engine's ``*_batch`` paths, exact
vectorisations of its scalar walks.
"""

from __future__ import annotations

import numpy as np

from repro_torch.api.protocol import OpResult, pack_result, status_result
from repro_torch.core.meter import MSG_BYTES, CommMeter

_OK = "ok"
_MISS = "miss"
_FAILED = frozenset(("frozen", _MISS))

# What one locally-answered read saves on Outback's wire: a positive answer
# skips the 1-RT Get; a negative one the 2-RT miss-plus-makeup route.  Both
# directions of an RPC message are padded to MSG_BYTES (paper §5.1).
CACHE_HIT_SAVINGS = dict(saved_rts=1, saved_req=MSG_BYTES,
                         saved_resp=MSG_BYTES)
CACHE_NEG_SAVINGS = dict(saved_rts=2, saved_req=2 * MSG_BYTES,
                         saved_resp=2 * MSG_BYTES)


class StoreAdapter:
    """Base adapter: uniform surface over one engine object."""

    kind = "?"
    verifies_keys = True
    # what one locally-answered read (the pipeline's write-combined reads)
    # saves on *this kind's* wire — the per-op cost of the Get it avoids
    cache_hit_savings = CACHE_HIT_SAVINGS
    cache_neg_savings = CACHE_NEG_SAVINGS
    telemetry = None

    def __init__(self, engine, spec):
        self.engine = engine
        self.spec = spec

    # ------------------------------------------------------------ metering
    @property
    def meter(self) -> CommMeter:
        return self.engine.meter

    def meter_totals(self) -> CommMeter:
        m = CommMeter()
        m.merge(self.engine.meter)
        return m

    def reset_meters(self) -> None:
        self.engine.meter.reset()

    # ---------------------------------------------------------------- gets
    def _engine_get_batch(self, keys, resolve_makeup):
        return self.engine.get_batch(keys)

    def get_batch(self, keys, *,
                  resolve_makeup: bool | None = None) -> OpResult:
        keys = np.asarray(keys, dtype=np.uint64)
        return pack_result(*self._engine_get_batch(keys, resolve_makeup))

    def _get_value(self, key: int):
        """Engine scalar Get -> int | None."""
        return self.engine.get(int(key))

    def get(self, key: int) -> OpResult:
        val = self._get_value(key)
        return OpResult(values=np.asarray([0 if val is None else val],
                                          np.uint64),
                        found=np.asarray([val is not None]))

    # ----------------------------------------------------------- mutations
    def _insert(self, key: int, value: int) -> str:
        return self.engine.insert(int(key), int(value))

    def _update(self, key: int, value: int) -> str:
        return _OK if self.engine.update(int(key), int(value)) else _MISS

    def _delete(self, key: int) -> str:
        return _OK if self.engine.delete(int(key)) else _MISS

    def insert(self, key: int, value: int) -> OpResult:
        case = self._insert(key, value)
        return status_result((case,), np.asarray([case not in _FAILED]))

    def update(self, key: int, value: int) -> OpResult:
        case = self._update(key, value)
        return status_result((case,), np.asarray([case not in _FAILED]))

    def delete(self, key: int) -> OpResult:
        case = self._delete(key)
        return status_result((case,), np.asarray([case not in _FAILED]))

    def insert_batch(self, keys, values) -> OpResult:
        cases = tuple(self.engine.insert_batch(
            np.asarray(keys, dtype=np.uint64),
            np.asarray(values, dtype=np.uint64)))
        return status_result(cases,
                             np.asarray([c not in _FAILED for c in cases]))

    def update_batch(self, keys, values) -> OpResult:
        ok = np.asarray(self.engine.update_batch(
            np.asarray(keys, dtype=np.uint64),
            np.asarray(values, dtype=np.uint64)), dtype=bool)
        return status_result(tuple(_OK if o else _MISS for o in ok), ok)

    def delete_batch(self, keys) -> OpResult:
        ok = np.asarray(self.engine.delete_batch(
            np.asarray(keys, dtype=np.uint64)), dtype=bool)
        return status_result(tuple(_OK if o else _MISS for o in ok), ok)


class OutbackShardAdapter(StoreAdapter):
    kind = "outback"

    def _engine_get_batch(self, keys, resolve_makeup):
        # the uniform API returns resolved truths by default (batch answers
        # == scalar protocol answers, overflow residents included); pass
        # resolve_makeup=False for the raw 1-RT Get stream
        if resolve_makeup is None:
            resolve_makeup = True
        return self.engine.get_batch(keys, resolve_makeup=resolve_makeup)

    def _get_value(self, key: int):
        return self.engine.get(int(key)).value
