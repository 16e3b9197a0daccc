"""Engine adapters: ``repro_torch.core`` stores behind the uniform ``KVStore``.

The port of ``repro.api.adapters``: kinds ``outback``, ``outback-dir``
and the four baselines (``race``, ``mica``, ``cluster``, ``dummy``); the
sharded host's adapter is not ported yet.  An adapter owns no policy: it
translates the engine's native call surface (device tensors,
``GetResult``, case strings and bool masks) into the protocol's
batched-first ``OpResult`` ops, and exposes the raw engine as ``.engine``.
Batched mutations delegate to the engine's ``*_batch`` paths, exact
vectorisations of its scalar walks.  Each kind declares what one
locally-answered read saves on its own wire (``cache_hit_savings``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.protocol import OpResult, pack_result, status_result
from repro_torch.core.baselines import RaceKVS
from repro_torch.core.meter import MSG_BYTES, CommMeter
from repro_torch.core.outback import CACHE_HIT_SAVINGS, CACHE_NEG_SAVINGS

_OK = "ok"
_MISS = "miss"
_FAILED = frozenset(("frozen", _MISS))


class StoreAdapter:
    """Base adapter: uniform surface over one engine object."""

    kind = "?"
    verifies_keys = True
    # what one locally-answered read (a CN-cache hit, or the pipeline's
    # write-combined reads) saves on *this kind's* wire — the per-op cost
    # of the Get it avoids
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

    def bind_cache(self, cache) -> None:
        """Hook for kinds with engine-side cache sync points (resize)."""

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


class OutbackStoreAdapter(OutbackShardAdapter):
    kind = "outback-dir"

    def meter_totals(self) -> CommMeter:
        return self.engine.meter_total()

    def reset_meters(self) -> None:
        self.engine.meter.reset()
        for t in self.engine._unique_tables():
            t.meter.reset()

    def bind_cache(self, cache) -> None:
        self.engine.bind_coherence_cache(cache)


class BaselineAdapter(StoreAdapter):
    """RPC-MICA / RPC-Cluster / RPC-Dummy: full surface, no makeup
    concept — their Get resolves in one protocol round, so
    ``resolve_makeup`` is accepted and ignored.  A cache answer saves their
    single padded two-sided RPC round, hit or known-absent alike."""

    cache_hit_savings = dict(saved_rts=1, saved_req=MSG_BYTES,
                             saved_resp=MSG_BYTES)
    cache_neg_savings = cache_hit_savings

    def _engine_get_batch(self, keys, resolve_makeup):
        v_lo, v_hi, match = self.engine.get_batch(keys)
        host = torch.stack([v_lo, v_hi, match.to(torch.int32)]).cpu().numpy()
        return host[0], host[1], host[2] != 0  # one device->host copy


class RaceAdapter(BaselineAdapter):
    """RACE: a cache answer saves the two dependent one-sided READ trips
    (raw NIC payloads, no RPC padding) — a miss pays the same route."""

    kind = "race"
    cache_hit_savings = dict(saved_rts=2, saved_req=32,
                             saved_resp=2 * RaceKVS.GROUP_BYTES + 32)
    cache_neg_savings = cache_hit_savings


class DummyAdapter(BaselineAdapter):
    kind = "dummy"
    verifies_keys = False  # the upper-bound model answers one fixed read
