"""Engine adapters: ``repro_torch.core`` stores behind the uniform ``KVStore``.

The port of ``repro.api.adapters``: kinds ``outback``, ``outback-dir``,
the four baselines (``race``, ``mica``, ``cluster``, ``dummy``) and the
``sharded`` host over a mesh state.  An adapter owns no policy: it
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
from repro_torch.core.hashing import hash64_32_np, split_u64
from repro_torch.core.meter import MSG_BYTES, CommMeter
from repro_torch.core.outback import CACHE_HIT_SAVINGS, CACHE_NEG_SAVINGS
from repro_torch.core.sharded_kvs import _ROUTE_SEED, _install_shard

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
    hub = None  # the stack's TelemetryHub (CNStack.assemble sets it)

    @property
    def telemetry(self):
        """The stack's ``repro_torch.obs.TelemetryHub``, or ``None``."""
        return self.hub

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


class ShardedAdapter(StoreAdapter):
    """Host-side protocol surface over a mesh-sharded ``ShardedKVSState``.

    ``engine`` is the stacked state (what ``place_state``/``make_get_fn``
    consume); the per-shard ``OutbackShard`` objects kept by
    ``build_sharded(keep_shards=True)`` serve the actual protocol ops, and
    ``mesh_state()`` re-installs any mutated shard before the state is
    handed to the mesh path.
    """

    kind = "sharded"

    def __init__(self, engine, spec, *, shards, data_parallel: int):
        super().__init__(engine, spec)
        self.shards = shards
        self._D = int(data_parallel)
        self._dirty: set[int] = set()
        self._meter = engine.meter if engine.meter is not None else CommMeter()

    # ------------------------------------------------------------ metering
    @property
    def meter(self) -> CommMeter:
        return self._meter

    def meter_totals(self) -> CommMeter:
        m = CommMeter()
        m.merge(self._meter)
        for sh in self.shards:
            m.merge(sh.meter)
        return m

    def reset_meters(self) -> None:
        self._meter.reset()
        for sh in self.shards:
            sh.meter.reset()

    # ------------------------------------------------------------- routing
    def _shard_of(self, keys: np.ndarray) -> np.ndarray:
        lo, hi = split_u64(np.asarray(keys, np.uint64))
        return hash64_32_np(lo, hi, _ROUTE_SEED) % np.uint32(len(self.shards))

    def _owner(self, key: int):
        m = int(self._shard_of(np.uint64([key]))[0])
        return m, self.shards[m]

    # ---------------------------------------------------------------- gets
    def get_batch(self, keys, *,
                  resolve_makeup: bool | None = None) -> OpResult:
        if resolve_makeup is None:
            resolve_makeup = True  # uniform default: resolved truths
        keys = np.asarray(keys, dtype=np.uint64)
        tgt = self._shard_of(keys)
        v_lo = np.zeros(keys.shape[0], np.uint32)
        v_hi = np.zeros(keys.shape[0], np.uint32)
        match = np.zeros(keys.shape[0], bool)
        for m in np.unique(tgt):
            mask = tgt == m
            lo, hi, mt = self.shards[int(m)].get_batch(
                keys[mask], resolve_makeup=resolve_makeup)
            host = torch.stack([lo, hi, mt.to(torch.int32)]).cpu().numpy()
            v_lo[mask] = host[0].view(np.uint32)
            v_hi[mask] = host[1].view(np.uint32)
            match[mask] = host[2] != 0
        return pack_result(v_lo, v_hi, match)

    def _get_value(self, key: int):
        return self._owner(key)[1].get(int(key)).value

    # ----------------------------------------------------------- mutations
    def insert_batch(self, keys, values) -> OpResult:
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.uint64)
        tgt = self._shard_of(keys)
        cases: list[str | None] = [None] * int(keys.shape[0])
        for m in np.unique(tgt):
            mask = tgt == m
            sub = self.shards[int(m)].insert_batch(keys[mask], values[mask])
            for i, case in zip(np.nonzero(mask)[0], sub):
                cases[int(i)] = case
            self._dirty.add(int(m))
        return status_result(tuple(cases),
                             np.asarray([c not in _FAILED for c in cases]))

    def update_batch(self, keys, values) -> OpResult:
        keys = np.asarray(keys, dtype=np.uint64)
        values = np.asarray(values, dtype=np.uint64)
        tgt = self._shard_of(keys)
        ok = np.zeros(keys.shape[0], dtype=bool)
        for m in np.unique(tgt):
            mask = tgt == m
            ok[mask] = self.shards[int(m)].update_batch(keys[mask],
                                                        values[mask])
            if bool(ok[mask].any()):
                self._dirty.add(int(m))
        return status_result(tuple(_OK if o else _MISS for o in ok), ok)

    def delete_batch(self, keys) -> OpResult:
        keys = np.asarray(keys, dtype=np.uint64)
        tgt = self._shard_of(keys)
        ok = np.zeros(keys.shape[0], dtype=bool)
        for m in np.unique(tgt):
            mask = tgt == m
            ok[mask] = self.shards[int(m)].delete_batch(keys[mask])
            if bool(ok[mask].any()):
                self._dirty.add(int(m))
        return status_result(tuple(_OK if o else _MISS for o in ok), ok)

    def _insert(self, key: int, value: int) -> str:
        m, sh = self._owner(key)
        case = sh.insert(int(key), int(value))
        self._dirty.add(m)
        return case

    def _update(self, key: int, value: int) -> str:
        m, sh = self._owner(key)
        ok = sh.update(int(key), int(value))
        if ok:
            self._dirty.add(m)
        return _OK if ok else _MISS

    def _delete(self, key: int) -> str:
        m, sh = self._owner(key)
        ok = sh.delete(int(key))
        if ok:
            self._dirty.add(m)
        return _OK if ok else _MISS

    # --------------------------------------------------------- mesh export
    def mesh_state(self):
        """The stacked state with every mutated shard re-installed — pass
        to ``place_state``/``make_get_fn``.  Raises if a shard outgrew its
        row capacity (raise the spec's ``heap_slack``).

        The mesh path serves slot-resident keys only: overflow-cache
        residents (build fallbacks, case-3 inserts) need the adapter's full
        protocol, which runs the §4.3.1 Makeup-Get the mesh path omits.
        The mesh's ``model`` axis must equal the spec's ``num_shards``."""
        for m in sorted(self._dirty):
            _install_shard(self.engine, m, self.shards[m], self._D)
        self._dirty.clear()
        return self.engine
