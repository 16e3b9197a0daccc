"""The uniform ``KVStore`` protocol and its structured ``OpResult``.

The port of ``repro.api.protocol``.  One batched-first protocol:

* ``get_batch / insert_batch / update_batch / delete_batch`` — the primary
  ops, served by the engines' batched paths (exact vectorisations of the
  scalar walks: same results, same meter totals); scalar ``get / insert /
  update / delete`` are conveniences over the engines' scalar walks.
* Every op returns an :class:`OpResult`: combined 64-bit ``values`` (host
  numpy), a ``found`` mask, mutation ``statuses``, and — stamped by the
  stack's meter stage — per-call round-trip / wire-byte / Makeup-Get /
  cache-hit attribution.

The reference's ``xp`` argument (numpy or jax namespace) has no
counterpart: the port's engines hold their arrays on one torch device.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch


class UnsupportedOperation(RuntimeError):
    """The store kind cannot serve this op (e.g. no MN kernel on RACE)."""


# The op kinds the v2 submission plane accepts — also the complete set of
# batched protocol entry points every registered kind serves.
OP_KINDS = ("get", "insert", "update", "delete")


@dataclasses.dataclass
class OpResult:
    """Structured result of one (batched) KVStore operation.

    ``values``/``found`` are host numpy arrays, one lane per input key
    (mutations carry ``statuses`` instead of values).  The attribution
    fields are *per-call deltas* of the store's merged meters, stamped by
    the stack's meter stage: what this exact call cost on the simulated
    wire and how much of it the CN cache absorbed.
    """

    values: np.ndarray  # uint64, zeros where ``found`` is False
    found: np.ndarray  # bool: key present (Get) / op succeeded (mutations)
    # per-lane resolution cases; None for fault-free Gets.  Mutations use
    # ('slot' | 'reseed' | 'overflow' | 'update' | 'frozen' | 'ok' |
    # 'miss'); the failure plane (repro.api.replication) adds two more on
    # any op kind: 'backoff' — the serving MN was unreachable and the
    # retry stage will re-issue (callers below the RetryLayer see it;
    # callers above never do) — and 'unavailable' — the retry budget is
    # exhausted and the lane is answered degraded (found=False, no state
    # changed), the FlexChain idiom: stores answer, they don't block.
    statuses: tuple[str, ...] | None = None
    # ---- per-call attribution (meter deltas; see stack.MeterLayer) ----
    round_trips: int = 0
    req_bytes: int = 0
    resp_bytes: int = 0
    makeups: int = 0  # lanes that took the §4.3.1 Makeup-Get continuation
    cache_hits: int = 0
    cache_neg_hits: int = 0
    # ---- failure-plane attribution (zero on the no-fault path) ----
    retries: int = 0    # lanes re-issued by the retry stage on this call
    backoffs: int = 0   # BACKOFF answers absorbed before this call resolved
    failovers: int = 0  # primary switches this call rode through

    def __len__(self) -> int:
        return int(self.found.shape[0])

    @property
    def value(self) -> int | None:
        """Scalar convenience: the single lane's value, None if absent."""
        if not bool(self.found[0]):
            return None
        return int(self.values[0])

    @property
    def status(self) -> str | None:
        """Scalar convenience: the single lane's mutation status."""
        return None if self.statuses is None else self.statuses[0]


def _host_u32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):  # int32 lanes holding uint32 patterns
        return x.cpu().numpy().view(np.uint32)
    return np.asarray(x, dtype=np.uint32)


def pack_result(v_lo, v_hi, match) -> OpResult:
    """Combine an engine's ``(v_lo, v_hi, match)`` triple (device tensors
    or host arrays) into a host OpResult."""
    v_lo = _host_u32(v_lo).astype(np.uint64)
    v_hi = _host_u32(v_hi).astype(np.uint64)
    if isinstance(match, torch.Tensor):
        match = match.cpu().numpy()
    found = np.asarray(match, dtype=bool)
    values = np.where(found, (v_hi << np.uint64(32)) | v_lo, np.uint64(0))
    return OpResult(values=values, found=found)


def status_result(statuses: tuple[str, ...], ok: np.ndarray) -> OpResult:
    """Build a mutation OpResult from per-lane case strings + ok mask
    (zero values — mutations don't return data)."""
    return OpResult(values=np.zeros(len(statuses), np.uint64),
                    found=np.asarray(ok, bool), statuses=statuses)


@typing.runtime_checkable
class KVStore(typing.Protocol):
    """What ``open_store`` returns; what new middleware must preserve.

    Structural protocol — satisfied by the adapters in
    ``repro_torch.api.adapters`` and by every ``repro_torch.api.stack`` layer.
    ``resolve_makeup`` is accepted uniformly: the default (``None``)
    returns fully-resolved answers everywhere (Outback kinds run the
    §4.3.1 Makeup-Get stage for mismatched lanes; baselines resolve in one
    protocol round by construction).  Outback kinds honour an explicit
    ``False`` to expose the raw 1-RT Get stream (what the trace-recording
    and MN-kernel-timing benchmarks want).
    """

    spec: typing.Any  # the StoreSpec this store was opened from

    # ------------------------------------------------------ batched-first
    def get_batch(self, keys, *,
                  resolve_makeup: bool | None = None) -> OpResult: ...

    def insert_batch(self, keys, values) -> OpResult: ...

    def update_batch(self, keys, values) -> OpResult: ...

    def delete_batch(self, keys) -> OpResult: ...

    # ------------------------------------------------ scalar conveniences
    def get(self, key: int) -> OpResult: ...

    def insert(self, key: int, value: int) -> OpResult: ...

    def update(self, key: int, value: int) -> OpResult: ...

    def delete(self, key: int) -> OpResult: ...

    # ---------------------------------------------------------- metering
    def meter_totals(self): ...  # -> repro_torch.core.meter.CommMeter

    def reset_meters(self) -> None: ...


@typing.runtime_checkable
class PipelinedKVStore(KVStore, typing.Protocol):
    """The v2 surface ``open_store`` returns: the v1 sync ops (kept as
    conveniences over the pipeline) plus the asynchronous submission/
    completion plane served by :class:`repro_torch.api.pipeline.PipelineLayer`.

    ``submit(op, keys, values)`` enqueues one op (``op`` one of
    :data:`OP_KINDS`; ``keys`` scalar or array) and returns an
    ``OpHandle``; pending submissions coalesce into the engines' batched
    kernels when the store's ``BatchPolicy`` fires a flush (window-full /
    explicit / read-after-write hazard).  ``poll()`` drains completed
    handles without executing anything; ``flush()`` forces execution and
    drains.  See ``repro_torch.api.pipeline`` for the ordering semantics.
    """

    # the store's TelemetryHub when the spec carried a TelemetryConfig,
    # else None (the dormant plane); see repro_torch.obs
    telemetry: typing.Any

    def submit(self, op: str, keys, values=None) -> "OpHandle": ...  # noqa: F821

    def poll(self) -> list: ...

    def flush(self) -> list: ...
