"""The v2 submission/completion plane: ``submit`` → ``poll``/``flush``.

The port of ``repro.api.pipeline``: host logic, identical in its
batching, ordering, attribution and doorbell marks.  The reference's
telemetry hooks wait for that plane to be ported.

Outback's one-round-trip advantage only materialises when a compute node
coalesces many WQEs under one doorbell ring (§2, Fig. 2).  The v1
``repro.api`` surface was strictly call-and-wait, so every caller that
wanted the batched kernels hand-rolled its own window (the YCSB bench
hardcoded ``WINDOW = 1024``; the serving session store could not batch at
all).  This module moves the window into the store itself:

* :class:`BatchPolicy` — *where and when ops coalesce*, as pure
  JSON-round-trippable config.  It is a first-class field of
  ``StoreSpec`` (``StoreSpec(kind, batch=BatchPolicy(...))``), so the
  policy that shaped a benchmark run is recorded in its spec.
* :class:`OpHandle` — what :meth:`PipelineLayer.submit` returns: a
  placeholder for one submission's lanes, resolved when the op completes
  (at a flush, or immediately for write-combined reads).
* :class:`PipelineLayer` — the outermost stage of the CN stack
  (``Pipeline → Meter → [CNCache →] [Retry →] adapter``).  ``submit``
  enqueues; pending ops auto-coalesce into the engines' native
  ``*_batch`` kernels when a flush trigger fires: **window-full**
  (pending lanes reach ``policy.window``), **explicit**
  (:meth:`PipelineLayer.flush`), or a **read-after-write hazard** on a
  pending key (strict order).

Ordering semantics.  A flush executes pending ops grouped per op kind in
the canonical order ``get → update → insert → delete`` (exactly the
grouping the hand-batched YCSB driver used, so a pipelined run meters
byte-identically to a hand-batched one).  Under ``order="strict"`` (the
default) the pipeline guarantees submission-order semantics *across* op
kinds: submitting an op whose key is pending under a *different* kind —
a Get of a pending write, an Update of a pending Insert, a Delete of a
pending Insert — first flushes the queue (or, for reads with
``combine_reads=True``, answers from the write-combining buffer without
touching the wire).  Ops of the *same* kind coalesce freely: the engine
batch kernels preserve lane order exactly as the scalar stream would
(tested against ``repro`` in ``tests/test_torch_outback.py``).  ``order="relaxed"``
skips hazard tracking entirely — the model of many independent
closed-loop clients sharing one doorbell, where intra-window order
carries no meaning (what every multi-client benchmark wants).

Each flush of a ``window > 1`` policy drops a
:class:`repro_torch.net.DoorbellMark` into the bound transport's trace, so
``repro_torch.net.simulate(window="policy")`` replays the recorded op
stream with exactly the outstanding-ops window the policy produced.

Attribution.  When a flush coalesces several submissions of one kind
into a single batch call, the meter stage stamps *that call's* deltas
onto one shared :class:`~repro_torch.api.protocol.OpResult`; each handle's
sliced per-lane result keeps zeroed attribution and exposes the shared
one as :attr:`OpHandle.batch`.  A submission that rides a flush alone
gets the attributed result directly — so the v1 sync conveniences
(`get_batch` & co., now thin ``submit``+``flush`` shims) are
byte-identical to the pre-pipeline surface.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from repro_torch.api.protocol import OP_KINDS, OpResult
from repro_torch.api.stack import StoreLayer

_WRITES = ("insert", "update", "delete")
_FLUSH_ORDER = ("get", "update", "insert", "delete")
_ORDERS = ("strict", "relaxed")


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Per-store batching policy: pure, JSON-round-trippable config.

    ``window``        flush once this many lanes are pending (a trigger,
                      not a cap: one oversized submission still coalesces
                      whole).  ``window=1`` is the synchronous v1
                      behaviour — every submission flushes immediately.
    ``coalesce``      op kinds eligible for coalescing; submitting any
                      other kind flushes the queue and executes at once.
    ``order``         ``"strict"`` enforces submission-order semantics
                      across op kinds via hazard flushes; ``"relaxed"``
                      models independent clients sharing a doorbell (no
                      hazard tracking — the hand-batched bench grouping).
    ``combine_reads`` strict mode only: serve a read of a pending-write
                      key from the write-combining buffer instead of
                      flushing.  The forwarded value is optimistic; the
                      flush that executes the buffered write *reconciles*
                      it — if the write failed (update of an absent key,
                      frozen insert/delete) the combined lanes are
                      re-read for real (one metered ``get_batch``,
                      ``stats.reconciled_reads``) and the handle's
                      result is patched before the flush returns, so
                      polled answers match a ``combine_reads=False`` run.
    """

    window: int = 1024
    coalesce: tuple[str, ...] = OP_KINDS
    order: str = "strict"
    combine_reads: bool = False

    @classmethod
    def sync(cls) -> "BatchPolicy":
        """The v1-compatible policy: every submission flushes at once."""
        return cls(window=1)

    # ------------------------------------------------------------- config
    def validate(self) -> "BatchPolicy":
        if not isinstance(self.window, int) or self.window < 1:
            raise ValueError(f"BatchPolicy.window must be an int >= 1, "
                             f"got {self.window!r}")
        unknown = set(self.coalesce) - set(OP_KINDS)
        if unknown:
            raise ValueError(f"BatchPolicy.coalesce has unknown op kinds "
                             f"{sorted(unknown)}; allowed: {OP_KINDS}")
        if self.order not in _ORDERS:
            raise ValueError(f"BatchPolicy.order must be one of {_ORDERS}, "
                             f"got {self.order!r}")
        if self.combine_reads and self.order != "strict":
            raise ValueError("BatchPolicy.combine_reads requires "
                             "order='strict' (relaxed mode has no hazard "
                             "tracking to combine against)")
        return self

    def to_json_dict(self) -> dict:
        return {"window": self.window, "coalesce": list(self.coalesce),
                "order": self.order, "combine_reads": self.combine_reads}

    @classmethod
    def from_json_dict(cls, d: dict) -> "BatchPolicy":
        if not isinstance(d, dict):
            raise ValueError(f"BatchPolicy JSON must be an object, "
                             f"got {type(d).__name__}")
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(
                f"unknown BatchPolicy fields: {sorted(unknown)}")
        d = dict(d)
        if "coalesce" in d:
            d["coalesce"] = tuple(d["coalesce"])
        return cls(**d).validate()


@dataclasses.dataclass
class PipelineStats:
    """Counters the pipeline keeps about itself (recorded by benches)."""

    submitted: int = 0        # lanes accepted by submit()
    flushes: int = 0          # flushes that executed at least one op
    window_flushes: int = 0   # ... triggered by the window filling
    hazard_flushes: int = 0   # ... triggered by a cross-kind key hazard
    combined_reads: int = 0   # read lanes served from the write buffer
    reconciled_reads: int = 0  # combined lanes re-read because their
    #   buffered write failed at flush time (the speculative-forward fixup)
    batch_calls: int = 0      # engine *_batch calls issued by flushes
    dropped_completions: int = 0  # handles aged out of the poll() backlog
    unavailable_lanes: int = 0  # lanes answered degraded ("unavailable")
    #   by the retry stage after its budget ran out — in-flight OpHandles
    #   still resolve (found=False), the FlexChain answer-don't-block idiom


# How many completed-but-unpolled handles the pipeline retains for
# ``poll``.  A fire-and-forget caller (the session store parks thousands
# of sessions and never polls) must not pin every flush's batch arrays
# forever; each handle remains the source of truth for its own result
# regardless — ageing out of the backlog only makes it invisible to
# ``poll``, which ``stats.dropped_completions`` records.
DONE_BACKLOG_MAX = 4096


class OpHandle:
    """One submission's completion handle.

    :meth:`result` yields the submission's per-lane
    :class:`~repro_torch.api.protocol.OpResult` (flushing the owning pipeline
    first if the op is still pending, so it never blocks forever); until
    then :attr:`done` is False.  :attr:`batch` is the coalesced batch's
    attributed ``OpResult`` (shared by every handle that rode the same
    flush); for a submission that flushed alone it *is* the result.  The
    per-lane values/found of a coalesced handle are views into the batch
    result — treat them as read-only.
    """

    __slots__ = ("op", "n", "batch", "_pipe", "_result", "_pre", "_sl")

    def __init__(self, pipe: "PipelineLayer", op: str, n: int):
        self.op = op
        self.n = n
        self.batch: OpResult | None = None
        self._pipe = pipe
        self._result: OpResult | None = None
        self._sl: slice | None = None  # our lanes inside ``batch`` (lazy)
        # write-combined lanes resolved before the flush:
        # (positions, values, found, wire_positions) or None
        self._pre = None

    @property
    def done(self) -> bool:
        return self._result is not None or self._sl is not None

    def result(self) -> OpResult:
        """The per-lane OpResult; flushes the pipeline if still pending.

        Executes pending work without draining the completion queue —
        other handles completed by the same flush stay pollable.
        """
        if self._result is None and self._sl is None:
            self._pipe._flush(trigger="explicit")
        if self._result is None:
            # lazy slice of the coalesced batch (views, built on demand —
            # most benchmark submissions never read their results)
            res, sl = self.batch, self._sl
            if res is None or sl is None:
                # the flush that carried this op aborted on an engine
                # exception (see PipelineLayer._flush): the op was lost
                raise RuntimeError(
                    f"submitted {self.op!r} op was lost: its flush "
                    f"aborted on an engine error before the "
                    f"{self.op!r} group ran; resubmit it")
            self._result = OpResult(
                values=res.values[sl], found=res.found[sl],
                statuses=None if res.statuses is None else res.statuses[sl])
        return self._result

    # ------------------------------------------------------ pipeline side
    def _finish(self, res: OpResult) -> None:
        self._result = res
        self._pipe._enqueue_done(self)

    def _adopt(self, res: OpResult) -> None:
        """Single-submission flush: the attributed batch result is ours."""
        self.batch = res
        self._finish(res)

    def _complete(self, res: OpResult, sl: slice) -> None:
        """Fill from the coalesced batch result (our lanes at ``sl``)."""
        self.batch = res
        if self._pre is None:
            self._sl = sl  # result() materialises the slice on demand
            self._pipe._enqueue_done(self)
            return
        pos, vals, found, wire = self._pre
        v = np.zeros(self.n, np.uint64)
        f = np.zeros(self.n, bool)
        v[pos], f[pos] = vals, found
        v[wire], f[wire] = res.values[sl], res.found[sl]
        self._finish(OpResult(values=v, found=f, statuses=None))

    def _combine_only(self, pos, vals, found) -> None:
        """Every lane was served from the write buffer: done already."""
        v = np.zeros(self.n, np.uint64)
        f = np.zeros(self.n, bool)
        v[pos], f[pos] = vals, found
        self._finish(OpResult(values=v, found=f, statuses=None))


class _Pending:
    """One enqueued submission.  ``keys``/``values`` stay exactly what
    ``submit`` received (a raw int for scalar submissions — cheap to
    enqueue, materialised into one array per kind at flush time)."""

    __slots__ = ("handle", "keys", "values", "n")

    def __init__(self, handle, keys, values, n):
        self.handle = handle
        self.keys = keys
        self.values = values
        self.n = n


def _gather(entries: list[_Pending], values: bool) -> np.ndarray:
    attr = "values" if values else "keys"
    if all(type(getattr(e, attr)) is int for e in entries):
        return np.fromiter((getattr(e, attr) for e in entries),
                           dtype=np.uint64, count=len(entries))
    return np.concatenate([
        x if isinstance(x, np.ndarray) else np.uint64([x])
        for x in (getattr(e, attr) for e in entries)])


class PipelineLayer(StoreLayer):
    """Outermost stack stage: the asynchronous submission/completion plane.

    Wraps the attributed sync stack (``Meter → [CNCache →] [Retry →]
    adapter``) and adds ``submit``/``poll``/``flush``.  The v1 sync
    surface remains as conveniences: batched ops are ``submit`` +
    ``flush`` (single-group pass-through keeps their attribution
    byte-identical), scalar ops flush pending work and take the engine's
    documented scalar protocol walk — so a default (``window=1``) store
    behaves exactly like the pre-pipeline stack, meters, traces and cache
    state included.
    """

    def __init__(self, inner, policy: BatchPolicy | None = None,
                 transport=None):
        super().__init__(inner)
        self.policy = (policy or BatchPolicy.sync()).validate()
        self.stats = PipelineStats()
        self._transport = transport
        self._q: dict[str, list[_Pending]] = {k: [] for k in OP_KINDS}
        self._n_pending = 0
        # strict-order hazard state: key -> (pending write kind, value)
        self._writes: dict[int, tuple[str, int | None]] = {}
        # write-combining reconciliation state (combine_reads only):
        # combined-lane records awaiting their buffered write's outcome,
        # the keys they forwarded, and each key's observed write success
        self._wc_records: list[tuple[OpHandle, np.ndarray, np.ndarray]] = []
        self._wc_keys: set[int] = set()
        self._wc_outcome: dict[int, bool] = {}
        self._done: collections.deque[OpHandle] = collections.deque()

    # ------------------------------------------------------------- submit
    def submit(self, op: str, keys, values=None) -> OpHandle:
        """Enqueue one op over ``keys`` (scalar or array); returns its
        :class:`OpHandle`.  May flush en route (window-full / hazard /
        non-coalesced kind)."""
        if op not in OP_KINDS:
            raise ValueError(f"unknown op kind {op!r}; one of {OP_KINDS}")
        writes = op in _WRITES
        if isinstance(keys, (int, np.integer)):
            keys = int(keys)
            n = 1
            if op in ("insert", "update"):
                if values is None:
                    raise ValueError(f"{op} requires values")
                values = int(values)
            else:
                values = None
        else:
            keys = np.atleast_1d(np.asarray(keys, dtype=np.uint64))
            n = int(keys.shape[0])
            if op in ("insert", "update"):
                if values is None:
                    raise ValueError(f"{op} requires values")
                values = np.atleast_1d(np.asarray(values, dtype=np.uint64))
                if values.shape != keys.shape:
                    raise ValueError(f"keys/values shape mismatch: "
                                     f"{keys.shape} vs {values.shape}")
            else:
                values = None
        self.stats.submitted += n
        handle = OpHandle(self, op, n)
        if op not in self.policy.coalesce:
            self._flush(trigger="explicit")
            handle._adopt(self._execute(op, _as_array(keys),
                                        _as_array(values)))
            return handle

        if self.policy.order == "strict":
            w = self._writes
            if op == "get" and w:
                if self.policy.combine_reads:
                    keys, n = self._combine(handle, keys, n)
                    if n == 0:
                        return handle  # fully served from the write buffer
                elif (keys in w if type(keys) is int
                      else any(int(k) in w for k in keys)):
                    self._flush(trigger="hazard")
            elif writes:
                if type(keys) is int:
                    if w and w.get(keys, (op,))[0] != op:
                        self._flush(trigger="hazard")
                        w = self._writes
                    w[keys] = (op, values)
                else:
                    if w and any(w.get(int(k), (op,))[0] != op
                                 for k in keys):
                        self._flush(trigger="hazard")
                        w = self._writes
                    if op == "delete":
                        for k in keys:
                            w[int(k)] = (op, None)
                    else:
                        for k, v in zip(keys, values):
                            w[int(k)] = (op, int(v))

        self._q[op].append(_Pending(handle, keys, values, n))
        self._n_pending += n
        if self._n_pending >= self.policy.window:
            self._flush(trigger="window")
        return handle

    def _combine(self, handle: OpHandle, keys, n: int):
        """Serve read lanes whose key has a pending write from the
        write-combining buffer; returns the wire-bound remainder."""
        w = self._writes
        if type(keys) is int:
            hit = np.asarray([keys in w])
            keys = np.uint64([keys])
        else:
            hit = np.asarray([int(k) in w for k in keys])
        n_hit = int(hit.sum())
        if n_hit == 0:
            return (int(keys[0]) if n == 1 else keys), n
        vals = np.zeros(n_hit, np.uint64)
        found = np.zeros(n_hit, bool)
        for j, k in enumerate(keys[hit]):
            kind, v = w[int(k)]
            if kind != "delete":
                vals[j] = v
                found[j] = True
        # a forwarded read is a locally-answered op: it saves this kind's
        # wire exactly as a CN-cache answer would (per-adapter savings)
        meter = self.inner.meter
        n_found = int(found.sum())
        if n_found:
            meter.add_wc_hit(n_found, **self.inner.cache_hit_savings)
        if n_hit - n_found:
            meter.add_wc_hit(n_hit - n_found, **self.inner.cache_neg_savings)
        self.stats.combined_reads += n_hit
        pos = np.nonzero(hit)[0]
        # remember the forwarded lanes: if the buffered write fails when
        # its flush runs, these answers were speculative and get re-read
        hit_keys = np.asarray(keys[hit], dtype=np.uint64).copy()
        self._wc_records.append((handle, pos, hit_keys))
        self._wc_keys.update(int(k) for k in hit_keys)
        if n_hit == n:
            handle._combine_only(pos, vals, found)
            return keys[:0], 0
        handle._pre = (pos, vals, found, np.nonzero(~hit)[0])
        return keys[~hit], n - n_hit

    # ------------------------------------------------------- poll / flush
    def _enqueue_done(self, handle: OpHandle) -> None:
        self._done.append(handle)
        if len(self._done) > DONE_BACKLOG_MAX:
            # fire-and-forget caller: age the oldest completion out of the
            # poll backlog (its handle keeps its result regardless)
            self._done.popleft()
            self.stats.dropped_completions += 1

    def poll(self) -> list[OpHandle]:
        """Drain the completion queue (non-blocking, executes nothing).

        The backlog is bounded (``DONE_BACKLOG_MAX``): a caller that never
        polls does not accumulate handles forever — aged-out completions
        are counted in ``stats.dropped_completions`` and remain fully
        readable through their own :class:`OpHandle`.
        """
        done = list(self._done)
        self._done.clear()
        return done

    def flush(self) -> list[OpHandle]:
        """Execute everything pending, then drain the completion queue."""
        self._flush(trigger="explicit")
        return self.poll()

    def _flush(self, *, trigger: str) -> None:
        """Execute pending ops; never drains ``_done`` (only ``poll`` /
        ``flush`` hand completions out, so auto-flushes inside ``submit``
        cannot eat handles the caller intends to poll).

        Exception-safe: if an engine batch op raises mid-flush (RACE/MICA
        bound-rejections surface as ``RuntimeError``), the failing group's
        handles never complete and the exception propagates, but every
        *later* group stays queued — with the pending-lane count and the
        strict-order hazard state rebuilt — so the next flush executes it,
        and an open doorbell window is still closed over whatever ops the
        aborted flush did record.
        """
        if not self._n_pending:
            return
        self.stats.flushes += 1
        if trigger == "window":
            self.stats.window_flushes += 1
        elif trigger == "hazard":
            self.stats.hazard_flushes += 1
        # open a doorbell window for the replay engine; its op count is
        # patched at close to what actually reached the trace (CN-cache
        # hits are answered locally and never cross the recorded wire)
        doorbell = (self._transport.begin_doorbell()
                    if self._transport is not None and self.policy.window > 1
                    else None)
        if self._writes:
            self._writes.clear()
        try:
            for kind in _FLUSH_ORDER:
                entries = self._q[kind]
                if not entries:
                    continue
                self._q[kind] = []
                self._run_group(kind, entries)
            self._n_pending = 0
            if self._wc_records:
                self._reconcile_combined()
        except BaseException:
            self._n_pending = sum(e.n for q in self._q.values() for e in q)
            if self.policy.order == "strict":
                self._rebuild_hazard_state()
            raise
        finally:
            if doorbell is not None:
                self._transport.close_doorbell(doorbell)

    def _reconcile_combined(self) -> None:
        """Fix up combined reads whose buffered write failed (satellite of
        the write-combining contract: polled answers must equal a
        ``combine_reads=False`` run's).

        A forwarded Update answered ``found=True`` with the new value,
        but the Update of an absent key missed; a forwarded Delete
        answered ``found=False``, but a frozen Delete left the key live.
        Any combined lane whose write reported failure is re-read for
        real — one metered ``get_batch`` inside the same flush,
        patched into the handle's already-delivered
        result arrays.  Runs after every group (writes execute last), so
        the re-read observes the flush's final state.

        If the flush aborted mid-way the records persist: the failed
        groups stay queued, their outcomes arrive at the next flush, and
        reconciliation happens then.
        """
        records, self._wc_records = self._wc_records, []
        outcome, self._wc_outcome = self._wc_outcome, {}
        self._wc_keys.clear()
        fixups = []
        for handle, pos, keys in records:
            if handle._result is None:
                continue  # lost to an aborted flush; nothing to patch
            bad = np.fromiter((not outcome.get(int(k), True) for k in keys),
                              dtype=bool, count=len(keys))
            if bad.any():
                fixups.append((handle, pos[bad], keys[bad]))
        if not fixups:
            return
        keys_all = np.concatenate([ks for _h, _p, ks in fixups])
        res = self.inner.get_batch(keys_all)
        self.stats.reconciled_reads += int(len(keys_all))
        off = 0
        for handle, pos, ks in fixups:
            n = len(ks)
            r = handle._result
            r.values[pos] = res.values[off:off + n]
            r.found[pos] = res.found[off:off + n]
            off += n

    def _rebuild_hazard_state(self) -> None:
        """Re-derive the pending-write map from what is still queued
        (after an aborted flush), so hazard detection and write combining
        keep honouring submissions the failed flush left behind."""
        for kind in _WRITES:
            for e in self._q[kind]:
                if type(e.keys) is int:
                    self._writes[e.keys] = (kind, e.values)
                elif kind == "delete":
                    for k in e.keys:
                        self._writes[int(k)] = (kind, None)
                else:
                    for k, v in zip(e.keys, e.values):
                        self._writes[int(k)] = (kind, int(v))

    def _run_group(self, kind: str, entries: list[_Pending]) -> None:
        self.stats.batch_calls += 1
        if len(entries) == 1 and entries[0].handle._pre is None:
            e = entries[0]
            e.handle._adopt(self._execute(kind, _as_array(e.keys),
                                          _as_array(e.values)))
            return
        keys = _gather(entries, values=False)
        values = (_gather(entries, values=True)
                  if kind in ("insert", "update") else None)
        res = self._execute(kind, keys, values)
        off = 0
        for e in entries:
            e.handle._complete(res, slice(off, off + e.n))
            off += e.n

    def _execute(self, kind: str, keys, values) -> OpResult:
        if kind == "get":
            res = self.inner.get_batch(keys)
        elif kind == "insert":
            res = self.inner.insert_batch(keys, values)
        elif kind == "update":
            res = self.inner.update_batch(keys, values)
        else:
            res = self.inner.delete_batch(keys)
        if res.statuses is not None:
            self.stats.unavailable_lanes += res.statuses.count("unavailable")
        if kind in _WRITES and self._wc_keys:
            # a combined read forwarded some of these writes' values:
            # record per-key success so reconciliation can spot the
            # speculative answers (later lanes overwrite earlier ones,
            # matching the write buffer's last-write-wins forwarding)
            for k, f in zip(keys, res.found):
                ki = int(k)
                if ki in self._wc_keys:
                    self._wc_outcome[ki] = bool(f)
        return res

    # --------------------------------------- v1 sync surface (deprecated)
    # The call-and-wait ops are kept as thin conveniences over the
    # pipeline — batched ops submit+flush (attribution preserved via the
    # single-group pass-through), scalar ops flush then take the engine's
    # scalar protocol walk.  New callers should submit/poll/flush; see
    # README §Async API for the migration table and deprecation policy.

    def _sync(self, handle: OpHandle) -> OpResult:
        """Resolve a convenience submission and unqueue it from ``poll``
        (its result is returned right here; everything else completed by
        the same flush stays pollable).  The handle was appended by the
        flush that just ran, so the reverse scan finds it in O(flush)."""
        res = handle.result()
        d = self._done
        for i, h in enumerate(reversed(d)):
            if h is handle:
                del d[len(d) - 1 - i]
                break
        return res

    def get_batch(self, keys, *,
                  resolve_makeup: bool | None = None) -> OpResult:
        if resolve_makeup is not None:
            # explicit-resolution calls bypass coalescing (the pipeline does
            # not own resolution); ordering is still preserved
            self._flush(trigger="explicit")
            return self.inner.get_batch(keys, resolve_makeup=resolve_makeup)
        return self._sync(self.submit("get", keys))

    def insert_batch(self, keys, values) -> OpResult:
        return self._sync(self.submit("insert", keys, values))

    def update_batch(self, keys, values) -> OpResult:
        return self._sync(self.submit("update", keys, values))

    def delete_batch(self, keys) -> OpResult:
        return self._sync(self.submit("delete", keys))

    def get(self, key: int) -> OpResult:
        self._flush(trigger="explicit")
        return self.inner.get(key)

    def insert(self, key: int, value: int) -> OpResult:
        self._flush(trigger="explicit")
        return self.inner.insert(key, value)

    def update(self, key: int, value: int) -> OpResult:
        self._flush(trigger="explicit")
        return self.inner.update(key, value)

    def delete(self, key: int) -> OpResult:
        self._flush(trigger="explicit")
        return self.inner.delete(key)

    # ----------------------------------------------------------- metering
    def meter_totals(self):
        return self.inner.meter_totals()

    def reset_meters(self) -> None:
        self.inner.reset_meters()


def _as_array(x):
    if x is None or isinstance(x, np.ndarray):
        return x
    return np.uint64([x])
