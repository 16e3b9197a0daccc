"""``repro_torch.serve.frontdoor`` — the serving ingress over the KVStore
stack.

The port of ``repro.serve.frontdoor``: host Python over the port's stack
(``submit``/``flush``, the meter, the telemetry hub), the same records,
outcomes and lane arrivals as the reference; the stack below does the
device work.

Everything below this module is a *library*: callers hand the pipeline
exactly the ops they want executed.  A service cannot afford that —
skewed tenant traffic duplicates hot gets, overload must shed rather
than queue without bound, and one abusive tenant must not price out the
rest.  :class:`FrontDoor` is the missing ingress between tenants and a
``repro_torch.api`` store stack, adding three controls that compose with (not
replace) the stack's own layers:

* **Singleflight** — concurrent identical Gets inside one front-door
  window collapse onto a single upstream lane; the followers share the
  leader's answer.  Each collapsed lane is metered exactly like a
  CN-cache hit (``CommMeter.add_sf_hit`` with the adapter's own
  ``cache_hit_savings``): the op happened, its wire costs land in the
  ``saved_*`` counters, and savings stay comparable across planes.
* **Admission control** — a deterministic M/D/c model of the upstream:
  ``max_inflight`` lanes of ``service_us`` each plus a bounded queue
  (``queue_depth``).  A request that would queue beyond the bound is
  shed *at arrival* (drop-tail — deterministic and explainable), so
  under overload latency stays bounded and goodput holds instead of the
  unbounded-queue collapse the ``slo`` bench demonstrates.
* **Per-tenant token buckets** — ``rate_ops_per_s`` sustained with
  ``burst`` headroom, refilled on the request clock (``t_s``), so an
  abusive tenant exhausts its own bucket and nobody else's p999.

Rejections are *typed answers*, never exceptions or hangs: every offered
request produces an :class:`FDRecord` whose ``outcome`` is one of
``ok | collapsed | shed | ratelimited | unavailable`` — the last being
the failure plane's degraded answer (``RetryLayer`` ran out of budget)
surfaced per lane, the FlexChain answer-don't-block idiom end to end.

**Dormant contract** (tested, like every plane in this repo): a
``FrontDoor(store)`` with the default config — no limits, no dedup, no
admission — forwards each request as the identical scalar ``submit`` a
direct caller would issue.  Meters, transport traces, and final MN state
are byte-for-byte those of calling the stack directly.

**Open-loop timing.** Requests carry arrival stamps (``t_s``, seconds —
typically from :func:`repro_torch.serve.traffic.generate`); the host plane
decides *outcomes* here, and the sim plane times them:
:meth:`lane_arrivals` returns each upstream lane's post instant (its
admission release time) in trace-op order, ready for
:func:`repro_torch.net.replay.simulate_open`.  The alignment relies on one
lane == one trace ``OpEvent``, which holds only with the CN cache off
(cache hits never reach the recorded wire) — timing runs build their
store accordingly, and the bench asserts the counts match.  Offers must
arrive in non-decreasing ``t_s`` order (the generator's output is).
"""

from __future__ import annotations

import collections
import dataclasses
import heapq

import numpy as np

# the pipeline's canonical flush grouping (repro_torch.api.pipeline._FLUSH_ORDER):
# the front-door window submits per-kind arrays in this same order, so a
# windowed FrontDoor and a hand-batching caller produce the same trace
_KIND_ORDER = ("get", "update", "insert", "delete")
_WRITES = frozenset(("update", "insert", "delete"))

OUTCOMES = ("ok", "collapsed", "shed", "ratelimited", "unavailable")


@dataclasses.dataclass(frozen=True)
class TenantLimit:
    """One tenant's token bucket: ``rate_ops_per_s`` sustained, ``burst``
    tokens of headroom.  Tenants without a limit are unlimited."""

    name: str
    rate_ops_per_s: float
    burst: float = 1.0

    def validate(self) -> "TenantLimit":
        if not self.name:
            raise ValueError("TenantLimit needs a non-empty tenant name")
        if self.rate_ops_per_s <= 0:
            raise ValueError(f"limit {self.name!r}: rate_ops_per_s must "
                             f"be > 0")
        if self.burst < 1:
            raise ValueError(f"limit {self.name!r}: burst must be >= 1 "
                             f"(a full bucket must admit one request)")
        return self

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json_dict(cls, d: dict) -> "TenantLimit":
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown TenantLimit fields: {sorted(extra)}")
        return cls(**d).validate()


@dataclasses.dataclass(frozen=True)
class FrontDoorConfig:
    """The ingress policy, frozen and JSON-round-trippable (recorded into
    bench rows next to the StoreSpec, like every other policy object).

    The default config is **dormant**: ``max_inflight=0`` (admission
    off), ``singleflight=False``, no limits — a pure pass-through with
    the byte-identity contract described in the module docstring.
    ``window`` is the collapse/batch scope once any feature is on:
    requests buffer until ``window`` lanes (or a cross-kind key hazard)
    close it, then submit per-kind in the pipeline's canonical order.
    """

    max_inflight: int = 0    # 0 = admission control off
    queue_depth: int = 0     # admitted-but-waiting bound (drop-tail shed)
    service_us: float = 2.0  # modeled per-lane upstream service time
    singleflight: bool = False
    window: int = 256        # front-door batch window / collapse scope
    limits: tuple = ()       # per-tenant TenantLimits (absent = unlimited)

    def __post_init__(self):
        ls = tuple(TenantLimit.from_json_dict(l) if isinstance(l, dict)
                   else l for l in self.limits)
        object.__setattr__(self, "limits", ls)

    @property
    def passthrough(self) -> bool:
        """True when every control is off — the dormant 1:1 forward."""
        return (not self.singleflight and self.max_inflight == 0
                and not self.limits)

    def validate(self) -> "FrontDoorConfig":
        if self.max_inflight < 0 or self.queue_depth < 0:
            raise ValueError("max_inflight and queue_depth must be >= 0")
        if self.max_inflight == 0 and self.queue_depth > 0:
            raise ValueError("queue_depth needs admission control "
                             "(max_inflight > 0) to mean anything")
        if self.service_us <= 0:
            raise ValueError("service_us must be > 0")
        if self.window < 1:
            raise ValueError("window must be >= 1")
        names = [l.name for l in self.limits]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant limits: {sorted(names)}")
        for l in self.limits:
            if not isinstance(l, TenantLimit):
                raise ValueError(f"limits must be TenantLimit, got "
                                 f"{type(l)}")
            l.validate()
        return self

    def to_json_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["limits"] = [l.to_json_dict() for l in self.limits]
        return d

    @classmethod
    def from_json_dict(cls, d: dict) -> "FrontDoorConfig":
        if not isinstance(d, dict):
            raise ValueError(f"FrontDoorConfig JSON must be an object, "
                             f"got {type(d).__name__}")
        known = {f.name for f in dataclasses.fields(cls)}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown FrontDoorConfig fields: "
                             f"{sorted(extra)}")
        d = dict(d)
        if "limits" in d:
            d["limits"] = tuple(d["limits"])
        return cls(**d).validate()


@dataclasses.dataclass
class FDRecord:
    """One offered request's full story through the front door.

    ``outcome`` is the typed answer (see :data:`OUTCOMES`); ``lane`` is
    the upstream lane index in trace-op order (-1 for requests that never
    went upstream; collapsed followers carry their *leader's* lane);
    ``release_s`` is when the request entered upstream service (equals
    ``t_s`` with admission off); ``found``/``result`` are the store's
    answer once the window flushed."""

    t_s: float
    tenant: str
    op: str
    key: int
    value: int | None = None
    outcome: str = "ok"
    lane: int = -1
    release_s: float = 0.0
    found: bool = False
    result: int = 0


class FrontDoor:
    """The ingress: rate limits → singleflight → admission → windowed
    submit into the store stack (see the module docstring for semantics).

    ``store`` is any assembled stack exposing the pipeline surface
    (``submit``/``flush``) — ``repro_torch.api.registry.open_store`` output.
    ``hub`` defaults to the store's own telemetry hub; with the telemetry
    plane dormant no counter is touched (the dormant contract covers the
    hub exactly as it covers the meter)."""

    def __init__(self, store, config: FrontDoorConfig | None = None,
                 hub=None):
        self.store = store
        self.config = (config or FrontDoorConfig()).validate()
        self.hub = hub if hub is not None else getattr(store, "hub", None)
        self.records: list[FDRecord] = []
        self._arrivals: list[float] = []  # lane post instants, trace order
        self._next_lane = 0
        self._last_t = float("-inf")
        # per-tenant token buckets: name -> [tokens, last_refill_t]
        self._limit_by_name = {l.name: l for l in self.config.limits}
        self._buckets = {l.name: [l.burst, 0.0] for l in self.config.limits}
        # admission M/D/c state: a heap of lane-free times + the starts of
        # admitted-but-waiting requests (monotone, so a deque suffices)
        self._free = ([0.0] * self.config.max_inflight
                      if self.config.max_inflight else None)
        self._qstarts: collections.deque[float] = collections.deque()
        # the open window
        self._win: dict[str, list[FDRecord]] = {k: [] for k in _KIND_ORDER}
        self._win_n = 0
        self._win_gets: dict[int, FDRecord] = {}  # key -> leader Get
        self._win_writes: set[int] = set()
        self._collapsed: list[tuple[FDRecord, FDRecord]] = []
        # passthrough mode: (record, OpHandle) pairs awaiting resolution
        self._pending: list[tuple[FDRecord, object]] = []

    # -------------------------------------------------------------- ingress
    def offer(self, tenant: str, op: str, key: int, value: int | None = None,
              t_s: float = 0.0) -> FDRecord:
        """Offer one request; returns its :class:`FDRecord` (whose
        ``found``/``result`` fill in once its window flushes)."""
        if op not in _KIND_ORDER:
            raise ValueError(f"unknown op kind {op!r}; one of {_KIND_ORDER}")
        if t_s < self._last_t:
            raise ValueError(f"offers must arrive in non-decreasing t_s "
                             f"order (got {t_s} after {self._last_t})")
        self._last_t = t_s
        rec = FDRecord(t_s=t_s, tenant=tenant, op=op, key=int(key),
                       value=None if value is None else int(value))
        self.records.append(rec)
        if self.config.passthrough:
            # dormant: the identical scalar submit a direct caller issues
            h = self.store.submit(op, rec.key, rec.value)
            rec.lane = self._next_lane
            self._next_lane += 1
            rec.release_s = t_s
            self._arrivals.append(t_s)
            self._pending.append((rec, h))
            return rec
        hub = self.hub
        # 1 — per-tenant token bucket (never touches the stack)
        bucket = self._buckets.get(tenant)
        if bucket is not None:
            lim = self._limit_by_name[tenant]
            tokens = min(lim.burst,
                         bucket[0] + (t_s - bucket[1]) * lim.rate_ops_per_s)
            if tokens < 1.0:
                bucket[0], bucket[1] = tokens, t_s
                rec.outcome = "ratelimited"
                if hub is not None:
                    hub.count("frontdoor.ratelimited", tenant=tenant)
                return rec
            bucket[0], bucket[1] = tokens - 1.0, t_s
        # 2 — strict-order hazards across the deferred window: a write to
        # a pending-Get key (or vice versa, or a second write kind to the
        # same key) closes the window first, exactly as the pipeline's
        # hazard flush would if the submits were not being deferred here
        k = rec.key
        if op == "get":
            if k in self._win_writes:
                self._close_window()
        elif k in self._win_gets or k in self._win_writes:
            self._close_window()
        # 3 — singleflight: a Get identical to a pending one becomes a
        # follower of that leader — no upstream lane, no admission slot
        if (op == "get" and self.config.singleflight
                and k in self._win_gets):
            leader = self._win_gets[k]
            rec.outcome = "collapsed"
            rec.release_s = t_s
            self._collapsed.append((rec, leader))
            self.store.meter.add_sf_hit(1, **self.store.cache_hit_savings)
            if hub is not None:
                hub.count("frontdoor.singleflight_hits")
                hub.count("frontdoor.admitted", tenant=tenant)
            return rec
        # 4 — admission: deterministic M/D/c with drop-tail shed
        release = t_s
        if self._free is not None:
            start = max(t_s, self._free[0])
            if start > t_s:
                q = self._qstarts
                while q and q[0] <= t_s:
                    q.popleft()  # those requests entered service already
                if len(q) >= self.config.queue_depth:
                    rec.outcome = "shed"
                    if hub is not None:
                        hub.count("frontdoor.shed", reason="queue_full")
                    return rec
                q.append(start)
            heapq.heapreplace(self._free,
                              start + self.config.service_us * 1e-6)
            release = start
            if hub is not None:
                hub.hist("frontdoor.queue_wait_us").record(
                    int(round((start - t_s) * 1e6)))
        rec.release_s = release
        if hub is not None:
            hub.count("frontdoor.admitted", tenant=tenant)
        # 5 — buffer into the window
        self._win[op].append(rec)
        self._win_n += 1
        if op == "get":
            self._win_gets.setdefault(k, rec)
        else:
            self._win_writes.add(k)
        if self._win_n >= self.config.window:
            self._close_window()
        return rec

    def run(self, offered) -> list[FDRecord]:
        """Offer a whole schedule (e.g. :func:`repro_torch.serve.traffic
        .generate` output) and flush; returns this call's records."""
        base = len(self.records)
        for r in offered:
            self.offer(r.tenant, r.op, r.key, r.value, r.t_s)
        self.flush()
        return self.records[base:]

    # ------------------------------------------------------------ execution
    def _close_window(self) -> None:
        """Submit the open window per-kind in canonical order, flush the
        stack, and distribute answers (leaders onto their followers)."""
        groups = []
        for kind in _KIND_ORDER:
            recs = self._win[kind]
            if not recs:
                continue
            keys = np.fromiter((r.key for r in recs), dtype=np.uint64,
                               count=len(recs))
            vals = None
            if kind in ("insert", "update"):
                vals = np.fromiter((r.value for r in recs),
                                   dtype=np.uint64, count=len(recs))
            groups.append((recs, self.store.submit(kind, keys, vals)))
        if groups:
            self.store.flush()
        hub = self.hub
        for recs, h in groups:
            res = h.result()
            statuses = res.statuses
            for i, r in enumerate(recs):
                r.lane = self._next_lane
                self._next_lane += 1
                self._arrivals.append(r.release_s)
                r.found = bool(res.found[i])
                r.result = int(res.values[i])
                if statuses is not None and statuses[i] == "unavailable":
                    r.outcome = "unavailable"
                    if hub is not None:
                        hub.count("frontdoor.unavailable", tenant=r.tenant)
        for follower, leader in self._collapsed:
            follower.lane = leader.lane
            follower.found = leader.found
            follower.result = leader.result
            if leader.outcome == "unavailable":
                follower.outcome = "unavailable"
                if hub is not None:
                    hub.count("frontdoor.unavailable",
                              tenant=follower.tenant)
        self._win = {k: [] for k in _KIND_ORDER}
        self._win_n = 0
        self._win_gets = {}
        self._win_writes = set()
        self._collapsed = []

    def flush(self) -> list[FDRecord]:
        """Close the open window (or resolve passthrough submissions) and
        flush the stack; returns all records so far."""
        if self.config.passthrough:
            self.store.flush()
            for rec, h in self._pending:
                res = h.result()
                rec.found = bool(res.found[0])
                rec.result = int(res.values[0])
                if res.statuses is not None \
                        and res.statuses[0] == "unavailable":
                    rec.outcome = "unavailable"
            self._pending = []
        else:
            self._close_window()
        return self.records

    # ------------------------------------------------------------- readouts
    def lane_arrivals(self) -> list[float]:
        """Each upstream lane's post instant, in trace-op order — the
        ``arrivals_s`` input of :func:`repro_torch.net.replay.simulate_open`.
        Meaningful only with the CN cache off (see module docstring)."""
        return list(self._arrivals)

    def stats(self) -> dict[str, int]:
        """Outcome counts over every record offered so far."""
        out = {"offered": len(self.records)}
        for o in OUTCOMES:
            out[o] = 0
        for r in self.records:
            out[r.outcome] += 1
        out["lanes"] = self._next_lane
        return out


__all__ = ["FDRecord", "FrontDoor", "FrontDoorConfig", "OUTCOMES",
           "TenantLimit"]
