"""TelemetryConfig + TelemetryHub — the deterministic telemetry plane.

The hub is a **pure observer**: it never mutates meters, transport
traces, or engine state, so a stack with telemetry on is contractually
byte-identical in those artifacts to one built without the hub (the
dormant-plane contract, held against the reference in
``tests/test_torch_obs.py``).  All timing comes from the op clock (count of
submitted op lanes) and simulated microseconds — never wall clock — so
every counter, histogram, snapshot and span is bit-identical across seeded
reruns.

Instruments:

* **counters** — monotonically increasing integers, keyed by flattened
  name ``name{k=v,...}`` with dimensions sorted (per-op-kind, per-shard,
  per-replica breakdowns are just dimensions);
* **gauges** — last-value floats (e.g. queue depth at flush);
* **histograms** — :class:`~repro_torch.obs.hist.LogHistogram` streams over
  RTs/bytes/lane counts/µs, merged exactly via integer bucket adds;
* **spans** — a bounded deque of :class:`~repro_torch.obs.span.Span` records
  annotated by every stack layer (see span.py for the taxonomy);
* **snapshots** — cumulative counter/gauge/histogram copies captured at
  each ``window_ops`` boundary of the op clock, the basis of the JSONL
  snapshot series in export.py.
"""

from __future__ import annotations

import collections
import dataclasses

from .hist import LogHistogram
from .span import Span


def _flat_key(name: str, dims: dict) -> str:
    """Flatten ``name`` + dims to the canonical ``name{k=v,...}`` key."""
    if not dims:
        return name
    inner = ",".join(f"{k}={dims[k]}" for k in sorted(dims))
    return f"{name}{{{inner}}}"


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Per-store telemetry settings (a ``StoreSpec.telemetry`` field).

    ``window_ops`` is the op-clock snapshot cadence (a cumulative
    snapshot is captured each time the submitted-lane count crosses a
    multiple); ``spans_max`` bounds the retained span deque (oldest
    evicted first).  Like ``BatchPolicy`` it is frozen, validated, and
    JSON-round-trippable so it travels inside ``StoreSpec``.
    """

    window_ops: int = 4096
    spans_max: int = 4096

    def validate(self) -> None:
        """Raise ``ValueError`` on non-positive cadence/bounds."""
        if self.window_ops <= 0:
            raise ValueError(f"window_ops must be > 0, got {self.window_ops}")
        if self.spans_max <= 0:
            raise ValueError(f"spans_max must be > 0, got {self.spans_max}")

    def to_json_dict(self) -> dict:
        """Serialise to a plain dict (inverse of :meth:`from_json_dict`)."""
        return {"window_ops": self.window_ops, "spans_max": self.spans_max}

    @classmethod
    def from_json_dict(cls, d: dict) -> "TelemetryConfig":
        """Rebuild from :meth:`to_json_dict` output; rejects unknown keys."""
        if not isinstance(d, dict):
            raise ValueError(f"telemetry config must be a dict, got {type(d)}")
        unknown = set(d) - {"window_ops", "spans_max"}
        if unknown:
            raise ValueError(f"unknown telemetry config fields: {sorted(unknown)}")
        cfg = cls(window_ops=int(d.get("window_ops", 4096)),
                  spans_max=int(d.get("spans_max", 4096)))
        cfg.validate()
        return cfg


class _WireSink(object):
    """A dim-tagged ``CommMeter`` sink feeding wire stats into the hub.

    One sink instance per meter (per replica / per shard / per table),
    with its counter keys precomputed in the constructor — ``add()`` is
    the hottest path in the stack, so the per-event work is four dict
    bumps and two histogram records.
    """

    __slots__ = ("hub", "dims", "_k_events", "_k_rts", "_k_bytes", "_k_cont")

    def __init__(self, hub: "TelemetryHub", dims: dict) -> None:
        self.hub = hub
        self.dims = dict(dims)
        self._k_events = _flat_key("wire.events", dims)
        self._k_rts = _flat_key("wire.round_trips", dims)
        self._k_bytes = _flat_key("wire.bytes", dims)
        self._k_cont = _flat_key("wire.makeup_continuations", dims)

    def on_meter_add(self, n: int, *, rts: int = 0, req: int = 0,
                     resp: int = 0, cont: int = 0, **_) -> None:
        """Observe one ``CommMeter.add`` (same signature as Transport's)."""
        hub = self.hub
        c = hub.counters
        c[self._k_events] = c.get(self._k_events, 0) + 1
        c[self._k_rts] = c.get(self._k_rts, 0) + int(rts)
        c[self._k_bytes] = c.get(self._k_bytes, 0) + int(req) + int(resp)
        if cont:
            c[self._k_cont] = c.get(self._k_cont, 0) + int(cont)
        hub.hist("wire.bytes_per_event", **self.dims).record(
            int(req) + int(resp))
        hub.hist("wire.rts_per_event", **self.dims).record(int(rts))


class TelemetryHub(object):
    """The central registry: counters, gauges, histograms, spans, snapshots.

    One hub instruments one assembled stack (``open_store`` builds it
    from ``StoreSpec.telemetry``).  Layers hold a reference and call the
    ``on_*``/span methods; everything is guarded at the call sites with
    ``if hub is not None`` so the dormant plane costs one branch.
    """

    def __init__(self, config: TelemetryConfig | None = None) -> None:
        self.config = config or TelemetryConfig()
        self.config.validate()
        self.clock = 0                      # op-clock: submitted op lanes
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        self.hists: dict[str, LogHistogram] = {}
        self.spans: collections.deque[Span] = collections.deque(
            maxlen=self.config.spans_max)
        self.snapshots: list[dict] = []     # cumulative, one per window
        self._next_snap = self.config.window_ops
        self._next_span_id = 0
        self.spans_opened = 0               # total ever (deque may evict)
        # the span the stack is currently executing under (set by the
        # pipeline around each flush/direct/scalar execution); lower
        # layers annotate it blindly via annotate()
        self.current_span: Span | None = None

    # ------------------------------------------------------------ registry
    def count(self, name: str, n: int = 1, **dims) -> None:
        """Bump counter ``name`` (with optional breakdown dimensions)."""
        key = _flat_key(name, dims)
        self.counters[key] = self.counters.get(key, 0) + int(n)

    def gauge(self, name: str, value: float, **dims) -> None:
        """Set gauge ``name`` to its latest value."""
        self.gauges[_flat_key(name, dims)] = float(value)

    def hist(self, name: str, **dims) -> LogHistogram:
        """The histogram registered under ``name`` + dims (created lazily)."""
        key = _flat_key(name, dims)
        h = self.hists.get(key)
        if h is None:
            h = self.hists[key] = LogHistogram()
        return h

    def wire_sink(self, **dims) -> _WireSink:
        """A dim-tagged ``CommMeter`` sink (per replica/shard/table)."""
        return _WireSink(self, dims)

    # --------------------------------------------------------------- clock
    def tick(self, n: int) -> None:
        """Advance the op clock by ``n`` submitted lanes; snapshot on
        window boundaries (multiple snapshots if ``n`` spans several)."""
        self.clock += int(n)
        while self.clock >= self._next_snap:
            self._capture_snapshot(self._next_snap)
            self._next_snap += self.config.window_ops

    def tick_to(self, clock: int) -> None:
        """Advance the op clock to an absolute submitted-lane count.

        The pipeline keeps the authoritative lane count in its (always-on)
        ``PipelineStats`` and syncs the hub at flush boundaries, so the
        submit hot path carries no per-op telemetry work at all.  Counters
        only mutate during flush execution, so snapshots captured here are
        byte-identical to per-submit ticking.  Non-monotonic calls are
        ignored."""
        if clock > self.clock:
            self.clock = int(clock)
            while self.clock >= self._next_snap:
                self._capture_snapshot(self._next_snap)
                self._next_snap += self.config.window_ops

    def _capture_snapshot(self, at_clock: int) -> None:
        # histograms are captured as cheap copies (serialising them here
        # would put JSON work on the flush path); the exporter converts
        self.snapshots.append({
            "clock": at_clock,
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "hists": {k: self.hists[k].copy() for k in sorted(self.hists)},
        })

    # --------------------------------------------------------------- spans
    def begin_span(self, kind: str, op: str, n: int,
                   trigger: str = "") -> Span:
        """Open a span at the current op clock and retain it."""
        s = Span(self._next_span_id, kind, op, int(n), self.clock, trigger)
        self._next_span_id += 1
        self.spans_opened += 1
        self.spans.append(s)
        return s

    def annotate(self, **kv) -> None:
        """Annotate the span currently executing, if any (layers below
        the pipeline don't know which span they run under — this is how
        Meter/CNCache/Retry/ReplicaSet facts land on the right one)."""
        s = self.current_span
        if s is not None:
            s.annotate(**kv)

    # ------------------------------------------------------- layer hooks
    def on_op(self, op: str, n: int, *, round_trips: int = 0,
              req_bytes: int = 0, resp_bytes: int = 0, makeups: int = 0,
              retries: int = 0, backoffs: int = 0,
              failovers: int = 0) -> None:
        """MeterLayer hook: per-op-kind attribution of one stack call."""
        self.count("ops", n, op=op)
        self.count("op.round_trips", round_trips, op=op)
        self.count("op.bytes", req_bytes + resp_bytes, op=op)
        if makeups:
            self.count("op.makeups", makeups, op=op)
        if retries:
            self.count("op.retries", retries, op=op)
        if backoffs:
            self.count("op.backoffs", backoffs, op=op)
        if failovers:
            self.count("op.failovers", failovers, op=op)
        if n > 0:
            self.hist("op.rts_per_lane", op=op).record(round_trips / n, n)
            self.hist("op.bytes_per_lane", op=op).record(
                (req_bytes + resp_bytes) / n, n)

    def on_cache(self, hits: int, negs: int, misses: int) -> None:
        """CNCacheLayer hook: probe outcomes for one get batch."""
        if hits:
            self.count("cache.hits", hits)
        if negs:
            self.count("cache.neg_hits", negs)
        if misses:
            self.count("cache.misses", misses)

    # ------------------------------------------------------------ queries
    def totals(self) -> dict:
        """Cumulative counters/gauges/hists right now (snapshot-shaped:
        histogram values are :class:`LogHistogram` copies; the exporter
        serialises them)."""
        return {"clock": self.clock,
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "hists": {k: self.hists[k].copy()
                          for k in sorted(self.hists)}}

    def merge(self, other: "TelemetryHub") -> "TelemetryHub":
        """Fold another hub's counters/hists in (exact integer adds)."""
        for k, v in other.counters.items():
            self.counters[k] = self.counters.get(k, 0) + v
        self.gauges.update(other.gauges)
        for k, h in other.hists.items():
            mine = self.hists.get(k)
            if mine is None:
                self.hists[k] = h.copy()
            else:
                mine.merge(h)
        return self

    def __repr__(self) -> str:
        return (f"TelemetryHub(clock={self.clock}, "
                f"counters={len(self.counters)}, hists={len(self.hists)}, "
                f"spans={len(self.spans)}, snapshots={len(self.snapshots)})")


__all__ = ["TelemetryConfig", "TelemetryHub"]
