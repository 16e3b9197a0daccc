"""``repro_torch.obs`` — the deterministic telemetry plane.

The port of ``repro.obs``: host Python and numpy, no device work, and
identical to the reference in every counter, histogram bucket, span,
snapshot and export.  A :class:`TelemetryHub` instruments an assembled
``repro_torch.api`` stack
with counters, gauges, log-bucketed histograms, op-clock snapshots and
layer-annotated spans; exporters turn the hub into ``outback-telemetry/v1``
JSONL and a recorded transport trace into Chrome-tracing/Perfetto JSON.
Everything is keyed to the op clock and simulated microseconds — never
wall time — so exports are bit-identical across seeded reruns, and the
hub is a pure observer: with telemetry off (or on), the stack's meters,
traces, and final store state are byte-identical to a stack built
without it.  The hub adds no device op and no host-device copy: every
value it records is one the stack already holds on the host.  See
docs/OBSERVABILITY.md.
"""

from repro_torch.obs.export import (TELEMETRY_SCHEMA, chrome_trace,
                                    pipeline_row, read_jsonl, sim_rows,
                                    telemetry_rows, validate_telemetry_rows,
                                    write_jsonl)
from repro_torch.obs.hist import HIST_SPEC, LogHistogram
from repro_torch.obs.hub import TelemetryConfig, TelemetryHub
from repro_torch.obs.span import SPAN_KINDS, Span

__all__ = [
    "HIST_SPEC",
    "LogHistogram",
    "SPAN_KINDS",
    "Span",
    "TELEMETRY_SCHEMA",
    "TelemetryConfig",
    "TelemetryHub",
    "chrome_trace",
    "pipeline_row",
    "read_jsonl",
    "sim_rows",
    "telemetry_rows",
    "validate_telemetry_rows",
    "write_jsonl",
]
