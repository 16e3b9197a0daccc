"""Exporters: ``outback-telemetry/v1`` JSONL rows + Chrome-trace JSON.

Two deterministic export formats (both documented in
docs/OBSERVABILITY.md):

1. **JSONL snapshot series** (:func:`telemetry_rows` →
   :func:`write_jsonl`): a meta row (config + histogram bucket spec),
   one cumulative snapshot row per op-clock window, a final total row,
   and one row per retained span.  Every row carries
   ``schema == "outback-telemetry/v1"``; :func:`validate_telemetry_rows`
   is the checker.  Rows serialise with sorted
   keys, so the byte stream is bit-identical across seeded reruns.

2. **Chrome-tracing / Perfetto JSON** (:func:`chrome_trace`): replays a
   recorded transport trace through :func:`repro_torch.net.replay.simulate`
   with ``record_spans=True`` and emits a ``{"traceEvents": [...]}``
   document — per-client op slices with nested per-round-trip child
   slices, MN CPU/NIC busy slices, resize/fault windows, and doorbell
   instants.  Timestamps are simulated microseconds (``ts``/``dur``),
   so a YCSB or faults run opens directly in ``chrome://tracing`` or
   https://ui.perfetto.dev.
"""

from __future__ import annotations

import dataclasses
import json

from .hist import HIST_SPEC, LogHistogram
from .hub import TelemetryHub

TELEMETRY_SCHEMA = "outback-telemetry/v1"

_ROW_KINDS = ("meta", "snapshot", "total", "span", "sim", "pipeline")


# --------------------------------------------------------------- JSONL rows
def telemetry_rows(hub: TelemetryHub) -> list[dict]:
    """Flatten a hub into ``outback-telemetry/v1`` rows.

    Row order is meta → snapshots (op-clock order) → total → spans
    (span-id order); each carries the schema tag.
    """
    rows: list[dict] = [{
        "schema": TELEMETRY_SCHEMA, "row": "meta",
        "config": hub.config.to_json_dict(),
        "hist_spec": dict(HIST_SPEC),
        "clock": hub.clock,
        "spans_opened": hub.spans_opened,
        "n_snapshots": len(hub.snapshots),
    }]
    for snap in hub.snapshots:
        rows.append({"schema": TELEMETRY_SCHEMA, "row": "snapshot",
                     **_jsonify_snap(snap)})
    rows.append({"schema": TELEMETRY_SCHEMA, "row": "total",
                 **_jsonify_snap(hub.totals())})
    for span in hub.spans:
        rows.append({"schema": TELEMETRY_SCHEMA, "row": "span",
                     **span.to_json_dict()})
    return rows


def _jsonify_snap(snap: dict) -> dict:
    """Serialise a hub snapshot's LogHistogram values (the hub keeps
    copies, not JSON, to keep serialisation off the flush path)."""
    return {**snap, "hists": {k: h.to_json_dict()
                              for k, h in snap["hists"].items()}}


def sim_rows(result, name: str = "sim") -> list[dict]:
    """Rows for a :class:`repro_torch.net.replay.SimResult`: one ``sim`` row
    embedding the bucketed latency histogram, the exact percentiles the
    benches already report, and the ``outback-availability/v1`` curve."""
    hist = LogHistogram()
    hist.record_many(result.latencies_us)
    row = {"schema": TELEMETRY_SCHEMA, "row": "sim", "name": name,
           "n_ops": int(result.n_ops), "seconds": float(result.seconds),
           "tput_mops": float(result.tput_mops),
           "latency_hist": hist.to_json_dict(),
           "availability": result.availability()}
    row.update(result.percentiles())
    return [row]


def pipeline_row(stats) -> dict:
    """One ``pipeline`` row from a
    :class:`repro_torch.api.pipeline.PipelineStats`."""
    return {"schema": TELEMETRY_SCHEMA, "row": "pipeline",
            **dataclasses.asdict(stats)}


def write_jsonl(rows: list[dict], path: str) -> None:
    """Write rows as sorted-key JSONL (bit-identical across reruns)."""
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r, sort_keys=True) + "\n")


def read_jsonl(path: str) -> list[dict]:
    """Read rows written by :func:`write_jsonl`."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def validate_telemetry_rows(rows: list[dict]) -> None:
    """Raise ``ValueError`` unless ``rows`` is a well-formed v1 export.

    Checks: schema tag on every row, known row kinds, a leading meta row
    whose histogram bucket spec matches this build, snapshot clocks
    strictly increasing on window boundaries, histogram payloads that
    reconstruct, and span/sim/pipeline required fields.  This is the
    checker for an export.
    """
    if not rows:
        raise ValueError("empty telemetry export")
    for i, r in enumerate(rows):
        if r.get("schema") != TELEMETRY_SCHEMA:
            raise ValueError(f"row {i}: bad schema {r.get('schema')!r}")
        if r.get("row") not in _ROW_KINDS:
            raise ValueError(f"row {i}: unknown row kind {r.get('row')!r}")
    meta = rows[0]
    if meta["row"] != "meta":
        raise ValueError("first row must be the meta row")
    if meta["hist_spec"] != HIST_SPEC:
        raise ValueError(f"meta hist_spec mismatch: {meta['hist_spec']!r}")
    window = int(meta["config"]["window_ops"])
    snaps = [r for r in rows if r["row"] == "snapshot"]
    if len(snaps) != meta["n_snapshots"]:
        raise ValueError(f"meta says {meta['n_snapshots']} snapshots, "
                         f"found {len(snaps)}")
    prev = 0
    for s in snaps:
        if s["clock"] <= prev or s["clock"] % window != 0:
            raise ValueError(f"snapshot clock {s['clock']} not a strictly "
                             f"increasing multiple of {window}")
        prev = s["clock"]
    for r in rows:
        for h in r.get("hists", {}).values():
            LogHistogram.from_json_dict(h)  # reconstructs or raises
        if r["row"] == "span":
            for field in ("span_id", "kind", "op", "n", "clock", "ann"):
                if field not in r:
                    raise ValueError(f"span row missing {field!r}")
        if r["row"] == "sim":
            LogHistogram.from_json_dict(r["latency_hist"])
            av = r["availability"]
            if av["schema"] != "outback-availability/v1":
                raise ValueError(f"bad availability schema {av['schema']!r}")
        if r["row"] == "pipeline" and "submitted" not in r:
            raise ValueError("pipeline row missing 'submitted'")
    totals = [r for r in rows if r["row"] == "total"]
    if len(totals) != 1:
        raise ValueError(f"expected exactly one total row, got {len(totals)}")


# ------------------------------------------------------------- Chrome trace
def chrome_trace(trace, **sim_kwargs) -> dict:
    """Replay ``trace`` and export it as Chrome-tracing/Perfetto JSON.

    ``sim_kwargs`` forward to :func:`repro_torch.net.replay.simulate`
    (``clients``, ``window``, ``replicas``, ...).  The returned dict has
    a single ``traceEvents`` list: pid 1 = CN clients (one tid per
    client; each op is an ``X`` slice with nested per-round-trip child
    slices tagged by serving replica and one-sidedness), pid 2 = MN
    servers (one tid per CPU/NIC server, busy slices per started batch),
    pid 3 = windows (resize + fault ``X`` slices), plus doorbell ``i``
    instants.  All times are simulated microseconds.
    """
    from repro_torch.net.replay import simulate

    res = simulate(trace, record_spans=True, **sim_kwargs)
    ev: list[dict] = [
        {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
         "args": {"name": "CN clients"}},
        {"ph": "M", "pid": 2, "tid": 0, "name": "process_name",
         "args": {"name": "MN servers"}},
        {"ph": "M", "pid": 3, "tid": 0, "name": "process_name",
         "args": {"name": "windows"}},
    ]
    us = 1e6
    for i, op in enumerate(res.op_spans):
        tid = op["cid"]
        ev.append({"ph": "X", "pid": 1, "tid": tid, "name": "op",
                   "ts": op["t0_s"] * us,
                   "dur": (op["t1_s"] - op["t0_s"]) * us,
                   "args": {"index": i, "cn_hash": op["cn_hash"],
                            "cn_cmp": op["cn_cmp"],
                            "segments": len(op["segs"])}})
        for si, seg in enumerate(op["segs"]):
            name = "rt(1-sided)" if seg["one_sided"] else "rt"
            ev.append({"ph": "X", "pid": 1, "tid": tid, "name": name,
                       "ts": seg["t0_s"] * us,
                       "dur": (seg["t1_s"] - seg["t0_s"]) * us,
                       "args": {"op": i, "seg": si, "mn": seg["mn"],
                                "wait_us": seg["wait_s"] * us}})
    srv_tids: dict[str, int] = {}
    for start, svc, sname in res.server_spans:
        tid = srv_tids.setdefault(sname, len(srv_tids) + 1)
        ev.append({"ph": "X", "pid": 2, "tid": tid, "name": sname,
                   "ts": start * us, "dur": svc * us, "args": {}})
    for sname, tid in srv_tids.items():
        ev.append({"ph": "M", "pid": 2, "tid": tid, "name": "thread_name",
                   "args": {"name": sname}})
    for t0, t1 in res.resize_windows:
        ev.append({"ph": "X", "pid": 3, "tid": 1, "name": "resize",
                   "ts": t0 * us, "dur": (t1 - t0) * us, "args": {}})
    for t0, t1, kind, replica in res.fault_windows:
        ev.append({"ph": "X", "pid": 3, "tid": 2, "name": kind,
                   "ts": t0 * us, "dur": (t1 - t0) * us,
                   "args": {"replica": replica}})
    for t, n_ops in res.doorbell_ts:
        ev.append({"ph": "i", "pid": 1, "tid": 0, "name": "doorbell",
                   "ts": t * us, "s": "p", "args": {"n_ops": n_ops}})
    return {"traceEvents": ev, "displayTimeUnit": "ns"}


__all__ = ["TELEMETRY_SCHEMA", "telemetry_rows", "sim_rows", "pipeline_row",
           "write_jsonl", "read_jsonl", "validate_telemetry_rows",
           "chrome_trace"]
