"""Render the dry run's JSON cells into the EXPERIMENTS.md tables: the
reference's ``launch/report.py`` over ``experiments/dryrun_torch/``.

``roofline_table`` gives the reference's string for the same cell dicts;
``dryrun_table`` shows ``trace_s`` (the port traces a rank's program, see
``launch/dryrun.py``) where the reference shows ``compile_s``.

    python -m repro_torch.launch.report [DIR]
"""

from __future__ import annotations

import glob
import json
import os
import sys

ORDER = ["jamba-v0.1-52b", "qwen3-4b", "qwen2.5-14b", "llama3.2-1b",
         "llama3.2-3b", "llava-next-mistral-7b", "mixtral-8x22b",
         "deepseek-v3-671b", "rwkv6-1.6b", "whisper-large-v3"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_cells(dirname: str) -> dict:
    cells = {}
    for f in glob.glob(os.path.join(dirname, "*.json")):
        with open(f) as fh:
            r = json.load(fh)
        if "shape" not in r:
            continue
        mesh = "pod2" if ("pod2" in f or r.get("mesh") == "2x16x16") else "pod1"
        cells[(r["arch"], r["shape"], mesh)] = r
    return cells


def fmt_s(x):
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def roofline_table(cells: dict, mesh: str = "pod1") -> str:
    rows = ["| arch | shape | compute | memory | collective | dominant | "
            "MODEL/HLO flops | MFU@roofline | temp GB/dev |",
            "|---|---|---|---|---|---|---|---|---|"]
    for a in ORDER:
        for s in SHAPES:
            r = cells.get((a, s, mesh))
            if r is None:
                continue
            if r["status"] == "skip":
                rows.append(f"| {a} | {s} | — | — | — | SKIP | — | — | — |")
                continue
            rl = r["roofline"]
            tmp = r["memory_analysis"].get("temp_size_in_bytes", 0) / 1e9
            rows.append(
                f"| {a} | {s} | {fmt_s(rl['compute_s'])} | "
                f"{fmt_s(rl['memory_s'])} | {fmt_s(rl['collective_s'])} | "
                f"{rl['dominant']} | {rl['useful_flops_ratio']:.2f} | "
                f"{rl['mfu']:.3f} | {tmp:.1f} |")
    return "\n".join(rows)


def dryrun_table(cells: dict) -> str:
    rows = ["| arch | shape | mesh | status | trace_s | args GB/dev | "
            "coll GB/dev | top collective |",
            "|---|---|---|---|---|---|---|---|"]
    for a in ORDER:
        for s in SHAPES:
            for mesh in ("pod1", "pod2"):
                r = cells.get((a, s, mesh))
                if r is None:
                    continue
                if r["status"] == "skip":
                    rows.append(f"| {a} | {s} | {mesh} | SKIP | — | — | — | — |")
                    continue
                rl = r["roofline"]
                args = r["memory_analysis"].get(
                    "argument_size_in_bytes",
                    r["memory_analysis"].get("arguments_per_device_estimate", 0))
                top = max(rl["coll_by_kind"], key=rl["coll_by_kind"].get) \
                    if rl["coll_by_kind"] else "-"
                rows.append(
                    f"| {a} | {s} | {mesh} | ok | {r['trace_s']} | "
                    f"{args / 1e9:.2f} | {rl['coll_bytes_per_device'] / 1e9:.2f} "
                    f"| {top} |")
    return "\n".join(rows)


def pick_hillclimb(cells: dict) -> list[tuple]:
    """worst MFU, most collective-bound, most paper-representative."""
    ok = [(k, v) for k, v in cells.items()
          if v["status"] == "ok" and k[2] == "pod1"]
    worst = min(ok, key=lambda kv: kv[1]["roofline"]["mfu"])
    coll = max(ok, key=lambda kv: (kv[1]["roofline"]["collective_s"]
                                   / max(kv[1]["roofline"]["step_time_s"], 1e-12)))
    return [("worst-mfu", *worst[0]), ("most-collective", *coll[0]),
            ("paper-representative", "llama3.2-1b", "decode_32k", "pod1")]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "experiments",
        "dryrun_torch")
    cells = load_cells(d)
    print("## Dry-run (both meshes)\n")
    print(dryrun_table(cells))
    print("\n## Roofline (single pod 16x16)\n")
    print(roofline_table(cells))
    print("\n## Hillclimb candidates\n")
    for t in pick_hillclimb(cells):
        print(" ", t)


if __name__ == "__main__":
    main()
