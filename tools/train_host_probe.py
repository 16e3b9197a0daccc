#!/usr/bin/env python3
"""Where a training step's host time goes, on one NVIDIA card.

    python3 tools/train_host_probe.py [--src PATH] [--steps N]

Imports ``repro_torch`` from ``PATH`` (default: this checkout's ``src``),
so two trees can be compared in one call (for example this one and an
unpacked ``git archive`` of its parent, in turns).  Prints the card's name
and power limit, then one JSON line:

- ``call_us``: the host time of one ``ops.fused_norm_matmul_bwd`` call at
  llama3.2-1b's bf16 training entries (S = d = 2048, F = 512, 2048,
  8192), median of 50 calls each timed alone on an empty queue;
- ``steps``: chip_smoke.py phase 14 (c)'s loop (llama3.2-1b at its
  published widths, B = 4 x 512, bf16), each step split into the host's
  enqueue (until ``step()`` returns), the total to a synchronize, the
  Python GC passes in it and the caching allocator's device allocations;
  medians over the steps after the first two.

Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def call_us(ops, torch) -> dict:
    out = {}
    for F in (512, 2048, 8192):
        S = d = 2048
        gen = torch.Generator(device="cuda").manual_seed(F)
        x, g, w, dy = (torch.randn(sh, generator=gen, device="cuda")
                       .bfloat16() for sh in ((S, d), (d,), (d, F), (S, F)))
        for _ in range(5):
            ops.fused_norm_matmul_bwd(x, g, w, dy)
        ts = []
        for _ in range(50):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ops.fused_norm_matmul_bwd(x, g, w, dy)
            ts.append((time.perf_counter() - t) * 1e6)
        torch.cuda.synchronize()
        out[F] = sorted(ts)[len(ts) // 2]
    return out


def steps(torch, n: int) -> dict:
    import numpy as np

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models.lm import LM
    from repro_torch.train import init_state, make_train_step
    passes = []

    def on_gc(phase, info):
        if phase == "start":
            on_gc.t = time.perf_counter()
        else:
            passes.append(time.perf_counter() - on_gc.t)
    gc.callbacks.append(on_gc)
    model = LM(get_config("llama3.2-1b"))
    state = init_state(model.init(0))
    step = make_train_step(model, TrainConfig(total_steps=40, warmup_steps=2,
                                              learning_rate=2e-3))
    toks = np.full((4, 512), 7, np.int32)
    batch = {"tokens": toks, "labels": toks}
    torch.cuda.synchronize()
    rows = []
    for _ in range(n):
        k, a0 = len(passes), torch.cuda.memory_stats().get(
            "num_device_alloc", 0)
        t = time.perf_counter()
        state, m = step(state, batch)
        t1 = time.perf_counter()
        float(m["loss"])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        rows.append(dict(
            enqueue_ms=(t1 - t) * 1e3, total_ms=(t2 - t) * 1e3,
            gc_ms=sum(passes[k:]) * 1e3,
            device_allocs=torch.cuda.memory_stats().get(
                "num_device_alloc", 0) - a0))
    gc.callbacks.remove(on_gc)
    tail = rows[2:]
    return dict({k: float(np.median([r[k] for r in tail]))
                 for k in tail[0]}, rows=rows)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    if not torch.cuda.is_available():
        print("train_host_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    build.build_all()
    print(json.dumps(dict(src=args.src, call_us=call_us(ops, torch),
                          steps=steps(torch, args.steps))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
