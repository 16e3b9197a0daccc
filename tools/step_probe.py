#!/usr/bin/env python3
"""Where a llama3.2-1b decode step spends its host time, on one NVIDIA card.

    python3 tools/step_probe.py

Prints the card's name and power limit, then, for ``LM(llama3.2-1b)`` at
full width with random bf16 weights from seed 0 and 8 lanes (the model of
``chip_smoke.py`` phase 7):

- the host time of a synced ``decode_step`` (p50 of 16 steps);
- ``torch.profiler`` over 8 steps with host and device activities: the
  host operations with the most self time, and the device busy time;
- the host time of one ``ops.fused_norm_matmul`` call issued back to back
  without a sync (S=8, d=2048, F=2048, bf16), and, where the tree has a
  plan (``ops.fused_norm_matmul_plan``), of its parts: the plan, the
  workspace allocation and the ``ctypes`` launch.

It imports the ``repro_torch`` and ``chip_smoke.py`` of the tree it sits
in, so a copy in an unpacked older tree measures that tree: to compare two
trees on one card, run both copies in one call, in turns (old, new, new,
old).  With ``--no-profile`` it skips the profiler's table.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

LANES, STEPS, PROFILED, CALLS = 8, 16, 8, 2000


def host_us(fn, n: int) -> float:
    """Mean host time of ``fn`` over ``n`` calls, no sync between them."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("step_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, ops
    from repro_torch.models.lm import LM
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    build.build_all()
    model = LM(get_config("llama3.2-1b"))
    params = model.init(0)
    cache = model.init_cache(LANES, 256)
    tokens = torch.ones((LANES, 1), dtype=torch.int32, device="cuda")
    for _ in range(2):
        _, cache = model.decode_step(params, tokens, cache)
    torch.cuda.synchronize()
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, tokens, cache)
        tokens = torch.argmax(logits, -1).int()[:, None]
        tokens.tolist()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"decode_step (synced, {STEPS} steps): p50 "
          f"{np.percentile(times, 50):.4f} ms", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            logits, cache = model.decode_step(params, tokens, cache)
            tokens = torch.argmax(logits, -1).int()[:, None]
            tokens.tolist()
        torch.cuda.synchronize()
    busy, n_ops = cs.device_busy_us(prof)
    print(f"profiled: {busy / PROFILED / 1e3:.4f} ms of device time and "
          f"{n_ops / PROFILED:.1f} device ops a step", flush=True)
    if "--no-profile" not in sys.argv:
        print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                        row_limit=25), flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    x, g, w = cs.fnm_inputs(gen, 8, 2048, 2048, torch.bfloat16)[0]
    print(f"host time of ops.fused_norm_matmul: "
          f"{host_us(lambda: ops.fused_norm_matmul(x, g, w), CALLS):.2f} us "
          f"a call", flush=True)
    if not hasattr(ops, "fused_norm_matmul_plan"):
        return 0
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ops.fused_norm_matmul_plan(8, 2048, 2048, 2, n_sm)
    n_ws = ops.fused_norm_matmul_workspace(plan, 8, 2048, 2048, 2)
    fn = build.launcher("fused_norm_matmul")
    ws = torch.empty(n_ws, device="cuda")
    out = torch.empty((8, 2048), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    parts = {
        "plan + workspace size": lambda: ops.fused_norm_matmul_workspace(
            ops.fused_norm_matmul_plan(8, 2048, 2048, 2, n_sm), 8, 2048,
            2048, 2),
        "torch.empty (workspace and output)": lambda: (
            torch.empty(n_ws, device="cuda"),
            torch.empty((8, 2048), dtype=torch.bfloat16, device="cuda")),
        "ctypes launch (both kernels)": lambda: fn(
            x.data_ptr(), g.data_ptr(), w.data_ptr(), out.data_ptr(),
            ws.data_ptr(), 8, 2048, 2048, 1, ops.NORM_EPS, 3, plan["splits"],
            plan["krange"], stream),
        "torch.add (a small eager op)": lambda: x + x,
    }
    for name, f in parts.items():
        print(f"host time of {name}: {host_us(f, CALLS):.2f} us a call",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
