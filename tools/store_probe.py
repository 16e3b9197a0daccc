#!/usr/bin/env python3
"""Phase 8 of ``chip_smoke.py`` alone, with the host cost of a device op
beside it, on one NVIDIA card.

    python3 tools/store_probe.py

Prints the card's name and power limit, then:

1. the host time of three small device operations (an in-place add on
   1024 float32, a gather of 256 of them, a 16-byte copy back to the
   host), three times in a fresh process and again after a
   ``torch.profiler`` session: what one more torch op costs the cached
   store's window;
2. builds the kernels and runs ``chip_smoke.store_agreement_check`` (a
   small cached ``outback-dir`` store on the card against the CPU);
3. runs ``chip_smoke.serve_directory`` over the 2^24 keys of phase 3
   (YCSB-C, YCSB-A and a split of table 0 through the cached store) and
   prints its numbers as one JSON line.

About 3 minutes of command, against about 7 for the whole
``chip_smoke.py``.  Without a card it exits 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def host_op_us(x, idx, n: int = 4000) -> dict:
    """Mean host µs of an in-place add, a gather and a 16-byte copy back."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    add = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n // 4):
        x[idx]
    torch.cuda.synchronize()
    gather = (time.perf_counter() - t0) / (n // 4) * 1e6
    t0 = time.perf_counter()
    for _ in range(n // 4):
        x[:4].cpu()
    copy = (time.perf_counter() - t0) / (n // 4) * 1e6
    return dict(add_us=add, gather_us=gather, copy_back_us=copy)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("store_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.hashing import splitmix64
    from repro_torch.kernels import build
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)

    x = torch.zeros(1024, device="cuda")
    idx = torch.arange(0, 1024, 4, device="cuda")
    for i in range(3):
        print(f"host op cost, fresh {i}: {json.dumps(host_op_us(x, idx))}",
              flush=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            x.add_(1)
        torch.cuda.synchronize()
    prof.key_averages()
    print(f"host op cost, after a profiler session: "
          f"{json.dumps(host_op_us(x, idx))}", flush=True)

    print(f"kernel build: {build.build_all():.3f} s", flush=True)
    t0 = time.perf_counter()
    cs.store_agreement_check(cs.SEED)
    print(f"agreement: {time.perf_counter() - t0:.3f} s", flush=True)
    rng = np.random.default_rng(cs.SEED)
    n = 1 << cs.N_KEYS_LOG2
    keys = splitmix64(np.arange(n, dtype=np.uint64)
                      + np.uint64(cs._KEY_OFFSET))
    vals = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    t0 = time.perf_counter()
    res = cs.serve_directory(keys, vals, rng)
    print(f"serve_directory: {time.perf_counter() - t0:.3f} s", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
