#!/usr/bin/env python3
"""Phase 12 of ``chip_smoke.py`` alone, on one NVIDIA card.

    python3 tools/cluster_probe.py

Prints the card's name and power limit, builds the kernels, then runs
``chip_smoke.serve_cluster_phase`` over phase 3's 2^24 keys and values:
the telemetry-on stores and the chaos harness on the card against the
CPU at 2^14 keys and the N=1 cluster against ``open_store``
(``chip_smoke.obs_agreement_check``), the telemetry plane's cost
(``chip_smoke.telemetry_cost``), the 4-CN cluster with a join and a
leave (``chip_smoke.serve_cluster``) and the large chaos run
(``chip_smoke.large_chaos``), each part's seconds logged.  Prints the
numbers as one JSON line.  Without a card it exits 1.
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("cluster_probe: torch.cuda.is_available() is false; this "
              "probe needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.hashing import splitmix64
    from repro_torch.kernels import build
    t_start = time.perf_counter()
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0])
    cs.log(sys.version.split()[0], torch.__version__, torch.version.cuda)
    cs.log(f"kernel build: {build.build_all():.3f} s")
    rng = np.random.default_rng(cs.SEED)
    n = 1 << cs.N_KEYS_LOG2
    keys = splitmix64(np.arange(n, dtype=np.uint64)
                      + np.uint64(cs._KEY_OFFSET))
    vals = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    t = time.perf_counter()
    res, launches = cs.serve_cluster_phase(keys, vals, rng)
    cs.log(f"launches on the cluster's path: {launches}")
    cs.log(f"phase 12: {time.perf_counter() - t:.1f} s")
    print(json.dumps(dict(cluster=res, launches=launches)))
    cs.log(f"total: {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
