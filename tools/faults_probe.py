#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` alone, on one NVIDIA card.

    python3 tools/faults_probe.py

Prints the card's name and power limit, builds the kernels, then runs
``chip_smoke.serve_faults`` over phase 3's 2^24 keys and values: the
replicated, faulted stores on the card against the CPU at 2^14 keys
(``chip_smoke.fault_agreement_check``), the K=2 crash run at full size
(``chip_smoke.serve_replicated``), the modelled tail, the K=1 crash and
the dormant plane at 2^20 keys.  Prints the numbers as one JSON line.
Without a card it exits 1.
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
        print("faults_probe: torch.cuda.is_available() is false; this "
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
    res, launches = cs.serve_faults(keys, vals, rng)
    cs.log(f"launches on the replicated path: {launches}")
    print(json.dumps(dict(faults=res, launches=launches)))
    cs.log(f"total: {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
