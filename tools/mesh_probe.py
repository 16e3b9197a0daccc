#!/usr/bin/env python3
"""Phase 10 of ``chip_smoke.py`` alone, on one NVIDIA card.

    python3 tools/mesh_probe.py

Prints the card's name and power limit, builds the kernels, then runs
``chip_smoke.serve_on_mesh`` over phase 3's 2^24 keys and values: a world
of this one process (gloo for CPU tensors, NCCL for the card's), the
(1, 1) mesh on the card against the CPU at 2^14 keys
(``chip_smoke.mesh_agreement_check``), then the full-size ``sharded``
store, YCSB-C through its adapter and the mesh Get of both variants in
calls of 1024 and 2^16 lanes, plain and cached
(``chip_smoke.serve_mesh``).  Prints the numbers as one JSON line.
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
        print("mesh_probe: torch.cuda.is_available() is false; this probe "
              "needs an NVIDIA card", file=sys.stderr)
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
    res, launches = cs.serve_on_mesh(keys, vals, rng)
    cs.log(f"launches on the mesh path: {launches}")
    print(json.dumps(dict(mesh=res, launches=launches)))
    cs.log(f"total: {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
