#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` alone, on one NVIDIA card.

    python3 tools/dryrun_probe.py

Prints the card's name and power limit, builds the kernels, then runs
(a) the dry run of ``chip_smoke.DRYRUN_CELLS`` on the host
(``chip_smoke.dryrun_cells``), (b) llama3.2-1b's train and decode steps
counted live on the card and traced on ``meta`` through the dry run's
builders at mesh ``(1, 1)``, whose counts must be equal and whose kernel
calls must be the launches, with the steady step time beside the
roofline (``chip_smoke.count_against_card``), and (c) the examples'
counterparts on the card (``chip_smoke.examples_on_card``).  Prints the
numbers as one JSON line.  Without a card it exits 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dryrun_probe: torch.cuda.is_available() is false; this probe "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0])
    cs.log(sys.version.split()[0], torch.__version__, torch.version.cuda)
    cs.log(f"kernel build: {build.build_all():.3f} s")
    cells, dry_s = cs.dryrun_cells()
    cs.log(f"(a): {dry_s:.1f} s")
    t0 = time.perf_counter()
    counts = cs.count_against_card(cs.SEED)
    cs.log(f"(b): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    examples = cs.examples_on_card()
    cs.log(f"(c): {time.perf_counter() - t0:.1f} s")
    print(json.dumps(dict(counts=counts, examples=examples)))
    cs.log(f"total: {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
