#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone (the training path), on one NVIDIA
card.

    python3 tools/train_probe.py            # phase 14
    python3 tools/train_probe.py --kernel   # (a) only: the backward kernel

Prints the card's name and power limit, builds the kernels, prints
``-Xptxas -v`` for ``csrc/fused_norm_matmul_bwd.cu`` (registers, shared
memory and spills of each kernel), then runs
``chip_smoke.serve_training_phase`` (or, with ``--kernel``, only
``chip_smoke.check_fused_norm_matmul_bwd``) and prints the numbers as one
JSON line.  Without a card it exits 1.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def ptxas_report() -> str:
    from repro_torch.kernels import build
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "lib.so"),
             str(build.CSRC / "fused_norm_matmul_bwd.cu")],
            capture_output=True, text=True, timeout=600)
    return out.stdout + out.stderr


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    print(f"kernel build: {build.build_all():.3f} s", flush=True)
    print(ptxas_report(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    t = time.perf_counter()
    if "--kernel" in sys.argv[1:]:
        out = dict(record=cs.check_fused_norm_matmul_bwd(gen))
    else:
        record, res, launches = cs.serve_training_phase(gen)
        out = dict(record=record, res=res, launches=launches)
    print(f"probe: {time.perf_counter() - t:.1f} s", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
