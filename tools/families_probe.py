#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` alone, on one NVIDIA card: the vlm, MoE
and MLA families (llava-next-mistral-7b, mixtral-8x22b cut to 8 layers,
deepseek-v3-671b cut to 4 layers with its MTP block) served at their
published widths, row 5 at their (d, F) pairs, the twins and the reduced
deepseek's restart; then phase 14 (b)'s float32 training twins of the
three reduced configs.  With ``--hybrid``, phase 16 alone instead: the
hybrid and encdec families (jamba-v0.1-52b cut to ``HYBRID_LAYERS``
layers, whisper-large-v3 whole) and row 5 at their (d, F) pairs, then the
training twins of the reduced jamba and whisper.

    python3 tools/families_probe.py [--hybrid]

It prints the card's name and power limit, builds the kernels, runs
``chip_smoke.serve_families_phase`` (or ``serve_hybrid_phase``) and the
twins, and writes the numbers to ``chiprun_out/families_probe.json`` (or
``hybrid_probe.json``).  Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

TWINS = ("llava-next-mistral-7b", "mixtral-8x22b", "deepseek-v3-671b")
HYBRID_TWINS = ("jamba-v0.1-52b", "whisper-large-v3")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hybrid", action="store_true",
                    help="phase 16 (jamba, whisper) instead of phase 15")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("families_probe: needs an NVIDIA card", file=sys.stderr)
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
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    t = time.perf_counter()
    phase = cs.serve_hybrid_phase if args.hybrid else cs.serve_families_phase
    res, launches = phase(gen)
    out = dict(res=res, launches=launches, phase_s=time.perf_counter() - t)
    t = time.perf_counter()
    out["train_twins"] = [cs.train_twin(arch, cs.SEED) for arch in (
        HYBRID_TWINS if args.hybrid else TWINS)]
    out["train_twins_s"] = time.perf_counter() - t
    print(f"probe: phase {16 if args.hybrid else 15} {out['phase_s']:.1f} "
          f"s, training twins {out['train_twins_s']:.1f} s", flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    name = "hybrid_probe.json" if args.hybrid else "families_probe.json"
    (dest / name).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
