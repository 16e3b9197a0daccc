#!/usr/bin/env python3
"""Phase 17, 18 or 20 of ``chip_smoke.py`` alone, on one NVIDIA card.

    python3 tools/tp_probe.py         # phase 17
    python3 tools/tp_probe.py --seq   # phase 18
    python3 tools/tp_probe.py --hd    # phase 20

Prints the card's name and power limit, builds the kernels, then runs
``chip_smoke.serve_tp_phase``: row 5 at the tp = 2 shard shapes, the gloo
probe of two ranks on the card, then the world of two ranks of
``tools/tp_rank.py main`` (qwen2.5-14b, mixtral-8x22b, deepseek-v3-671b,
jamba-v0.1-52b, rwkv6-1.6b and whisper-large-v3 served at tp = 2, cut in
depth, with their float32 twins, mixtral again with ``moe_gather_decode``,
llama3.2-1b served over (2, 1) and trained over three meshes, the reduced
families' float32 train steps), then rows 5 and 6 at those steps'
shapes.  With ``--seq``, ``chip_smoke.serve_seq_phase`` instead: the
world of ``tools/tp_rank.py seq`` (jamba-v0.1-52b decoding a batch-1
cache of 524,288 tokens over (2, 1), llama3.2-1b under
``cache_seq_shard`` at (1, 2), the float32 twins), then row 5 at the
shapes those runs recorded.  With ``--hd``, ``chip_smoke.serve_hd_phase``:
the world of sixteen ranks of ``tools/tp_rank.py hd`` (llama3.2-1b over
(1, 16), its gqa cache split over ``head_dim``, and the float32 twin held
here to the whole decode), then row 5 at the shapes the ranks recorded.
Prints the numbers as one JSON line.
Without a card it exits 1.
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
        print("tp_probe: torch.cuda.is_available() is false; this probe "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0])
    cs.log(sys.version.split()[0], torch.__version__, torch.version.cuda)
    cs.log(f"kernel build: {build.build_all():.3f} s")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    phase = (cs.serve_seq_phase if "--seq" in sys.argv[1:] else
             cs.serve_hd_phase if "--hd" in sys.argv[1:] else
             cs.serve_tp_phase)
    res, launches = phase(gen)
    cs.log(f"launches on the path (all ranks): {launches}")
    print(json.dumps(dict(tp=res, launches=launches)))
    cs.log(f"total: {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
