#!/usr/bin/env python3
"""Phase 9 of ``chip_smoke.py`` alone, on one NVIDIA card.

    python3 tools/baselines_probe.py

Prints the card's name and power limit, builds the kernels, then:

1. ``chip_smoke.baseline_agreement_check``: the four baselines at 2^14
   keys on the card against the CPU, each with its own transport;
2. builds phase 3's Outback store over its 2^24 keys and times its MN
   decode at B = 2^16 (``chip_smoke.outback_mn_timing``);
3. ``chip_smoke.serve_baseline`` for ``race``, ``mica``, ``cluster`` and
   ``dummy`` over the same keys, one store at a time;
4. ``chip_smoke.modelled_comparison``: the five kinds at 2^20 keys,
   2^16 recorded Gets each, replayed at 1, 8 and 64 clients;

and prints the numbers as one JSON line.  Without a card it exits 1.
"""

from __future__ import annotations

import gc
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
        print("baselines_probe: torch.cuda.is_available() is false; this "
              "probe needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core.hashing import splitmix64
    from repro_torch.kernels import build
    t_start = time.perf_counter()
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0])
    cs.log(f"kernel build: {build.build_all():.3f} s")
    cs.baseline_agreement_check(cs.SEED)
    rng = np.random.default_rng(cs.SEED)
    n = 1 << cs.N_KEYS_LOG2
    keys = splitmix64(np.arange(n, dtype=np.uint64)
                      + np.uint64(cs._KEY_OFFSET))
    vals = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    store = open_store(StoreSpec("outback", load_factor=0.95,
                                 rng_seed=cs.SEED,
                                 batch=BatchPolicy(window=cs.WINDOW)),
                       keys, vals)
    out = {"outback": dict(mn=cs.outback_mn_timing(store.engine, keys, rng))}
    cs.log(f"Outback MN decode: {json.dumps(out['outback'])}")
    del store
    gc.collect()
    torch.cuda.empty_cache()
    for kind in cs.BASELINE_KINDS:
        out[kind] = cs.serve_baseline(kind, keys, vals, rng)
        gc.collect()
        torch.cuda.empty_cache()
    model = cs.modelled_comparison(cs.SEED)
    print(json.dumps(dict(serve=out, modelled=model)))
    cs.log(f"total: {time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
