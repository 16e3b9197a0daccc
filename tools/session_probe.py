#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` alone, on one NVIDIA card, or the runs
that sized it.

    python3 tools/session_probe.py            # phase 13
    python3 tools/session_probe.py --sizing   # the sizing runs

Both print the card's name and power limit and build the kernels.  The
default runs ``chip_smoke.serve_serving_phase`` over phase 3's 2^24 keys
and values (the agreements, the front door at scale, session parking of
llama3.2-1b and rwkv6-1.6b), each part's seconds logged, and prints the
numbers as one JSON line.  ``--sizing`` times 20 decode steps of
rwkv6-1.6b at full width (8 lanes), parks through ``KVSessionStore`` on the
card at 2^16 words, then the front door over a 2^24-key store (2^16
singleflight offers, 2^15 acked-writes offers), then parks of 131,073,
262,145 and 524,290 words (llama3.2-1b's lane at max_seq 32, 64 and 128),
each as a first park, a resume, a re-park and a second resume.  Without a
card it exits 1.
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


def log(*a):
    print(*a, flush=True)


def park_timing(n_words: int) -> dict:
    import torch
    from repro_torch.serve import KVSessionStore
    ss = KVSessionStore(cn_cache_budget_bytes=256 << 10)
    blob = np.random.default_rng(n_words).integers(
        0, 255, n_words * 8, dtype=np.uint8).tobytes()
    out = dict(words=n_words)
    for name in ("park1", "resume1", "park2", "resume2"):
        t = time.perf_counter()
        if name.startswith("park"):
            ss.put(1, blob)
            ss.flush()
        else:
            got = ss.get(1)
            assert got == blob, name
        torch.cuda.synchronize()
        out[name] = time.perf_counter() - t
    out["tables"] = len(ss.store.engine.tables)
    out["hits"] = ss.cache_stats.hits
    log("park", json.dumps(out))
    return out


def frontdoor_timing(n_keys_log2: int, n_sf: int) -> dict:
    import torch
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core.hashing import splitmix64
    from repro_torch.net import Transport
    from repro_torch.serve import (FrontDoor, FrontDoorConfig, TenantLimit,
                                   TenantSpec, TrafficSpec, generate)
    n = 1 << n_keys_log2
    keys = splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(0x5EED << 40))
    vals = splitmix64(keys)
    tr = Transport()
    t = time.perf_counter()
    st = open_store(StoreSpec("outback", load_factor=0.85,
                              batch=BatchPolicy(window=512)), keys, vals,
                    transport=tr)
    torch.cuda.synchronize()
    out = dict(build=time.perf_counter() - t, keys=n)
    rate = 800_000.0
    spec = TrafficSpec(tenants=tuple(
        TenantSpec(name=f"t{i}", rate_ops_per_s=rate / 8, keyspace=4096)
        for i in range(8)), duration_s=n_sf / rate, seed=400)
    t = time.perf_counter()
    offered = generate(spec, keys)
    out["generate_sf"] = time.perf_counter() - t
    out["offered_sf"] = len(offered)
    fd = FrontDoor(st, FrontDoorConfig(singleflight=True, window=512))
    t = time.perf_counter()
    fd.run(offered)
    torch.cuda.synchronize()
    out["run_sf"] = time.perf_counter() - t
    out["stats_sf"] = fd.stats()
    knee = 2.0e6
    wr = 1.2 * knee
    spec = TrafficSpec(tenants=(
        TenantSpec(name="rw0", rate_ops_per_s=wr * 0.4, read_frac=0.5,
                   zipf_theta=0.9, hot_salt=3),
        TenantSpec(name="rw1", rate_ops_per_s=wr * 0.4, read_frac=0.5,
                   zipf_theta=0.9, hot_salt=4),
        TenantSpec(name="greedy", rate_ops_per_s=wr * 0.2, read_frac=0.5,
                   zipf_theta=0.9, hot_salt=5)),
        duration_s=n_sf / 2 / wr, seed=600)
    offered = generate(spec, keys)
    cfg = FrontDoorConfig(max_inflight=8, queue_depth=64,
                          service_us=8 / (0.9 * knee) * 1e6, window=512,
                          singleflight=True,
                          limits=(TenantLimit("greedy", wr * 0.05, burst=8.0),))
    fd = FrontDoor(st, cfg)
    t = time.perf_counter()
    fd.run(offered)
    torch.cuda.synchronize()
    out["run_acked"] = time.perf_counter() - t
    out["offered_acked"] = len(offered)
    out["stats_acked"] = fd.stats()
    log("frontdoor", json.dumps(out))
    return out


def rwkv_timing(steps: int) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = get_config("rwkv6-1.6b")
    t = time.perf_counter()
    model = LM(cfg)
    params = model.init(0)
    torch.cuda.synchronize()
    out = dict(init=time.perf_counter() - t)
    cache = model.init_cache(8, 64)
    tok = torch.zeros((8, 1), dtype=torch.int32, device="cuda")
    ts = []
    for _ in range(steps):
        t = time.perf_counter()
        logits, cache = model.decode_step(params, tok, cache)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    out["step_ms"] = [round(x * 1e3, 3) for x in ts]
    out["finite"] = bool(torch.isfinite(logits.float()).all())
    log("rwkv", json.dumps(out))
    return out


def sizing(t0: float) -> None:
    rwkv_timing(20)
    park_timing(1 << 16)
    frontdoor_timing(24, 1 << 16)
    for n in (131073, 262145, 524290):
        if time.perf_counter() - t0 > 700:
            break
        r = park_timing(n)
        if r["park1"] > 200:
            break


def phase13() -> None:
    import chip_smoke as cs
    from repro_torch.core.hashing import splitmix64
    rng = np.random.default_rng(cs.SEED)
    n = 1 << cs.N_KEYS_LOG2
    keys = splitmix64(np.arange(n, dtype=np.uint64)
                      + np.uint64(cs._KEY_OFFSET))
    vals = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    t = time.perf_counter()
    res, launches = cs.serve_serving_phase(keys, vals, rng)
    log(f"launches: {launches}")
    log(f"phase 13: {time.perf_counter() - t:.1f} s")
    print(json.dumps(dict(serving=res, launches=launches)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("session_probe: torch.cuda.is_available() is false; this "
              "probe needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60
                       ).stdout.strip().splitlines()[0])
    log(sys.version.split()[0], torch.__version__, torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"build {build.build_all():.1f} s")
    if "--sizing" in sys.argv[1:]:
        sizing(t0)
    else:
        phase13()
    log(f"total {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
