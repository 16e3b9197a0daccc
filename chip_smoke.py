#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # 2^24 keys, one card, about three minutes

Phases; any failure exits non-zero:

1. print the card's name and power limit (``nvidia-smi``), build both CUDA
   kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc`` for sm_90a;
2. hold each kernel bit for bit against its plain PyTorch version on the
   card (``ludo_lookup`` over a real shard's CN arrays, ``slot_unpack``
   over 2^22 random slot words with all-ones words among them; batch sizes
   1, 1023, 1024, 1025 and 2^20), and time both with CUDA events;
3. check that a small store on the card answers and meters exactly as the
   same store on the CPU (the plain versions), then serve through
   ``open_store(StoreSpec("outback", load_factor=0.95))`` at 2^24 keys of
   8 bytes with 8-byte values: YCSB-C (2^20 zipf(0.99) Gets), YCSB-A
   (2^18 ops, half reads, half updates), then 2^14 inserts of new keys and
   2^14 deletes, all through ``submit``/``flush`` at window 1024, every
   answer checked against a host oracle of the latest values.  The kernel
   launch counters are zeroed just before this phase and read just after.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a card the script exits 1 and
prints no result.
"""

from __future__ import annotations

import gc
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# The sizes of the run: 2^24 keys of 8 bytes with 8-byte values, 2^20
# YCSB-C Gets, 2^18 YCSB-A ops, 2^14 inserts and 2^14 deletes; data from SEED.
N_KEYS_LOG2 = 24
N_GETS_LOG2 = 20
N_YCSB_A_LOG2 = 18
N_WRITES_LOG2 = 14
SEED = 0
WINDOW = 1024
# At B=2^20 the timed calls cycle over this many input sets, 64 MB or more
# in all, so each launch finds its inputs outside the 50 MB L2 as a fresh
# batch would; the CN arrays (9 MB at 2^24 keys) stay L2-resident, as on
# the serve path.
COLD_SETS = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# H100 SXM peak 32-bit integer rate (architecture white paper: 132 SMs x 64
# INT32 lanes x 1.98 GHz, a multiply-add counted as two).
INT32_OPS_PER_S = 33.5e12
# 32-bit integer operations per key in the source of each kernel (a modulo
# counted as one, so the operation bound is a lower bound):
# ludo_lookup: 4 seeded 64-bit hashes of 29 (3 fmix32 of 8, 2 xor, 2 mul,
# 1 seed xor), 4 modulos, 8 for the two Othello bit reads and their xor,
# 1 select, 13 for the seeded slot hash, 4 for indexing and stores.
LUDO_OPS_PER_KEY = 4 * 29 + 4 + 8 + 1 + 13 + 4
# slot_unpack: three shift-and-mask pairs and the address copy.
UNPACK_OPS_PER_SLOT = 7


def log(*a) -> None:
    print(*a, flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------------ timing
def time_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, by CUDA events
    (after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, kernel: str):
    """Mean device time of the CUDA kernel named ``kernel`` over ``iters``
    calls, from ``torch.profiler``; None when the trace holds no such
    kernel time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel in ev.key and ev.count:
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = getattr(ev, "cuda_time_total", 0)
            return total / ev.count / 1e3 if total else None
    return None


def cycling(fn, sets):
    """A call of ``fn`` on the next argument tuple of ``sets`` each time."""
    it = itertools.cycle(sets)
    return lambda: fn(*next(it))


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


# -------------------------------------------------------------- workloads
def zipf_ranks(rng, n: int, size: int, theta: float = 0.99) -> np.ndarray:
    cdf = np.cumsum(np.arange(1, n + 1, dtype=np.float64) ** -theta)
    r = np.searchsorted(cdf, rng.random(size) * cdf[-1], side="right")
    return np.minimum(r, n - 1)


# ------------------------------------------------------------ phase 2
def check_kernels(engine, keys: np.ndarray, rng) -> dict:
    """Each kernel against its plain version on the card, and timed."""
    import torch
    from repro_torch.core.hashing import lanes, split_u64
    from repro_torch.kernels import ops, ref
    dev = engine.device
    oth = engine.cn.othello
    meta = ops.cn_meta_from(engine)
    wa, wb, seeds = oth.words_a, oth.words_b, engine.cn.seeds

    absent = rng.integers(0, 2**64 - 1, 4096, dtype=np.uint64, endpoint=True)
    out = {}

    def ludo_inputs(b):
        q = np.concatenate([keys[rng.integers(0, keys.size, b)], absent])[:b]
        lo, hi = split_u64(rng.permutation(q))
        return lanes(lo, dev), lanes(hi, dev)

    def ludo_bound(b):
        # each key's lanes read and (bucket, slot) written once: 16 B a key;
        # the Othello words and seeds the gathers read stay in L2 (about
        # 9 MB at 2^24 keys) and are not HBM traffic
        by_bytes = 16 * b / HBM_BYTES_PER_S * 1e3
        by_ops = LUDO_OPS_PER_KEY * b / INT32_OPS_PER_S * 1e3
        return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops \
            else "operations"

    err = 0
    for b in (1, 1023, 1024, 1025, 1 << 20):
        lo, hi = ludo_inputs(b)
        got = ops.ludo_lookup(lo, hi, wa, wb, seeds, meta)
        want = ref.ludo_lookup_ref(lo, hi, wa, wb, seeds, **meta)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"ludo_lookup differs from its plain version at B={b}")
        err = max(err, max_abs_err(got, want))
    timings = {}
    for b in (WINDOW, 1 << 20):
        sets = [ludo_inputs(b) + (wa, wb, seeds)
                for _ in range(1 if b == WINDOW else COLD_SETS)]
        iters = 2000 if b == WINDOW else 200
        kern = cycling(lambda *a: ops.ludo_lookup(*a, meta), sets)
        bound, by = ludo_bound(b)
        timings[b] = dict(
            batch=b, ms=time_ms(kern, iters),
            device_ms=device_ms(kern, 50, "ludo_lookup_kernel"),
            plain_ms=time_ms(cycling(
                lambda *a: ref.ludo_lookup_ref(*a, **meta), sets),
                iters // 10),
            bound_ms=bound, bound_by=by)
    out["ludo_lookup"] = dict(
        name="ludo_lookup", route="cuda",
        source="src/repro_torch/kernels/csrc/ludo_lookup.cu",
        replaces="src/repro/kernels/ludo_lookup.py:70", max_abs_err=err,
        library_ms=None, **timings[WINDOW], large=timings[1 << 20])

    words = rng.integers(0, 2**32, (2, COLD_SETS << 20),
                         dtype=np.uint64).astype(np.uint32)
    words[:, :64] = 0xFFFFFFFF  # all bits set
    words[:, 64:128] = 0
    s_lo, s_hi = lanes(words[0], dev), lanes(words[1], dev)
    err = 0
    for b in (1, 1023, 1024, 1025, 1 << 22):
        got = ops.slot_unpack(s_lo[:b], s_hi[:b])
        want = ref.slot_unpack_ref(s_lo[:b], s_hi[:b])
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"slot_unpack differs from its plain version at B={b}")
        err = max(err, max_abs_err(got, want))
    timings = {}
    for b in (WINDOW, 1 << 20):
        sets = [(s_lo[j * b:(j + 1) * b], s_hi[j * b:(j + 1) * b])
                for j in range(1 if b == WINDOW else COLD_SETS)]
        iters = 2000 if b == WINDOW else 200
        kern = cycling(ops.slot_unpack, sets)
        by_bytes = 24 * b / HBM_BYTES_PER_S * 1e3
        by_ops = UNPACK_OPS_PER_SLOT * b / INT32_OPS_PER_S * 1e3
        timings[b] = dict(
            batch=b, ms=time_ms(kern, iters),
            device_ms=device_ms(kern, 50, "slot_unpack_kernel"),
            plain_ms=time_ms(cycling(ref.slot_unpack_ref, sets),
                             iters // 10),
            bound_ms=max(by_bytes, by_ops),
            bound_by="bytes" if by_bytes >= by_ops else "operations")
    out["slot_unpack"] = dict(
        name="slot_unpack", route="cuda",
        source="src/repro_torch/kernels/csrc/slot_unpack.cu",
        replaces="src/repro/kernels/slot_unpack.py:31", max_abs_err=err,
        library_ms=None, **timings[WINDOW], large=timings[1 << 20])
    for k in out.values():
        log(f"kernel {k['name']}: bit-identical to its plain version; "
            f"B={WINDOW}: {k['ms']:.6f} ms (device {k['device_ms']}), "
            f"plain {k['plain_ms']:.6f} ms, bound {k['bound_ms']:.9f} ms; "
            f"B=2^20: {k['large']['ms']:.6f} ms (device "
            f"{k['large']['device_ms']}), plain {k['large']['plain_ms']:.6f}"
            f" ms, bound {k['large']['bound_ms']:.6f} ms "
            f"({k['large']['bound_by']})")
    return out


# ------------------------------------------------------------ phase 3
def _results(handles) -> list:
    return [(h.result().values.tolist(), h.result().found.tolist(),
             h.result().statuses) for h in handles]


def agreement_check(seed: int, devices=("cuda", "cpu")) -> None:
    """A small store on the card answers and meters as on the CPU."""
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core.hashing import splitmix64
    n = 1 << 14
    keys = splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(7 << 40))
    vals = splitmix64(keys)
    fresh = splitmix64(np.arange(n, n + 2048, dtype=np.uint64)
                       + np.uint64(7 << 40))
    rng = np.random.default_rng(seed)
    kinds = rng.choice(4, 8192, p=[0.5, 0.25, 0.15, 0.1])
    stream = []
    for t, (kind, r) in enumerate(zip(kinds, zipf_ranks(rng, n, 8192))):
        op = ("get", "update", "insert", "delete")[kind]
        k = int(fresh[t % 2048]) if op == "insert" else int(keys[r])
        stream.append((op, k, t if op in ("update", "insert") else None))
    spec = StoreSpec("outback", load_factor=0.95, rng_seed=seed,
                     batch=BatchPolicy(window=WINDOW))
    runs = []
    for device in devices:
        st = open_store(spec, keys, vals, device=device)
        hs = [st.submit(op, k) if v is None else st.submit(op, k, v)
              for op, k, v in stream]
        st.flush()
        probe = st.get_batch(np.concatenate([keys, fresh]))
        runs.append((_results(hs), probe.values.tolist(),
                     probe.found.tolist(), st.meter_totals().snapshot(),
                     st.engine.mn_state()["n_keys"]))
    check(runs[0] == runs[1], "the store on the card disagrees with the same "
          "store on the CPU")
    log(f"agreement: a {n}-key store on {devices[0]} answers {len(stream)} "
        f"mixed ops and meters exactly as on {devices[1]}")


def serve(store, keys, vals, rng, n_get: int, n_a: int, n_write: int):
    """YCSB-C, YCSB-A, inserts and deletes through submit/flush, every
    answer checked against the host oracle ``latest``.  Returns the
    per-phase results and the oracle state for :func:`verify_final`."""
    import torch
    from repro_torch.core.hashing import splitmix64
    from repro_torch.kernels import ops
    n = keys.size
    latest = vals.copy()
    perm = rng.permutation(n)  # zipf rank -> key index: hot keys scattered
    stats = store.stats
    res = {}

    def phase(name, fn):
        calls0, l0 = stats.batch_calls, dict(ops.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extra = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = {k: ops.LAUNCHES[k] - l0[k] for k in l0}
        batches = stats.batch_calls - calls0
        res[name] = dict(seconds=sec, batches=batches, launches=launches,
                         **(extra or {}))
        log(f"{name}: {sec:.3f} s, {batches} flushed batches, "
            f"launches {launches}, {extra or ''}")

    # ---- YCSB-C: zipf Gets, one window at a time ----
    idx_c = perm[zipf_ranks(rng, n, n_get)]

    def get_windows(idx):
        """Submit the Gets of ``idx`` one window at a time (the last submit
        of a window flushes it) and check every answer; returns the host
        time of each window and of its flush, in ms."""
        lat, flush, got_v, got_f = [], [], [], []
        for w0 in range(0, idx.size, WINDOW):
            ks = keys[idx[w0:w0 + WINDOW]]
            t0 = time.perf_counter()
            hs = [store.submit("get", int(k)) for k in ks[:-1]]
            t1 = time.perf_counter()
            hs.append(store.submit("get", int(ks[-1])))
            if not hs[-1].done:
                store.flush()
            t2 = time.perf_counter()
            lat.append(t2 - t0)
            flush.append(t2 - t1)
            check(hs[0].batch is hs[-1].batch, "a window split its batch")
            got_v.append(hs[-1].batch.values)
            got_f.append(hs[-1].batch.found)
        check(np.concatenate(got_f).all(), "YCSB-C: a present key missed")
        check(np.array_equal(np.concatenate(got_v), latest[idx]),
              "YCSB-C: a wrong value")
        return np.asarray(lat) * 1e3, np.asarray(flush) * 1e3

    def ycsb_c():
        gcs = []  # [generation, seconds] of each collection in the phase

        def on_gc(when, info):
            if when == "start":
                gcs.append([info["generation"], time.perf_counter()])
            else:
                gcs[-1][1] = time.perf_counter() - gcs[-1][1]

        gc.callbacks.append(on_gc)
        try:
            lat, flush = get_windows(idx_c)
        finally:
            gc.callbacks.remove(on_gc)
        return dict(p50_ms=float(np.percentile(lat, 50)),
                    p99_ms=float(np.percentile(lat, 99)),
                    max_ms=float(lat.max()),
                    flush_p50_ms=float(np.percentile(flush, 50)),
                    flush_p99_ms=float(np.percentile(flush, 99)),
                    gc_collections=[sum(g == k for g, _ in gcs)
                                    for k in range(3)],
                    gc_ms=1e3 * sum(t for _, t in gcs))

    phase("ycsb_c", ycsb_c)
    res["ycsb_c"]["gets_per_s"] = n_get / res["ycsb_c"]["seconds"]

    def ycsb_c_profiled():
        """32 more windows of the same Gets under torch.profiler: the
        device's busy share of the host wall time."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        idx = idx_c[:32 * WINDOW]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            get_windows(idx)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy, end = 0.0, float("-inf")
        for a, b in spans:  # union of the device intervals
            if b > end:
                busy += b - max(a, end)
                end = b
        return dict(device_busy_share=busy / wall_us if spans else None,
                    device_ops_per_window=len(spans) / 32)

    phase("ycsb_c_profiled", ycsb_c_profiled)

    # ---- YCSB-A: zipf, half reads, half updates, submission order ----
    idx_a = perm[zipf_ranks(rng, n, n_a)]
    is_upd = rng.random(n_a) < 0.5
    new_v = rng.integers(0, 2**64 - 1, n_a, dtype=np.uint64, endpoint=True)

    def ycsb_a():
        reads, upds, expect = [], [], []
        for t in range(n_a):
            i = int(idx_a[t])
            if is_upd[t]:
                upds.append(store.submit("update", int(keys[i]), int(new_v[t])))
                latest[i] = new_v[t]
            else:
                reads.append(store.submit("get", int(keys[i])))
                expect.append(latest[i])
        store.flush()
        check(all(bool(h.result().found[0]) for h in upds),
              "YCSB-A: an update of a present key failed")
        check(all(bool(h.result().found[0]) for h in reads),
              "YCSB-A: a present key missed")
        got = np.asarray([h.result().values[0] for h in reads], np.uint64)
        check(np.array_equal(got, np.asarray(expect, np.uint64)),
              "YCSB-A: a read did not see the latest value")

    phase("ycsb_a", ycsb_a)
    res["ycsb_a"]["ops_per_s"] = n_a / res["ycsb_a"]["seconds"]

    # ---- writes: inserts of new keys, then deletes ----
    fresh = splitmix64(np.arange(n, n + n_write, dtype=np.uint64)
                       + np.uint64(_KEY_OFFSET))
    fresh_v = rng.integers(0, 2**64 - 1, n_write, dtype=np.uint64,
                           endpoint=True)
    del_old = rng.choice(n, n_write // 2, replace=False)
    del_new = rng.choice(n_write, n_write - n_write // 2, replace=False)

    def inserts():
        hs = [store.submit("insert", int(k), int(v))
              for k, v in zip(fresh, fresh_v)]
        store.flush()
        cases = [h.result().statuses[0] for h in hs]
        check(all(c in ("slot", "reseed", "overflow") for c in cases),
              "insert of a new key did not place it")
        return {c: cases.count(c) for c in sorted(set(cases))}

    def deletes():
        gone = np.concatenate([keys[del_old], fresh[del_new]])
        hs = [store.submit("delete", int(k)) for k in gone]
        store.flush()
        check(all(bool(h.result().found[0]) for h in hs),
              "delete of a present key failed")

    phase("inserts", inserts)
    phase("deletes", deletes)
    return res, dict(latest=latest, fresh=fresh, fresh_v=fresh_v,
                     del_old=del_old, del_new=del_new)


def verify_final(store, keys, rng, o) -> None:
    """After the writes: deleted keys are gone, the rest hold their latest
    values (a sample of the old keys, every surviving new key)."""
    gone_new = np.zeros(o["fresh"].size, bool)
    gone_new[o["del_new"]] = True
    r = store.get_batch(np.concatenate([keys[o["del_old"]],
                                        o["fresh"][gone_new]]))
    check(not r.found.any(), "a deleted key is still found")
    r = store.get_batch(o["fresh"][~gone_new])
    check(r.found.all() and np.array_equal(r.values, o["fresh_v"][~gone_new]),
          "an inserted key lost its value")
    keep = np.ones(keys.size, bool)
    keep[o["del_old"]] = False
    live = np.nonzero(keep)[0]
    sample = rng.choice(live, min(1 << 16, live.size), replace=False)
    r = store.get_batch(keys[sample])
    check(r.found.all() and np.array_equal(r.values, o["latest"][sample]),
          "an old key lost its latest value")
    log("final state: deleted keys absent, inserted and old keys hold their "
        "latest values")


_KEY_OFFSET = 0x5EED << 40


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.api import BatchPolicy, StoreSpec, open_store
    from repro_torch.core.hashing import splitmix64
    from repro_torch.kernels import build, ops

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(sys.version.split()[0], torch.__version__, torch.version.cuda)

    # ---- phase 1: build ----
    log(f"kernel build: {build.build_all():.3f} s (nvcc, sm_90a, one process "
        f"per source)")

    # ---- set-up: data from the seed, the store on the card ----
    rng = np.random.default_rng(SEED)
    n = 1 << N_KEYS_LOG2
    keys = splitmix64(np.arange(n, dtype=np.uint64) + np.uint64(_KEY_OFFSET))
    vals = rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    store = open_store(StoreSpec("outback", load_factor=0.95,
                                 rng_seed=SEED,
                                 batch=BatchPolicy(window=WINDOW)),
                       keys, vals)
    torch.cuda.synchronize()
    eng = store.engine
    log(f"store build: {time.perf_counter() - t0:.3f} s for {n} keys "
        f"(host Ludo build, then MN/CN arrays to {eng.device}); "
        f"{eng.cn.num_buckets} buckets, {eng.overflow.size} fallback keys, "
        f"MN {eng.mn_index_bytes() + 16 * eng.heap_klo.numel()} B, "
        f"CN {eng.cn_memory_bytes()} B")
    check(eng.device.type == "cuda" and eng.slots_lo.is_cuda
          and eng.cn.seeds.is_cuda, "the store is not on the card")

    # ---- phase 2: kernels against their plain versions ----
    kernels = check_kernels(eng, keys, rng)
    agreement_check(SEED)

    # ---- phase 3: the main path ----
    ops.reset_launch_counts()
    res, oracle = serve(store, keys, vals, rng, 1 << N_GETS_LOG2,
                        1 << N_YCSB_A_LOG2, 1 << N_WRITES_LOG2)
    launches = dict(ops.LAUNCHES)
    for name, k in kernels.items():
        k["launches"] = launches[name]
    log(f"launches on the main path: {launches}")
    for name in ("ycsb_c", "ycsb_c_profiled", "ycsb_a", "inserts",
                 "deletes"):
        p = res[name]
        for kern in ("ludo_lookup", "slot_unpack"):
            check(p["launches"][kern] >= p["batches"] > 0,
                  f"{name}: fewer {kern} launches than flushed batches")
    check(all(v > 0 for v in launches.values()), "a kernel never launched")
    verify_final(store, keys, rng, oracle)

    c = res["ycsb_c"]
    log(f"YCSB-C: {c['gets_per_s']:.1f} Gets/s over {1 << N_GETS_LOG2} "
        f"Gets; per window of {WINDOW}: p50 {c['p50_ms']:.4f} ms, "
        f"p99 {c['p99_ms']:.4f} ms, max {c['max_ms']:.4f} ms; its flush "
        f"p50 {c['flush_p50_ms']:.4f} ms, p99 {c['flush_p99_ms']:.4f} ms; "
        f"garbage collections (gen 0/1/2) {c['gc_collections']}, "
        f"{c['gc_ms']:.1f} ms")
    busy = res["ycsb_c_profiled"]["device_busy_share"]
    log(f"YCSB-C device busy share (torch.profiler, 32 windows): "
        f"{'not measured' if busy is None else f'{busy:.6f}'}")
    log(f"YCSB-A: {res['ycsb_a']['ops_per_s']:.1f} ops/s over "
        f"{1 << N_YCSB_A_LOG2} ops")
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} B")
    log(f"meter: {store.meter_totals().snapshot()}")
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
