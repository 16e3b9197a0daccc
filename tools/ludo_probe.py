#!/usr/bin/env python3
"""What binds ``ludo_lookup`` on one NVIDIA card, and how the redesign
compares with the first port of the kernel and with the parent tree's
wrappers.

    python3 tools/ludo_probe.py

Prints the card's name and power limit, the registers of each kernel
(``-Xptxas -v``) and the SASS instructions of each kernel by pipe
(``chip_smoke.sass_opcodes``: ``ludo_lookup`` as it is and as first
ported, and ``slot_unpack``), then:

1. holds ``ops.ludo_lookup`` (the source as it is) bit for bit against
   ``ref.ludo_lookup_ref`` at the plan's edges, on views at element
   offsets 1-3, and at large odd divisors (ma near 2^31 over 2^26 words,
   nb = 2^24 + 1), and every copy that computes the right answer at four
   batches;
2. times each copy's kernel by ``torch.profiler`` at B = 1, 1024 and 2^20
   over synthetic CN arrays of a 2^24-key shard (ma = 1.33 n bits, mb = n + 1
   bits, nb = n / 3.8 seeds), the 2^20 inputs and outputs cycling over
   ``chip_smoke.COLD_SETS`` sets (64 MB of keys) as in phase 2, in two
   rounds, the second in the reverse order;
3. times the source as it is against ``one_round`` at B = 1, 1024 and
   1955 (the longest page map of phase 5) in ``SCHEME_PAIRS`` turns of
   base, one_round, one_round, base, and the source at other block widths
   at B = 1024 and 2^20;
4. times both index wrappers by CUDA events at B = 1024 against the parent
   tree's wrappers (``parent_ludo_lookup``, ``parent_slot_unpack``: two and
   four ``torch.empty``, the device guard on every call, the stream from
   ``torch.cuda.current_stream``), in turns parent, new, new, parent three
   times over with garbage collection off, and prints the new wrappers'
   host-time breakdown (``chip_smoke.wrapper_breakdown``) beside the
   parent's pieces that the new wrappers dropped.

The copies, built with ``nvcc`` (one process each, all at once) into the
package's ignored ``_build/probe/``:

- ``base``: ``csrc/ludo_lookup.cu`` as it is;
- ``pct``: its modulos as ``%`` (the same answers);
- ``mask``: its modulos as ``& (d - 1)`` (wrong answers, and the indices
  fall on the few values whose bits lie in d - 1: the reads hit L1);
- ``no_gather``: its reads of the CN arrays replaced by a value of the
  index;
- ``no_hash``: its hashes replaced by one xor;
- ``streaming``: keys loaded and outputs stored evict-first;
- ``cg``: the CN arrays read with ``ld.global.cg`` (L2 only);
- ``one_round``: both candidate buckets' seeds read with the Othello
  words, four reads a key in one dependent round (the same answers);
- ``first``: the first port of the kernel (one thread a key, 256-thread
  blocks, runtime ``%``, three dependent memory rounds), and its
  ``first_mask``, ``first_no_gather`` and ``first_no_hash`` copies.

The ``mask``, ``no_gather`` and ``no_hash`` copies give wrong answers;
every other copy is checked bit for bit.  Writes
``chiprun_out/ludo_probe.json``.
"""

from __future__ import annotations

import ctypes
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

N_KEYS = 1 << 24  # the CN arrays of chip_smoke.py's shard
ROUNDS = 2
ITERS = 50
WRAPPER_PAIRS = 3  # parent, new, new, parent turns of the wrapper timing

# The first port of the kernel, as csrc/ludo_lookup.cu held it before the
# redesign.
FIRST_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kC3 = 0x27D4EB2Fu;
constexpr uint32_t kC4 = 0x165667B1u;
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash64(uint32_t lo, uint32_t hi,
                                           uint32_t seed) {
  uint32_t h = seed ^ kGolden;
  h = fmix32(h ^ lo) * kC3;
  h = fmix32(h ^ hi) * kC4;
  return fmix32(h);
}

__global__ void ludo_lookup_kernel(const uint32_t* __restrict__ key_lo,
                                   const uint32_t* __restrict__ key_hi,
                                   const uint32_t* __restrict__ words_a,
                                   const uint32_t* __restrict__ words_b,
                                   const uint8_t* __restrict__ seeds,
                                   int32_t* __restrict__ bucket_out,
                                   int32_t* __restrict__ slot_out, int n,
                                   uint32_t ma, uint32_t mb, uint32_t nb,
                                   uint32_t seed_a, uint32_t seed_b,
                                   uint32_t seed_ba, uint32_t seed_bb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t lo = key_lo[i];
  const uint32_t hi = key_hi[i];
  const uint32_t ia = hash64(lo, hi, seed_a) % ma;
  const uint32_t ib = hash64(lo, hi, seed_b) % mb;
  const uint32_t choice =
      ((__ldg(words_a + (ia >> 5)) >> (ia & 31u)) ^
       (__ldg(words_b + (ib >> 5)) >> (ib & 31u))) & 1u;
  const uint32_t b0 = hash64(lo, hi, seed_ba) % nb;
  const uint32_t b1 = hash64(lo, hi, seed_bb) % nb;
  const uint32_t bucket = choice ? b1 : b0;
  const uint32_t seed = __ldg(seeds + bucket);
  const uint32_t slot = fmix32(lo ^ (seed * kC1) ^ (hi * kC2)) & 3u;
  bucket_out[i] = static_cast<int32_t>(bucket);
  slot_out[i] = static_cast<int32_t>(slot);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ludo_lookup_launch(const void* key_lo, const void* key_hi,
                                  const void* words_a, const void* words_b,
                                  const void* seeds, void* bucket_out,
                                  void* slot_out, int n, unsigned int ma,
                                  unsigned int mb, unsigned int nb,
                                  unsigned int seed_a, unsigned int seed_b,
                                  unsigned int seed_ba, unsigned int seed_bb,
                                  void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  ludo_lookup_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key_lo),
      static_cast<const uint32_t*>(key_hi),
      static_cast<const uint32_t*>(words_a),
      static_cast<const uint32_t*>(words_b),
      static_cast<const uint8_t*>(seeds), static_cast<int32_t*>(bucket_out),
      static_cast<int32_t*>(slot_out), n, ma, mb, nb, seed_a, seed_b, seed_ba,
      seed_bb);
  return static_cast<int>(cudaGetLastError());
}
"""
MOD_HEAD = ("__device__ __forceinline__ uint32_t mod_magic(uint32_t a, uint64_t m,\n"
            "                                              uint32_t d) {\n")
CN_READS = ("__ldg(cn.words_a + (ia >> 5))", "__ldg(cn.words_b + (ib >> 5))",
            "__ldg(cn.seeds + bucket)")
CHOICE = "  const uint32_t choice = (("
NEW_PATCHES = {
    "base": [],
    "pct": [(MOD_HEAD, MOD_HEAD + "  return a % d;\n")],
    "mask": [(MOD_HEAD, MOD_HEAD + "  return a & (d - 1u);\n")],
    "no_gather": [(CN_READS[0], "(ia >> 5)"), (CN_READS[1], "(ib >> 5)"),
                  (CN_READS[2], "(bucket >> 3)")],
    "no_hash": [("  uint32_t h = seed ^ kGolden;\n",
                 "  return lo ^ hi ^ seed;\n  uint32_t h = seed ^ kGolden;\n")],
    "streaming": [("(cn, key_lo[i], key_hi[i], bucket_out + i,",
                   "(cn, __ldcs(key_lo + i), __ldcs(key_hi + i), bucket_out + i,"),
                  ("  *bucket_out = static_cast<int32_t>(bucket);\n",
                   "  __stcs(bucket_out, static_cast<int32_t>(bucket));\n"),
                  ("  *slot_out = static_cast<int32_t>(fmix32(lo ^ (seed * kC1) ^ (hi * kC2)) &\n"
                   "                                   3u);\n",
                   "  __stcs(slot_out, static_cast<int32_t>(\n"
                   "                       fmix32(lo ^ (seed * kC1) ^ (hi * kC2)) & 3u));\n")],
    "cg": [(r, r.replace("__ldg(", "__ldcg(")) for r in CN_READS],
    "one_round": [(CHOICE, "  const uint32_t s0 = __ldg(cn.seeds + b0);\n"
                           "  const uint32_t s1 = __ldg(cn.seeds + b1);\n"
                   + CHOICE),
                  (CN_READS[2], "(choice ? s1 : s0)")],
}
FIRST_PATCHES = {
    "first": [],
    "first_mask": [("% ma;", "& (ma - 1u);"), ("% mb;", "& (mb - 1u);"),
                  ("% nb;", "& (nb - 1u);")],
    "first_no_gather": [("__ldg(words_a + (ia >> 5))", "(ia >> 5)"),
                       ("__ldg(words_b + (ib >> 5))", "(ib >> 5)"),
                       ("__ldg(seeds + bucket)", "(bucket >> 3)")],
    "first_no_hash": [("  uint32_t h = seed ^ kGolden;\n",
                      "  return lo ^ hi ^ seed;\n  uint32_t h = seed ^ kGolden;\n")],
}
RIGHT = ("base", "pct", "streaming", "cg", "one_round", "first")
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
FIRST_ARGTYPES = [_P] * 7 + [_I] + [_U] * 7 + [_P]
def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def sources() -> dict:
    """variant -> CUDA source."""
    from repro_torch.kernels import build as kb
    new = (kb.CSRC / "ludo_lookup.cu").read_text()
    out = {}
    for base, patches in ((new, NEW_PATCHES), (FIRST_SOURCE, FIRST_PATCHES)):
        for name, pairs in patches.items():
            text = base
            for old, rep in pairs:
                if old not in text:
                    raise RuntimeError(f"{name}: {old!r} is not in the source")
                text = text.replace(old, rep)
            out[name] = text
    return out


def build_variants(out_dir: Path) -> dict:
    """Compile every variant at once; variant -> (library, ptxas log)."""
    from repro_torch.kernels import build as kb
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources().items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [kb.nvcc_path(), *kb.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode()}")
        libs[name] = (lib, log.decode())
    return libs


def load(lib: Path, first: bool):
    from repro_torch.kernels import build as kb
    fn = (ctypes.CDLL(str(lib)).ludo_lookup_launch)
    fn.argtypes = FIRST_ARGTYPES if first else kb.SIGNATURES["ludo_lookup"][2]
    fn.restype = ctypes.c_int
    return fn


def synthetic_cn(gen, n_keys: int = N_KEYS, ma=None, mb=None, nb=None):
    """Random Othello words and seeds of an ``n_keys``-key shard's sizes
    (or the sizes given) on the card, and their meta."""
    import math

    import torch
    ma = ma or math.ceil(1.33 * n_keys)
    mb = mb or n_keys + 1
    nb = nb or math.ceil(n_keys / (4 * 0.95))
    words = [torch.randint(-2**31, 2**31, (-(-m // 32),), generator=gen,
                           device="cuda", dtype=torch.int32) for m in (ma, mb)]
    seeds = torch.randint(0, 256, (nb,), generator=gen, device="cuda",
                          dtype=torch.uint8)
    meta = dict(ma=ma, mb=mb, nb=nb, seed_a=0x0511AD01, seed_b=0x0B5EED02,
                seed_ba=0xA11CE, seed_bb=0xB0BBE)
    return words[0], words[1], seeds, meta


def random_lanes(gen, n: int, offset: int = 0):
    import torch
    t = torch.randint(-2**31, 2**31, (2, n + offset), generator=gen,
                      device="cuda", dtype=torch.int32)
    return t[0, offset:], t[1, offset:]


def launch_args(fn, first: bool, lo, hi, wa, wb, seeds, meta, out, plan):
    """The ctypes call of one launch of ``fn`` (a variant's launcher)."""
    from repro_torch.kernels import ops
    n = lo.shape[0]
    ptr = out.data_ptr()
    s = [int(meta[k]) & 0xFFFFFFFF for k in ("seed_a", "seed_b", "seed_ba",
                                             "seed_bb")]
    base = (lo.data_ptr(), hi.data_ptr(), wa.data_ptr(), wb.data_ptr(),
            seeds.data_ptr(), ptr, ptr + 4 * n, n)
    stream = ops._stream(lo.device)
    if first:
        args = (*base, meta["ma"], meta["mb"], meta["nb"], *s, stream)
    else:
        args = (*base, *ops._ludo_scalars(*(meta[k] for k in (
            "ma", "mb", "nb", "seed_a", "seed_b", "seed_ba", "seed_bb"))),
            *plan, stream)
    return lambda: fn(*args)


def check(gen, libs) -> list:
    """Bit-for-bit checks; returns the failures."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    wa, wb, seeds, meta = synthetic_cn(gen)
    edge = cs.ludo_edge_batches(n_sm)
    bad = []
    for b in edge:
        for off in (0, 1, 2, 3):
            lo, hi = random_lanes(gen, b, off)
            want = ref.ludo_lookup_ref(lo, hi, wa, wb, seeds, **meta)
            got = ops.ludo_lookup(lo, hi, wa, wb, seeds, meta)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                bad.append(("base", b, off))
    for v in RIGHT:
        fn = load(libs[v][0], v == "first")
        for b, off in ((1, 0), (1025, 1), (40_003, 3), (1 << 20, 2)):
            lo, hi = random_lanes(gen, b, off)
            want = ref.ludo_lookup_ref(lo, hi, wa, wb, seeds, **meta)
            out = torch.empty((2, b), dtype=torch.int32, device="cuda")
            err = launch_args(fn, v == "first", lo, hi, wa, wb, seeds, meta,
                              out, tuple(ops.ludo_lookup_plan(
                                  b, n_sm).values()))()
            torch.cuda.synchronize()
            if err or not all(torch.equal(o, w) for o, w in zip(out, want)):
                bad.append((v, b, off))
    print(f"checked B = {edge} at offsets 0-3: {len(bad)} failures {bad}",
          flush=True)
    del wa, wb, seeds
    wa, wb, seeds, meta = synthetic_cn(gen, ma=2**31 - 1, mb=2**30 + 3,
                                       nb=2**24 + 1)
    for b in (1 << 20, 1025):
        lo, hi = random_lanes(gen, b)
        want = ref.ludo_lookup_ref(lo, hi, wa, wb, seeds, **meta)
        got = ops.ludo_lookup(lo, hi, wa, wb, seeds, meta)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            bad.append(("base large divisors", b, 0))
    print(f"large divisors (ma={meta['ma']}, mb={meta['mb']}, "
          f"nb={meta['nb']}): {'ok' if not bad else bad}", flush=True)
    return bad


def kernel_ms(calls) -> float:
    """Device ms a launch of ``ludo_lookup_kernel`` over ``ITERS`` calls
    cycling through ``calls``, by ``torch.profiler``; a trace that holds
    no launch is taken again, up to three times."""
    import chip_smoke as cs
    for _ in range(3):
        it = iter(range(10**9))
        t = sum(cs.device_times(lambda: calls[next(it) % len(calls)](),
                                ITERS, "ludo_lookup_kernel").values())
        if t:
            return t
    raise RuntimeError("three traces held no ludo_lookup_kernel launch")


def time_variants(gen, libs) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    wa, wb, seeds, meta = synthetic_cn(gen)
    sizes = (1, 1024, 1 << 20)
    inputs = {}
    for b in sizes:
        n_sets = cs.COLD_SETS if b == 1 << 20 else 1
        inputs[b] = [(*random_lanes(gen, b), torch.empty(
            (2, b), dtype=torch.int32, device="cuda")) for _ in range(n_sets)]
    names = [v for v in libs]
    res = {v: {b: [] for b in sizes} for v in names}
    for r in range(ROUNDS):
        for v in (names if r % 2 == 0 else names[::-1]):
            first = v.startswith("first")
            fn = load(libs[v][0], first)
            for b in sizes:
                plan = tuple(ops.ludo_lookup_plan(b, n_sm).values())
                calls = [launch_args(fn, first, lo, hi, wa, wb, seeds, meta,
                                     out, plan) for lo, hi, out in inputs[b]]
                res[v][b].append(kernel_ms(calls))
        print(f"round {r}: " + "; ".join(
            f"{v} " + " / ".join(f"{res[v][b][-1]:.7f}" for b in sizes)
            for v in names), flush=True)
    return {v: {str(b): ts for b, ts in d.items()} for v, d in res.items()}


# batch -> block widths timed beside the plan's
PLANS = {1024: (32, 64, 128, 256), 1 << 20: (128, 256, 512, 1024)}
SCHEME_BATCHES = (1, 1024, 1955)
SCHEME_PAIRS = 10


def time_plans(gen, libs) -> dict:
    """The source as it is at other block widths, and against
    ``one_round`` in turns base, one_round, one_round, base."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    wa, wb, seeds, meta = synthetic_cn(gen)
    fns = {v: load(libs[v][0], False) for v in ("base", "one_round")}
    res = {}

    def device_ms(fn, sets, plan):
        calls = [launch_args(fn, False, lo, hi, wa, wb, seeds, meta, out,
                             plan) for lo, hi, out in sets]
        return kernel_ms(calls)

    def lanes_and_out(b):
        return [(*random_lanes(gen, b), torch.empty(
            (2, b), dtype=torch.int32, device="cuda"))
            for _ in range(cs.COLD_SETS if b == 1 << 20 else 1)]

    for b, widths in PLANS.items():
        sets = lanes_and_out(b)
        for threads in sorted({ops.ludo_lookup_plan(b, n_sm)["threads"],
                               *widths}):
            plan = (threads, -(-b // threads))
            name = f"B={b} threads={threads} blocks={plan[1]}"
            res[name] = [device_ms(fns["base"], sets, plan)
                         for _ in range(ROUNDS)]
            print(f"plan {name}: {res[name]}", flush=True)
    for b in SCHEME_BATCHES:
        sets = lanes_and_out(b)
        plan = tuple(ops.ludo_lookup_plan(b, n_sm).values())
        t = {v: [] for v in fns}
        for v in ("base", "one_round", "one_round", "base") * (
                SCHEME_PAIRS // 2):
            t[v].append(device_ms(fns[v], sets, plan))
        wins = sum(o < b_ for o, b_ in zip(t["one_round"], t["base"]))
        res[f"B={b} read schemes"] = t
        print(f"B={b}: base {t['base']} one_round {t['one_round']}; medians "
              f"{float(np.median(t['base'])):.7f} / "
              f"{float(np.median(t['one_round'])):.7f}; one_round below "
              f"base in {wins} of {SCHEME_PAIRS} pairs", flush=True)
    return res


def parent_ludo_lookup(fn, key_lo, key_hi, words_a, words_b, seeds, meta):
    """The parent tree's ``ops.ludo_lookup`` on its CUDA branch, as it was
    (its checks, two outputs, the device guard, the stream object), calling
    the first port of the kernel ``fn``."""
    import torch

    from repro_torch.kernels.ops import LAUNCHES, _check, _raise_on
    device = key_lo.device if isinstance(key_lo, torch.Tensor) else None
    _check("key_lo", key_lo, torch.int32, device)
    _check("key_hi", key_hi, torch.int32, device)
    _check("words_a", words_a, torch.int32, device)
    _check("words_b", words_b, torch.int32, device)
    _check("seeds", seeds, torch.uint8, device)
    n = int(key_lo.shape[0])
    if key_hi.shape[0] != n:
        raise ValueError("key_lo/key_hi lengths differ")
    ma, mb, nb = int(meta["ma"]), int(meta["mb"]), int(meta["nb"])
    if not 0 < ma <= 32 * words_a.shape[0] or not 0 < mb <= 32 * words_b.shape[0]:
        raise ValueError("Othello sizes exceed the words given")
    if not 0 < nb <= seeds.shape[0]:
        raise ValueError("nb exceeds the seeds given")
    if n >= 2**31:
        raise ValueError("batch exceeds the kernel's int index")
    if device.type != "cuda":
        raise ValueError("cuda only")
    bucket = torch.empty(n, dtype=torch.int32, device=device)
    slot = torch.empty(n, dtype=torch.int32, device=device)
    if n:
        with torch.cuda.device(device):
            err = fn(key_lo.data_ptr(), key_hi.data_ptr(), words_a.data_ptr(),
                     words_b.data_ptr(), seeds.data_ptr(), bucket.data_ptr(),
                     slot.data_ptr(), n, ma, mb, nb,
                     int(meta["seed_a"]) & 0xFFFFFFFF,
                     int(meta["seed_b"]) & 0xFFFFFFFF,
                     int(meta["seed_ba"]) & 0xFFFFFFFF,
                     int(meta["seed_bb"]) & 0xFFFFFFFF,
                     torch.cuda.current_stream(device).cuda_stream)
        _raise_on(err, "ludo_lookup")
        LAUNCHES["ludo_lookup"] += 1
    return bucket, slot


def parent_slot_unpack(s_lo, s_hi):
    """The parent tree's ``ops.slot_unpack`` on its CUDA branch, as it
    was."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.ops import LAUNCHES, _check, _raise_on
    device = s_lo.device if isinstance(s_lo, torch.Tensor) else None
    _check("s_lo", s_lo, torch.int32, device)
    _check("s_hi", s_hi, torch.int32, device)
    n = int(s_lo.shape[0])
    if s_hi.shape[0] != n:
        raise ValueError("s_lo/s_hi lengths differ")
    if n >= 2**31:
        raise ValueError("batch exceeds the kernel's int index")
    if device.type != "cuda":
        raise ValueError("cuda only")
    outs = tuple(torch.empty(n, dtype=torch.int32, device=device)
                 for _ in range(4))
    if n:
        fn = build.launcher("slot_unpack")
        with torch.cuda.device(device):
            err = fn(s_lo.data_ptr(), s_hi.data_ptr(),
                     *(o.data_ptr() for o in outs), n,
                     torch.cuda.current_stream(device).cuda_stream)
        _raise_on(err, "slot_unpack")
        LAUNCHES["slot_unpack"] += 1
    return outs


def time_wrappers(gen, libs) -> dict:
    """Both index wrappers at B = 1024 by CUDA events: parent, new, new,
    parent."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops
    wa, wb, seeds, meta = synthetic_cn(gen)
    lo, hi = random_lanes(gen, cs.WINDOW)
    first = load(libs["first"][0], True)
    calls = {
        "ludo_lookup parent": lambda: parent_ludo_lookup(first, lo, hi, wa, wb,
                                                         seeds, meta),
        "ludo_lookup new": lambda: ops.ludo_lookup(lo, hi, wa, wb, seeds,
                                                   meta),
        "slot_unpack parent": lambda: parent_slot_unpack(lo, hi),
        "slot_unpack new": lambda: ops.slot_unpack(lo, hi),
    }
    res = {k: [] for k in calls}
    gc.disable()  # no collection inside one side's turn only
    try:
        for order in ("parent", "new", "new", "parent") * WRAPPER_PAIRS:
            for k, fn in calls.items():
                if k.endswith(order):
                    res[k].append(cs.time_ms(fn, 3000) * 1e3)
    finally:
        gc.enable()
    print(f"wrappers at B={cs.WINDOW}, us a call by events (parent, new, "
          f"new, parent, x{WRAPPER_PAIRS}): {res}; medians "
          f"{ {k: float(np.median(v)) for k, v in res.items()} }",
          flush=True)
    bd = cs.wrapper_breakdown(lo, hi, wa, wb, seeds, meta)
    dev, n = lo.device, lo.shape[0]

    def guard():
        with torch.cuda.device(dev):
            pass

    out2 = torch.empty((2, n), dtype=torch.int32, device="cuda")
    first_launch = launch_args(first, True, lo, hi, wa, wb, seeds, meta,
                               out2, None)
    dropped = cs.host_us({
        "device guard (parent)": guard,
        "stream object (parent)":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch.empty (n,) (parent: 2 or 4 a call)":
            lambda: torch.empty(n, dtype=torch.int32, device=dev),
        "ctypes launch of the first port (16 arguments)": first_launch,
    })
    print(f"breakdown: {bd}; the parent's pieces: {dropped}", flush=True)
    return dict(events_us=res, breakdown_us=bd, parent_pieces_us=dropped)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ludo_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build as kb
    print(smi(), flush=True)
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.perf_counter()
    libs = build_variants(kb.BUILD_DIR / "probe")
    print(f"built {len(libs)} copies in {time.perf_counter() - t0:.1f} s",
          flush=True)
    res = dict(card=smi(), ptxas={}, sass={})
    kb.build_all()
    res["sass"]["slot_unpack"] = cs.sass_opcodes(kb._lib_path("slot_unpack"))
    for k, s in res["sass"]["slot_unpack"].items():
        print(f"slot_unpack SASS {k}: {s['pipes']} {s['opcodes']}",
              flush=True)
    for v in ("base", "first"):
        log = libs[v][1]
        res["ptxas"][v] = [ln for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
        res["sass"][v] = cs.sass_opcodes(libs[v][0])
        print(f"{v} ptxas: {res['ptxas'][v]}", flush=True)
        for k, s in res["sass"][v].items():
            print(f"{v} SASS {k}: {s['pipes']} {s['opcodes']}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    bad = check(gen, libs)
    if bad:
        return 1
    res["variants"] = time_variants(gen, libs)
    res["plans"] = time_plans(gen, libs)
    res["wrappers"] = time_wrappers(gen, libs)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ludo_probe.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
