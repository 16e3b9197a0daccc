#!/usr/bin/env python3
"""Check and time ``fused_norm_matmul`` alone, on one NVIDIA card.

    python3 tools/fnm_probe.py [--train-only] [--parent DIR [--parent-only]]
                               [--train-steps]

Prints the card's name and power limit, compiles
``src/repro_torch/kernels/csrc/fused_norm_matmul.cu`` once more with
``-Xptxas -v`` (registers, shared memory and spills of each kernel), then
holds every shape of ``chip_smoke.py`` phase 6, and the ``wgmma``
regime's plan edges (``WGMMA_EDGE_SHAPES``) and ``TRAIN_SHAPES`` on every
tile width and cluster, against the plain version, printing
each shape's plan, error and whether two calls agree bit for bit (all
shapes, before any failure is raised), and ends with phase 6 itself
(``chip_smoke.check_fused_norm_matmul``: the checks, then the times at the
serve and prefill shapes beside the bound and ``F.rms_norm`` +
``torch.matmul``).  Then it times, at llama3.2-1b's decode entries (S=8,
d=2048, bf16, F = 512, 2048 and 8192, weights outside L2), each kernel of
a call by ``torch.profiler``:

- ``base``: the source as it is, on the plan's mma regime, and on other
  K-splits of d (4 to 16);
- ``loads_only``: a patched copy, built with ``nvcc`` into the package's
  ignored ``_build/probe/``, whose mma blocks stream w and x but skip the
  products (wrong answers; the loads and the loop alone);
- ``stages4``: a ring of 4 stages instead of 3.

Last, the ``wgmma`` regime at the training entries (``TRAIN_SHAPES``:
qwen3-4b's S = 2048, d = 2560 and llama3.2-1b's S = 2048, d = 2048, and
PR 16's prefill shape S = 256, d = 2048, F = 8192), weights outside L2,
each variant's device time by kernel (median of 3 traces of 20 calls)
beside the library's ``rms_norm`` + ``matmul`` device time and the bytes
the tiles pull from L2:

- this source's ``base`` on its plan, on the other tile widths and
  clusters (``plan tile N cluster C``), and its patched copies
  (``VARIANTS``): ``no_wgmma`` (the ring, the loads and the epilogue
  without the products), ``no_store`` (the epilogue skipped),
  ``no_tma_store`` (the epilogue staged but not stored), ``out256`` (a
  warpgroup's 64 x 256 outputs staged at once, in 3 stages of 48 KB, 4 of
  32 KB), ``wait0``
  (``wgmma.wait_group 0`` a step, the stage released at once) and
  ``raster_f`` (the persistent walk F-first);
- with ``--parent DIR`` (a checkout of another tree, e.g. a ``git
  archive`` of the parent commit), that tree's source and its patched
  copies (``PARENT_VARIANTS``: ``no_wgmma``, ``no_store``, ``wait1``,
  ``raster_s``), timed in turns with this source's (each shape: this
  tree, the parent, the parent, this tree).

``--train-only`` skips the checks and the decode entries;
``--parent-only`` times the parent's variants alone; ``--train-steps``
first runs phase 14 (c)'s llama3.2-1b training from one state, with the
kernel (each of its calls held to the plain version), with every ``wgmma``
call on 128-wide tiles, and with the plain version in its place, and
prints each run's losses.  Writes
``chiprun_out/fnm_probe.json``.  About 3 minutes of chip time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = Path("src/repro_torch/kernels/csrc/fused_norm_matmul.cu")
# S, d, F: qwen3-4b's training entries (q, k / v, gate / up), llama3.2-1b's,
# and PR 16's prefill shape
TRAIN_SHAPES = [(2048, 2560, 4096), (2048, 2560, 1024), (2048, 2560, 9728),
                (2048, 2048, 2048), (2048, 2048, 512), (2048, 2048, 8192),
                (256, 2048, 8192)]
# the wgmma regime's plan edges: both tile widths, a cluster whose partner
# tile lies past S (S = 2049, and S = 33 through a forced cluster), a
# ragged last column tile (F = 9736), d off 64 (1000, 2568), d = 1004 (x's
# rows not whole 16-byte chunks)
WGMMA_EDGE_SHAPES = [(2049, 1000, 1024), (2049, 2568, 9736), (33, 1000, 4096),
                     (129, 2560, 1024), (300, 1000, 9736), (2048, 2560, 9736),
                     (2049, 2560, 4096), (256, 2568, 2048), (300, 1004, 1024)]
TRACES = 3


def ptxas_report() -> str:
    from repro_torch.kernels import build
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "lib.so"),
             str(build.CSRC / "fused_norm_matmul.cu")],
            capture_output=True, text=True, timeout=600)
    return out.stdout + out.stderr


# patched copies of this source: name -> [(old text, new text)]
VARIANTS = {
    "base": [],
    "loads_only": [("mma_16816(c[j], a,", "if (j < 0) mma_16816(c[j], a,")],
    "stages4": [("constexpr int kMmaStages = 3;", "constexpr int kMmaStages = 4;")],
    "no_wgmma": [("        wgmma_k16<kBN>(acc, da, db);",
                  "        if (i < 0) wgmma_k16<kBN>(acc, da, db);")],
    "no_store": [("    // accumulator (i = 4j + 2h + c): row r + 8h, column 8j "
                  "+ 2 (lane % 4)", "    continue;")],
    "wait0": [("""      wgmma_wait<1>();
      fence_acc<kAcc>(acc);
      if (i > 0) release(it - 1);""", """      wgmma_wait<0>();
      fence_acc<kAcc>(acc);
      release(it);"""), ("""    wgmma_wait<0>();
    fence_acc<kAcc>(acc);
    release(it - 1);
""", "")],
    "no_tma_store": [("          if (x < F && y < S) tma_store_2d(",
                      "          if (x < 0 && y < S) tma_store_2d(")],
    "out256": [("constexpr int kTcRingBytes = 196608;",
                "constexpr int kTcRingBytes = 147456;"),
               ("constexpr int kTcOutCols = 128; ",
                "constexpr int kTcOutCols = 256; ")],
    "raster_f": [("  const int tiles = groups * ((F + kBN - 1) / kBN);",
                  "  const int cols = (F + kBN - 1) / kBN;\n"
                  "  const int tiles = groups * cols;"),
                 ("(t % groups * cm + rank) * kTcBM;",
                  "(t / cols * cm + rank) * kTcBM;"),
                 ("t / groups * kBN;", "t % cols * kBN;")],
}
# the wgmma variants of this source (timed at TRAIN_SHAPES; the rest at
# the decode entries)
WGMMA_VARIANTS = ("base", "no_wgmma", "no_store", "no_tma_store", "out256",
                  "wait0", "raster_f")
# patched copies of the parent's (PR 33's) wgmma kernel
PARENT_VARIANTS = {
    "base": [],
    "no_wgmma": [("      wgmma_m64n128k16(d, da, db);",
                  "      if (step < 0) wgmma_m64n128k16(d, da, db);")],
    "no_store": [("  // accumulator (i = 4j + 2h + c): row 16 wl + lane / 4 "
                  "+ 8h, column\n  // 8j + 2 (lane % 4) + c of the "
                  "warpgroup's 64 x 128 tile",
                  "  if (S > 0) return;")],
    "wait1": [(r"""    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    if (tid % 128 == 0) mbar_arrive(&empty[st]);  // stage st is free
  }
""", r"""    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(d);
    if (step > 0 && tid % 128 == 0)
      mbar_arrive(&empty[(step - 1) % kTcStages]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(d);
""")],
    "raster_s": [
        ("  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;",
         "  const int m0 = blockIdx.x * kTcBM, n0 = blockIdx.y * kTcBN;"),
        ("  const dim3 grid((F + kTcBN - 1) / kTcBN, (S + kTcBM - 1) / kTcBM);",
         "  const dim3 grid((S + kTcBM - 1) / kTcBM, (F + kTcBN - 1) / kTcBN);")],
}


def build_variants(src_path: Path, variants: dict, out_dir: Path,
                   prefix: str = "") -> dict:
    """Write and compile every variant of ``src_path``; returns variant ->
    library path."""
    from repro_torch.kernels import build as kb
    src = src_path.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in variants.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in {src_path}")
            text = text.replace(old, new)
        cu = out_dir / f"{prefix}{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{prefix}{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [kb.nvcc_path(), *kb.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {prefix}{name}:\n"
                               f"{log.decode()}")
    return {name: lib for name, (lib, _) in procs.items()}


def time_variants(gen, libs: dict) -> dict:
    import ctypes

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import ops
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    S, d = 8, 2048
    for F in (512, 2048, 8192):
        sets = cs.fnm_inputs(gen, S, d, F, torch.bfloat16,
                             max(2, -(-cs.COLD_BYTES // (d * F * 2))))
        mma = ops.fused_norm_matmul_plan(S, d, F, 2, n_sm)
        n, k = mma["splits"], mma["krange"]
        runs = [(v, v, 3, n, k) for v in VARIANTS if v not in WGMMA_VARIANTS
                or v == "base"]
        runs += [(f"base splits {m}", "base", 3, m, d // m)
                 for m in (4, 8, 16) if m != n]
        ws = torch.empty(S * F * 64 + 64 * S, device="cuda")
        out = torch.empty((S, F), dtype=torch.bfloat16, device="cuda")
        for name, lib, regime, n, k in runs:
            fn = ctypes.CDLL(str(libs[lib])).fused_norm_matmul_launch
            fn.argtypes = kb.SIGNATURES["fused_norm_matmul"][2]
            fn.restype = ctypes.c_int

            def call(it=iter(range(10**9))):
                x, g, w = sets[next(it) % len(sets)]
                err = fn(x.data_ptr(), g.data_ptr(), w.data_ptr(),
                         out.data_ptr(), ws.data_ptr(), S, d, F, 1,
                         ops.NORM_EPS, regime, n, k, 0, 0, 0, 0, stream)
                assert err == 0, err
            t = cs.device_times(call, 20, *ops.FNM_KERNELS)
            res[f"{name} F={F}"] = dict(splits=n, krange=k, **t)
            print(f"{name} F={F} (splits {n}, krange {k}): {t}, total "
                  f"{sum(t.values())}", flush=True)
    return res


def l2_feed_bytes(S: int, d: int, F: int, tile_n: int, cluster: int) -> int:
    """Bytes the wgmma tiles pull from L2 in one call: each CTA's A band
    (128 rows of the padded d) for every column tile, and each column tile
    of w once a cluster of ``cluster`` row tiles (multicast)."""
    dp = -(-d // 64) * 64
    m_tiles = -(-S // 128)
    groups = -(-m_tiles // cluster)
    return 2 * (-(-F // tile_n) * m_tiles * 128 * dp + groups * d * F)


def _launcher(lib: Path, parent: bool):
    """The launch function of ``lib``: PR 33's signature had no tile,
    cluster or CTA count."""
    import ctypes

    from repro_torch.kernels import build as kb
    fn = ctypes.CDLL(str(lib)).fused_norm_matmul_launch
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P] * 5 + [I] * 4 + [F] + [I] * 3 + [P] if parent \
        else kb.SIGNATURES["fused_norm_matmul"][2]
    fn.restype = ctypes.c_int
    return fn


def time_training(gen, libs: dict, parent_libs: dict) -> dict:
    """The wgmma regime at TRAIN_SHAPES: every variant of ``libs`` (this
    source) and ``parent_libs`` in turns, by device time, beside the
    library's."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    theirs = ("fused_norm_matmul_rows_kernel",
              "fused_norm_matmul_wgmma_kernel")
    res = {}
    for S, d, F in TRAIN_SHAPES:
        sets = cs.fnm_inputs(gen, S, d, F, torch.bfloat16,
                             max(2, -(-cs.COLD_BYTES // (d * F * 2))))
        plan = ops.fused_norm_matmul_plan(S, d, F, 2, n_sm)
        ws = torch.empty(ops.fused_norm_matmul_workspace(plan, S, d, F, 2),
                         device="cuda")
        out = torch.empty((S, F), dtype=torch.bfloat16, device="cuda")
        runs = []  # (label, launch function, plan, parent?)
        for v in WGMMA_VARIANTS if libs else ():
            runs.append((v, _launcher(libs[v], False), plan, False))
        for tile_n in (128, 256) if libs else ():
            for cluster in (1, 2):
                if (tile_n, cluster) == (plan["tile"][1], plan["cluster"]):
                    continue
                alt = dict(plan, tile=(128, tile_n), cluster=cluster,
                           ctas=ops.fused_norm_matmul_ctas(
                               S, F, tile_n, cluster, n_sm))
                runs.append((f"plan tile {tile_n} cluster {cluster}",
                             _launcher(libs["base"], False), alt, False))
        for v in parent_libs:
            runs.append((f"parent {v}", _launcher(parent_libs[v], True),
                         plan, True))
        row = dict(S=S, d=d, F=F, plan=plan, weight_sets=len(sets))
        bound, by = cs.fnm_bound(S, d, F, torch.bfloat16)
        row.update(bound_ms=bound, bound_by=by)
        lib_dev = cs.device_busy_ms(cs.cycling(cs.fnm_library, sets), 20,
                                    TRACES)
        row["library_device_ms"] = float(np.median(lib_dev))
        row["library_device_ms_traces"] = lib_dev
        row["library_ms"] = cs.time_ms(cs.cycling(cs.fnm_library, sets), 50)
        order = runs + runs[::-1]  # this tree, the parent, the parent, ...
        for label, fn, p, parent in order:
            def call(it=iter(range(10**9)), fn=fn, p=p, parent=parent):
                x, g, w = sets[next(it) % len(sets)]
                args = [x.data_ptr(), g.data_ptr(), w.data_ptr(),
                        out.data_ptr(), ws.data_ptr(), S, d, F, 1,
                        ops.NORM_EPS, 2, 1, d]
                if not parent:
                    args += [p["tile"][1], p["cluster"], p["ctas"]]
                err = fn(*args, stream)
                assert err == 0, err
            names = theirs if parent else cs.fnm_kernels_of(p)
            traces = [cs.device_times(call, 20, *names)
                      for _ in range(TRACES)]
            totals = [sum(t.values()) for t in traces]
            k = int(np.argsort(totals)[len(totals) // 2])
            rec = row.setdefault("runs", {}).setdefault(label, dict(
                tile_n=128 if parent else p["tile"][1],
                cluster=1 if parent else p["cluster"],
                device_ms=[], by_kernel=[]))
            rec["device_ms"].append(totals[k])
            rec["by_kernel"].append(traces[k])
        for label, rec in row["runs"].items():
            dev = float(np.mean(rec["device_ms"]))
            wg = float(np.mean([t.get("fused_norm_matmul_wgmma_kernel", 0.0)
                                for t in rec["by_kernel"]]))
            feed = l2_feed_bytes(S, d, F, rec["tile_n"], rec["cluster"])
            rec.update(mean_device_ms=dev, wgmma_ms=wg,
                       rows_share=1 - wg / dev if dev else None,
                       share_of_bound=bound / dev if dev else None,
                       over_library=dev / row["library_device_ms"],
                       l2_feed_bytes=feed,
                       feed_tb_per_s=feed / (wg * 1e-3) / 1e12 if wg else None)
            print(f"S={S} d={d} F={F} {label}: device {rec['device_ms']} ms "
                  f"(wgmma {wg:.6f}, rows share {rec['rows_share']}), "
                  f"{rec['share_of_bound']} of the bound {bound:.6f}, "
                  f"{rec['over_library']} x the library's device "
                  f"{row['library_device_ms']:.6f} ms; L2 feed {feed} B, "
                  f"{rec['feed_tb_per_s']} TB/s", flush=True)
        res[f"S={S} d={d} F={F}"] = row
        del sets
        torch.cuda.empty_cache()
    return res


def wgmma_plans(S: int, d: int, F: int, n_sm: int) -> list:
    """The plan of a bf16 call, and where it is ``wgmma`` the same call on
    each other tile width and cluster."""
    from repro_torch.kernels import ops
    plan = ops.fused_norm_matmul_plan(S, d, F, 2, n_sm)
    plans = [plan]
    if plan["regime"] == "wgmma":
        for tile_n in ops.FNM_WGMMA_COLS:
            for cluster in (1, ops.FNM_WGMMA_CLUSTER):
                if (tile_n, cluster) != (plan["tile"][1], plan["cluster"]):
                    plans.append(dict(
                        plan, tile=(ops.FNM_WGMMA_ROWS, tile_n),
                        cluster=cluster, ctas=ops.fused_norm_matmul_ctas(
                            S, F, tile_n, cluster, n_sm)))
    return plans


def train_steps(seed: int) -> dict:
    """``chip_smoke.py`` phase 14 (c)'s training from one state: with the
    kernel's plan, every row-5 call also held to its plain version on the
    same inputs (the largest error over all calls); with every wgmma call
    on 128-wide tiles (the same bits); with the plain version in the
    kernel's place; each run's losses."""
    import gc

    import torch

    import chip_smoke as cs
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models.lm import LM
    from repro_torch.train import SyntheticLM, make_train_step
    cfg = get_config("llama3.2-1b")
    tcfg = TrainConfig(total_steps=40, warmup_steps=2,
                       learning_rate=cs.TRAIN_LR)
    src = SyntheticLM(cfg.vocab_size, cs.TRAIN_SEQ, cs.TRAIN_B, seed=seed)
    run = ops._fused_norm_matmul_run
    errs = []

    def checked(x, gamma, w):
        out = run(x, gamma, w)
        want = ref.fused_norm_matmul_ref(x, gamma, w)
        errs.append(float((out.float() - want.float()).abs().max()))
        return out
    plan_of = ops.fused_norm_matmul_plan

    def tiles_128(*args):  # every wgmma call on 128-wide tiles
        p = plan_of(*args)
        if p["regime"] != "wgmma":
            return p
        return dict(p, tile=(ops.FNM_WGMMA_ROWS, 128),
                    ctas=ops.fused_norm_matmul_ctas(
                        args[0], args[2], 128, p["cluster"], args[4]))
    res = {}
    for name, fn, planner in (("kernel", checked, plan_of),
                              ("kernel, 128-wide tiles", run, tiles_128),
                              ("plain", ref.fused_norm_matmul_ref, plan_of)):
        model = LM(cfg)
        state, _ = cs.step_peaks(model, tcfg, src.global_batch_at(0), seed)
        step = make_train_step(model, tcfg, inplace=True)
        losses, gnorms = [], []
        ops._fused_norm_matmul_run = fn
        ops.fused_norm_matmul_plan = planner
        try:
            for i in range(1, cs.TRAIN_STEPS + 1):
                state, m = step(state, src.global_batch_at(i))
                losses.append(float(m["loss"]))
                gnorms.append(float(m["gnorm"]))
        finally:
            ops._fused_norm_matmul_run = run
            ops.fused_norm_matmul_plan = plan_of
        res[name] = dict(losses=losses, gnorms=gnorms)
        print(f"llama3.2-1b, {cs.TRAIN_STEPS} steps with row 5 as {name}: "
              f"losses {losses}, gnorms {gnorms}", flush=True)
        del model, state, step
        gc.collect()
        torch.cuda.empty_cache()
    res["kernel"].update(calls=len(errs), max_abs_err=max(errs))
    print(f"row 5 over {len(errs)} training calls: max abs err against "
          f"the plain version {max(errs)}", flush=True)
    return res


def check_shapes(shapes, every_plan: bool = False) -> list:
    """Each (S, d, F, dtype) against the plain version, twice, bit for bit
    (with ``every_plan``, a bf16 wgmma shape on each of
    :func:`wgmma_plans`); returns the failures (all shapes are run
    first)."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    bad = []
    for S, d, F, dt in shapes:
        dtype = getattr(torch, dt)
        x, g, w = cs.fnm_inputs(gen, S, d, F, dtype)[0]
        want = ref.fused_norm_matmul_ref(x, g, w)
        plans = wgmma_plans(S, d, F, n_sm) if every_plan \
            and dt == "bfloat16" else [cs.fnm_plan_of(S, d, F, dt)]
        for i, plan in enumerate(plans):
            if i == 0:
                got = ops.fused_norm_matmul(x, g, w)
                again = ops.fused_norm_matmul(x, g, w)
            else:
                got = ops._fused_norm_matmul_launch(x, g, w, plan)
                again = ops._fused_norm_matmul_launch(x, g, w, plan)
            torch.cuda.synchronize()
            e = float((got.float() - want.float()).abs().max())
            tol = cs.FNM_TOL[dt]
            ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                     atol=tol))
            same = bool(torch.equal(got, again))
            print(f"S={S} d={d} F={F} {dt} {plan}: max abs err {e} "
                  f"{'ok' if ok else 'WRONG'}, repeat "
                  f"{'same' if same else 'DIFFERS'}", flush=True)
            if not (ok and same):
                bad.append((S, d, F, dt, plan))
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train-only", action="store_true")
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--parent-only", action="store_true")
    ap.add_argument("--train-steps", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fnm_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build as kb
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    print(ptxas_report(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    res = {}
    if args.train_steps:
        res["train_steps"] = train_steps(cs.SEED)
        args.train_only = True
    if not args.train_only:
        bad = check_shapes(cs.FNM_CHECK_SHAPES) + check_shapes(
            [(*sh, "bfloat16") for sh in WGMMA_EDGE_SHAPES + TRAIN_SHAPES],
            every_plan=True)
        if bad:
            print(f"{len(bad)} shapes failed: {bad}", flush=True)
            return 1
        res = cs.check_fused_norm_matmul(gen)
    out_dir = kb.BUILD_DIR / "probe"
    libs = {} if args.parent_only else build_variants(
        kb.CSRC / "fused_norm_matmul.cu", VARIANTS, out_dir)
    parent_libs = {}
    if args.parent is not None:
        parent_libs = build_variants(args.parent / SOURCE, PARENT_VARIANTS,
                                     out_dir, "parent_")
    if not args.train_only:
        res["variants"] = time_variants(gen, libs)
    res["training"] = time_training(gen, libs, parent_libs)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fnm_probe.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
