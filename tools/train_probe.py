#!/usr/bin/env python3
"""Phase 14 of ``chip_smoke.py`` alone (the training path), on one NVIDIA
card.

    python3 tools/train_probe.py            # phase 14
    python3 tools/train_probe.py --kernel   # (a) only: the backward kernel

Prints the card's name and power limit, builds the kernels, prints
``-Xptxas -v`` for ``csrc/fused_norm_matmul_bwd.cu`` (registers, shared
memory and spills of each kernel), then runs
``chip_smoke.serve_training_phase`` ((a)-(c), and (d): qwen3-4b whole,
trained in place) and prints the numbers as one JSON line.  Without a
card it exits 1.

``--kernel`` runs (a) alone: every check shape against the plain version,
printed with its plan before any failure is raised, then
``chip_smoke.check_fused_norm_matmul_bwd``, then patched copies of the
source (written and built with ``nvcc`` in a temporary directory), timed
by ``torch.profiler`` kernel by kernel at the bf16 training entries (S =
d = 2048; RUNS: F = 8192, the source first and last, then other tiles
and S-splits at F = 2048 and 512) through the plan's arguments:

- ``base``: the source as it is;
- ``l2_256``: the tensor maps promote 256-byte lines into L2, not 128;
- ``no_wgmma``: the wgmma dw without its products (the TMA ring and the
  epilogue alone; wrong answers);
- ``no_tma``: the wgmma dw without its TMA loads and their waits (the
  products on whatever the ring holds, and the ring's handshake);
- ``stages1``: one stage, its products awaited before it is reloaded;
- ``stages3``: three stages instead of four;
- ``inflight2``: two stages' products in flight a consumer, not one;
- ``no_dgamma``: the row pass without its dgamma partials (wrong
  dgamma).

The times go to ``chiprun_out/train_probe.json`` too.
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

SOURCE = "fused_norm_matmul_bwd.cu"
VARIANTS = {
    "base": [],
    "l2_256": [("CU_TENSOR_MAP_L2_PROMOTION_L2_128B",
                "CU_TENSOR_MAP_L2_PROMOTION_L2_256B")],
    "inflight2": [("constexpr int kWgInFlight = 1;",
                   "constexpr int kWgInFlight = 2;")],
    "stages3": [("constexpr int kWgBK = 64, kWgStages = 4;",
                 "constexpr int kWgBK = 64, kWgStages = 3;")],
    "no_wgmma": [("      wgmma_tt<kBN>(acc, da, db);",
                  "      if (kk < 0) wgmma_tt<kBN>(acc, da, db);")],
    "no_tma": [("        mbar_expect_tx(&full[st], kStageBytes);",
                "        if (i < 0) mbar_expect_tx(&full[st], kStageBytes);"),
               ("          tma_load_2d(p + b * kWgBox, &map_a,",
                "          if (i < 0) tma_load_2d(p + b * kWgBox, &map_a,"),
               ("          tma_load_2d(p + (kWgConsumers + b) * kWgBox,",
                "          if (i < 0) tma_load_2d(p + (kWgConsumers + b) * kWgBox,"),
               ("    mbar_wait(&full[st], (i / kWgStages) & 1);",
                "    if (i < 0) mbar_wait(&full[st], (i / kWgStages) & 1);")],
    "no_dgamma": [("      if constexpr (!kTurns) add_dgamma(s, rr);",
                   "      if (s < 0) add_dgamma(s, rr);")],
    "stages1": [("constexpr int kWgBK = 64, kWgStages = 4;",
                 "constexpr int kWgBK = 64, kWgStages = 1;"),
                ("constexpr int kWgInFlight = 1;",
                 "constexpr int kWgInFlight = 0;")],
}
# (variant, F, columns of dw's tile, splits of S; None for the plan's) at
# S = d = 2048, bf16, in the order timed: the variants at F = 8192 between
# two runs of the source, then other tiles and splits at F = 2048 and 512
# (a tile of 128 x 256 gives 128 and 32 tiles there, one of 128 x 128 256
# and 64)
RUNS = [("base", 8192, None, None), ("l2_256", 8192, None, None),
        ("no_wgmma", 8192, None, None), ("no_tma", 8192, None, None),
        ("stages1", 8192, None, None), ("stages3", 8192, None, None),
        ("inflight2", 8192, None, None), ("no_dgamma", 8192, None, None),
        ("base", 8192, 128, 1), ("base", 8192, None, None),
        ("base", 2048, 256, 1), ("base", 2048, 128, 1),
        ("base", 2048, 256, 2),
        *[("base", 512, 128, n) for n in (1, 2, 3)],
        *[("base", 512, 256, n) for n in (2, 4)]]


def ptxas_report() -> str:
    from repro_torch.kernels import build
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "lib.so"), str(build.CSRC / SOURCE)],
            capture_output=True, text=True, timeout=600)
    return out.stdout + out.stderr


def sources() -> dict:
    """Variant -> its source text; raises if a patch does not match."""
    from repro_torch.kernels import build
    src = (build.CSRC / SOURCE).read_text()
    out = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in the source "
                                   f"once")
            text = text.replace(old, new)
        out[name] = text
    return out


def build_variants(out_dir: Path) -> dict:
    """Write and compile every variant at once; variant -> library."""
    from repro_torch.kernels import build
    procs = {}
    for name, text in sources().items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode()}")
    return {name: lib for name, (lib, _) in procs.items()}


def check_shapes(gen) -> list:
    """Every check shape of phase 14 (a) against the plain version, each
    printed with its plan; the shapes that failed."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    bad = []
    for S, d, F, dt in cs.FNMB_CHECK_SHAPES:
        dtype = getattr(torch, dt)
        x, g, w = cs.fnm_inputs(gen, S, d, F, dtype)[0]
        dy = torch.randn((S, F), generator=gen, device="cuda").to(dtype)
        try:
            got = ops.fused_norm_matmul_bwd(x, g, w, dy)
            again = ops.fused_norm_matmul_bwd(x, g, w, dy)
            torch.cuda.synchronize()
        except RuntimeError as e:
            print(f"S={S} d={d} F={F} {dt}: FAILED {e}", flush=True)
            bad.append((S, d, F, dt))
            continue
        want = ref.fused_norm_matmul_bwd_ref(x, g, w, dy)
        rel = {n: cs._rel_err(a, b) for n, a, b in
               zip(("dx", "dgamma", "dw"), got, want)}
        ok = max(rel.values()) <= cs.FNM_TOL[dt]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        print(f"S={S} d={d} F={F} {dt} {cs.fnmb_plan_of(S, d, F, dt)}: "
              f"rel err {rel} {'ok' if ok else 'WRONG'}, repeat "
              f"{'same' if same else 'DIFFERS'}", flush=True)
        if not (ok and same):
            bad.append((S, d, F, dt))
    return bad


def time_variants(gen, libs: dict) -> dict:
    """The kernels of each of RUNS, by profiler, through the plan's launch
    arguments with the run's tile and splits."""
    import ctypes

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    S = d = cs.D_MODEL
    rows = ops.fused_norm_matmul_bwd_plan(S, n_sm)
    ws = torch.empty(ops.fused_norm_matmul_bwd_workspace(S, d, rows),
                     device="cuda")
    res = {}
    for F in sorted({f for _, f, _, _ in RUNS}, reverse=True):
        sets = [(*cs.fnm_inputs(gen, S, d, F, torch.bfloat16)[0],
                 torch.randn((S, F), generator=gen, device="cuda")
                 .to(torch.bfloat16)) for _ in range(2)]
        plan = ops.fused_norm_matmul_bwd_dw_plan(S, d, F, 2, n_sm)
        most = max(n or plan["splits"] for _, f, _, n in RUNS if f == F)
        ws_dw = torch.empty(ops.fused_norm_matmul_bwd_dw_workspace(
            dict(plan, splits=most), S, d, F), device="cuda")
        dx, dg, dw = (torch.empty_like(t) for t in sets[0][:3])
        dns = [torch.matmul(dy, w.t()) for _, _, w, dy in sets]
        for turn, (name, f, tile_n, n) in enumerate(RUNS):
            if f != F:
                continue
            tile_n, splits = tile_n or plan["tile"][1], n or plan["splits"]
            fn = ctypes.CDLL(str(libs[name])).fused_norm_matmul_bwd_launch
            fn.argtypes = build.SIGNATURES["fused_norm_matmul_bwd"][2]
            fn.restype = ctypes.c_int

            def call(it=iter(range(10**9))):
                i = next(it) % len(sets)
                x, g, _, dy = sets[i]
                err = fn(x.data_ptr(), g.data_ptr(), dy.data_ptr(),
                         dns[i].data_ptr(), dx.data_ptr(), dg.data_ptr(),
                         dw.data_ptr(), ws.data_ptr(), ws_dw.data_ptr(), S,
                         d, F, 1, ops.NORM_EPS, rows,
                         ops.FNM_BWD_REGIMES.index(plan["regime"]), tile_n,
                         splits, int(plan["reread"]), stream)
                assert err == 0, err
            t = cs.device_times(call, 20, *cs.fnmb_kernels_of(
                dict(plan, splits=splits)))
            key = f"{turn} {name} F={F} tile_n={tile_n} splits={splits}"
            res[key] = t
            print(f"{key}: {t}, total {sum(t.values())}", flush=True)
        del sets, dns, ws_dw
    return res


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
        bad = check_shapes(gen)
        if bad:
            print(f"{len(bad)} shapes failed: {bad}", flush=True)
            return 1
        out = dict(record=cs.check_fused_norm_matmul_bwd(gen))
        with tempfile.TemporaryDirectory() as tmp:
            out["variants"] = time_variants(gen, build_variants(Path(tmp)))
    else:
        record, res, launches = cs.serve_training_phase(gen)
        out = dict(record=record, res=res, launches=launches)
    print(f"probe: {time.perf_counter() - t:.1f} s", flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / "train_probe.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
