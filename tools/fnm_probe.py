#!/usr/bin/env python3
"""Check and time ``fused_norm_matmul`` alone, on one NVIDIA card.

    python3 tools/fnm_probe.py

Prints the card's name and power limit, compiles
``src/repro_torch/kernels/csrc/fused_norm_matmul.cu`` once more with
``-Xptxas -v`` (registers, shared memory and spills of each kernel), then
holds every shape of ``chip_smoke.py`` phase 6 against the plain version,
printing each shape's plan, error and whether two calls agree bit for bit
(all shapes, before any failure is raised), and ends with phase 6 itself
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

About a minute of chip time against four for the whole script.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def ptxas_report() -> str:
    from repro_torch.kernels import build
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(Path(tmp) / "lib.so"),
             str(build.CSRC / "fused_norm_matmul.cu")],
            capture_output=True, text=True, timeout=600)
    return out.stdout + out.stderr


VARIANTS = {
    "base": [],
    "loads_only": [("mma_16816(c[j], a,", "if (j < 0) mma_16816(c[j], a,")],
    "stages4": [("constexpr int kMmaStages = 3;", "constexpr int kMmaStages = 4;")],
}


def build_variants(out_dir: Path) -> dict:
    """Write and compile every variant; returns variant -> library path."""
    from repro_torch.kernels import build as kb
    src = (kb.CSRC / "fused_norm_matmul.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [kb.nvcc_path(), *kb.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log.decode()}")
    return {name: lib for name, (lib, _) in procs.items()}


def time_variants(gen) -> dict:
    import ctypes

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import ops
    libs = build_variants(kb.BUILD_DIR / "probe")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    S, d = 8, 2048
    for F in (512, 2048, 8192):
        sets = cs.fnm_inputs(gen, S, d, F, torch.bfloat16,
                             max(2, -(-cs.COLD_BYTES // (d * F * 2))))
        mma = ops.fused_norm_matmul_plan(S, d, F, 2, n_sm)
        n, k = mma["splits"], mma["krange"]
        runs = [(v, v, 3, n, k) for v in VARIANTS]
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
                         ops.NORM_EPS, regime, n, k, stream)
                assert err == 0, err
            t = cs.device_times(call, 20, *ops.FNM_KERNELS)
            res[f"{name} F={F}"] = dict(splits=n, krange=k, **t)
            print(f"{name} F={F} (splits {n}, krange {k}): {t}, total "
                  f"{sum(t.values())}", flush=True)
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fnm_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    print(ptxas_report(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    bad = []
    for S, d, F, dt in cs.FNM_CHECK_SHAPES:
        dtype = getattr(torch, dt)
        x, g, w = cs.fnm_inputs(gen, S, d, F, dtype)[0]
        got = ops.fused_norm_matmul(x, g, w)
        again = ops.fused_norm_matmul(x, g, w)
        want = ref.fused_norm_matmul_ref(x, g, w)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        tol = cs.FNM_TOL[dt]
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
        same = bool(torch.equal(got, again))
        plan = cs.fnm_plan_of(S, d, F, dt)
        print(f"S={S} d={d} F={F} {dt} {plan}: max abs err {e} "
              f"{'ok' if ok else 'WRONG'}, repeat {'same' if same else 'DIFFERS'}",
              flush=True)
        if not (ok and same):
            bad.append((S, d, F, dt))
    if bad:
        print(f"{len(bad)} shapes failed: {bad}", flush=True)
        return 1
    res = cs.check_fused_norm_matmul(gen)
    res["variants"] = time_variants(gen)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fnm_probe.json").write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
