#!/usr/bin/env python3
"""Where the paged split pass spends its time, on one NVIDIA card.

    python3 tools/paged_probe.py

Builds patched copies of ``src/repro_torch/kernels/csrc/paged_attention.cu``
with ``nvcc`` (one process each, all at once) into the package's ignored
``_build/probe/``, and times each copy's split and combine passes with
``torch.profiler`` at the serve shape of ``chip_smoke.py`` phase 4
(llama3.2-1b's attention: 8 KV heads of 4 queries, d=64, 16-token bf16
pages, L=1954, over COLD_SETS maps of a 2^17-page pool), Ludo and cuckoo,
in two rounds.  The copies:

- ``base``: the source as it is;
- ``no_load``: every copy zero-fills instead of reading device memory;
- ``no_compute``: no scores, softmax or p.v (the loads and the loop);
- ``skeleton``: neither;
- ``stages2``, ``stages3``: a ring of 2 or 3 loop steps instead of 4;
- ``rows64``: loop steps of 4 pages, a ring of 2;
- ``blocks8``: 8 blocks an SM (64 registers) instead of 6.

Only ``base`` computes the right answer; the script first holds it against
the plain version (``chip_smoke.check_paged_kernels``, which also prints
its times).  Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src/repro_torch/kernels/csrc/paged_attention.cu"
LOAD = ("k_pool + off, in_pool ? 16 : 0);", "v_pool + off, in_pool ? 16 : 0);")
NO_LOAD = [(a, a.replace("in_pool ? 16 : 0", "0")) for a in LOAD]
NO_COMPUTE = [("for (int r0 = 0; r0 < rows; r0 += kRowsPerPass) {",
               "for (int r0 = rows; r0 < rows; r0 += kRowsPerPass) {")]
VARIANTS = {
    "base": [],
    "no_load": NO_LOAD,
    "no_compute": NO_COMPUTE,
    "skeleton": NO_LOAD + NO_COMPUTE,
    "stages2": [("kMaxStages = 4;", "kMaxStages = 2;")],
    "stages3": [("kMaxStages = 4;", "kMaxStages = 3;")],
    "rows64": [("kMaxStages = 4;", "kMaxStages = 2;"),
               ("kRowsPerIter = 32;", "kRowsPerIter = 64;")],
    "blocks8": [("__launch_bounds__(kThreads, 6)",
                 "__launch_bounds__(kThreads, 8)")],
}


def build(out_dir: Path) -> dict:
    """Write and compile every variant; returns variant -> library path."""
    from repro_torch.kernels import build as kb
    src = SOURCE.read_text()
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("paged_probe: needs an NVIDIA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build as kb
    from repro_torch.kernels import ops
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(kb.BUILD_DIR / "probe")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    shape = (1 << cs.PAGE_POOL_LOG2, cs.PAGE_SIZE, cs.N_KV, cs.HEAD_DIM)
    k_pool = torch.randn(shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    v_pool = torch.randn(shape, generator=gen, device="cuda",
                         dtype=torch.bfloat16)
    cs.check_paged_kernels(k_pool, v_pool, gen)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    split = ops.paged_split_plan(cs.SERVE_PAGES, cs.N_KV, cs.GROUP, n_sm)[0]
    seq_len = cs.SEQ_TOKENS * cs.N_SEQS
    sets = []
    for _ in range(cs.COLD_SETS):
        q = torch.randn((cs.N_KV, cs.GROUP, cs.HEAD_DIM), generator=gen,
                        device="cuda").to(torch.bfloat16)
        sets.append((q, *cs.paged_maps(gen, k_pool.shape[0], cs.SERVE_PAGES,
                                       split)))
    for rnd in range(2):
        for name, lib_path in libs.items():
            lib = ctypes.CDLL(str(lib_path))
            for kern in ("paged_attention", "cuckoo_paged_attention"):
                _, sym, argtypes = kb.SIGNATURES[kern]
                fn = getattr(lib, sym)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                kb._loaded[kern] = fn  # the wrappers launch this copy
            it = itertools.cycle(sets)

            def ludo():
                q, pm, _, _ = next(it)
                return ops.paged_attention(q, k_pool, v_pool, pm, seq_len)

            def cuckoo():
                q, _, pm2, sel = next(it)
                return ops.cuckoo_paged_attention(q, k_pool, v_pool, pm2,
                                                  sel, seq_len)
            times = []
            for f in (ludo, cuckoo):
                times += [cs.device_ms(f, 20, "paged_split_kernel"),
                          cs.device_ms(f, 20, "paged_combine_kernel")]
            print(f"round {rnd} {name}: Ludo split {times[0]} combine "
                  f"{times[1]}; cuckoo split {times[2]} combine {times[3]} "
                  f"(ms)", flush=True)
    kb._loaded.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
