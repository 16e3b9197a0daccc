"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` into a shared library with a
plain C interface (one library may hold several kernels' launch functions), for ``sm_90a`` (Hopper), and loaded with ``ctypes``.
:func:`build_all` starts one ``nvcc`` per source at once, so a cold build
costs the slowest file, not the sum.  Libraries land in ``_build/`` beside
this module (listed in ``.gitignore``), inside the package's own tree
whether it runs from a checkout or is installed, named by a hash of their
source and flags, so an edited source is rebuilt and an unchanged one is
reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_U64 = ctypes.c_uint64
_F = ctypes.c_float
# q, k_pool, v_pool, page_map, o, m, l, workspace; n_pages, n_pool, ps,
# n_kv, g, d, dtype, seq_len, split_pages; stream
_PAGED = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
          _P]
# Each kernel's launch function: kernel -> (library, C symbol, argtypes).
# A library is built from ``csrc/<library>.cu``.
SIGNATURES = {
    # key_lo, key_hi, words_a, words_b, seeds, bucket, slot; n; the magics
    # of ma, mb, nb; ma, mb, nb and the four seeds; the plan's threads and
    # blocks; stream
    "ludo_lookup": ("ludo_lookup", "ludo_lookup_launch",
                    [_P, _P, _P, _P, _P, _P, _P, _I, _U64, _U64, _U64,
                     _U, _U, _U, _U, _U, _U, _U, _I, _I, _P]),
    "slot_unpack": ("slot_unpack", "slot_unpack_launch",
                    [_P, _P, _P, _P, _P, _P, _I, _P]),
    "paged_attention": ("paged_attention", "paged_attention_launch", _PAGED),
    "cuckoo_paged_attention": ("paged_attention",
                               "cuckoo_paged_attention_launch",
                               [_P, _P, _P, _P, _P, *_PAGED[4:]]),
    # x, gamma, w, out, workspace; S, d, F, dtype, eps, regime, splits,
    # krange, the wgmma regime's tile columns, cluster and CTAs; stream
    "fused_norm_matmul": ("fused_norm_matmul", "fused_norm_matmul_launch",
                          [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                           _I, _I, _I, _I, _P]),
    # x, gamma, dy, dn, dx, dgamma, dw, workspace, dw's workspace; S, d,
    # F, dtype, eps, rows a block of the row pass, regime, dw's tile
    # columns, splits, reread; stream
    "fused_norm_matmul_bwd": ("fused_norm_matmul_bwd",
                              "fused_norm_matmul_bwd_launch",
                              [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _F, _I, _I, _I, _I, _I, _P]),
}
LIBRARIES = sorted({lib for lib, _, _ in SIGNATURES.values()})

_BUILD_LOCK = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}  # library -> loaded library
_loaded: dict[str, object] = {}  # kernel -> launch function


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(nvcc, os.X_OK):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source and need the CUDA toolkit")
    return nvcc


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _compile(names) -> None:
    """Run one nvcc per missing library (``names`` are library names), all
    at once; raise on any failure.  One build at a time in a process, so a
    kernel's first launch waits for a build another thread started."""
    with _BUILD_LOCK:
        _compile_missing(names)


def _compile_missing(names) -> None:
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log.decode()}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def build_all() -> float:
    """Compile every library that is not built yet; returns the seconds
    taken."""
    t0 = time.perf_counter()
    _compile(LIBRARIES)
    return time.perf_counter() - t0


def launcher(name: str):
    """The ``ctypes`` launch function of kernel ``name`` (its library built
    if needed)."""
    if name not in _loaded:
        lib_name, sym, argtypes = SIGNATURES[name]
        if lib_name not in _libs:
            _compile([lib_name])
            _libs[lib_name] = ctypes.CDLL(str(_lib_path(lib_name)))
        fn = getattr(_libs[lib_name], sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return _loaded[name]
