"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` into a shared library with a
plain C interface, for ``sm_90a`` (Hopper), and loaded with ``ctypes``.
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
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
# C signature of each library's launch function: (name, argtypes)
SIGNATURES = {
    "ludo_lookup": ("ludo_lookup_launch",
                    [_P, _P, _P, _P, _P, _P, _P, _I,
                     _U, _U, _U, _U, _U, _U, _U, _P]),
    "slot_unpack": ("slot_unpack_launch", [_P, _P, _P, _P, _P, _P, _I, _P]),
}

_loaded: dict[str, tuple] = {}  # name -> (CDLL, launch function)


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
    """Run one nvcc per missing library, all at once; raise on any failure."""
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
    """Compile every kernel that is not built yet; returns the seconds taken."""
    t0 = time.perf_counter()
    _compile(SIGNATURES)
    return time.perf_counter() - t0


def launcher(name: str):
    """The ``ctypes`` launch function of kernel ``name`` (built if needed)."""
    if name not in _loaded:
        _compile([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        sym, argtypes = SIGNATURES[name]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = (lib, fn)
    return _loaded[name][1]
