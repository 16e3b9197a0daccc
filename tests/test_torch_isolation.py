"""The port stands alone: no JAX, no ``repro``, no quiet CPU fallback.

* an AST scan of every module under ``src/repro_torch/`` and of
  ``chip_smoke.py`` finds no import of ``jax`` or of ``repro``;
* a fresh interpreter that imports ``repro_torch.api`` (and builds a store
  on the CPU) has neither ``jax`` nor ``repro`` in ``sys.modules``;
* without a card, the entry points raise unless the caller passes
  ``device="cpu"``, and ``chip_smoke.py`` exits non-zero with no result.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.api import StoreSpec, open_store
from repro_torch.core import outback
from repro_torch.core.hashing import splitmix64
from repro_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_sources_import_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import sys, json, numpy as np\n"
        "import repro_torch.api as api\n"
        "from repro_torch.core.hashing import splitmix64\n"
        "k = splitmix64(np.arange(1, 200, dtype=np.uint64))\n"
        "st = api.open_store(api.StoreSpec('outback'), k, k, device='cpu')\n"
        "assert st.get_batch(k).found.all()\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0]"
        " in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_kernels_are_built_from_the_repo_sources_only():
    srcs = sorted(p.name for p in build.CSRC.glob("*.cu"))
    assert srcs == ["ludo_lookup.cu", "slot_unpack.cu"]
    assert set(build.SIGNATURES) == {"ludo_lookup", "slot_unpack"}
    assert build.BUILD_DIR == ROOT / "src" / "repro_torch" / "kernels" / "_build"
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    gitignore = (ROOT / ".gitignore").read_text().split()
    assert "/src/repro_torch/kernels/_build/" in gitignore


def test_entry_points_raise_without_cuda(monkeypatch):
    """``device=None`` means CUDA: no card is an error, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    keys = splitmix64(np.arange(1, 100, dtype=np.uint64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        open_store(StoreSpec("outback"), keys, keys)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        outback.OutbackShard(keys, keys)
    assert open_store(StoreSpec("outback"), keys, keys,
                      device="cpu").engine.device.type == "cpu"


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run")
    env = dict(os.environ, PYTHONPATH="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:  # a directory with chip_smoke.py and nothing else
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
