"""The examples' torch counterparts run on the CPU:
``examples/quickstart_torch.py`` prints the reference quickstart's lines
(the same store, operations and meters), and
``examples/serve_kvs_torch.py`` serves its requests and finds the Ludo
and cuckoo paged attention's outputs equal.  Without a card, both refuse
to start unless ``--device cpu``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")


def _run(script: str, *args, check: bool = True):
    return subprocess.run([sys.executable, str(ROOT / "examples" / script),
                           *args], env=ENV, cwd=ROOT, capture_output=True,
                          text=True, timeout=600, check=check)


def test_quickstart_torch_prints_the_reference_lines_on_cpu():
    got = _run("quickstart_torch.py", "--device", "cpu").stdout.splitlines()
    want = _run("quickstart.py").stdout.splitlines()
    assert got[:-1] == want
    assert got[-1].startswith("kernel launches: ")


def test_serve_kvs_torch_runs_on_cpu():
    out = _run("serve_kvs_torch.py", "--device", "cpu").stdout
    assert "served 10 requests" in out
    assert "paged attention: outputs match = True" in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("script", ["quickstart_torch.py",
                                    "serve_kvs_torch.py"])
def test_examples_refuse_without_a_card(script):
    out = _run(script, check=False)
    assert out.returncode != 0
    assert "pass --device cpu" in out.stderr
