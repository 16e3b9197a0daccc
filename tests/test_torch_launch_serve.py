"""The port's serving launcher (``python -m repro_torch.launch.serve``)
against the reference's (``python -m repro.launch.serve``) on the CPU.

Each launcher runs in a subprocess of its own, as a user would start it,
with its defaults (8 requests of 6 prompt tokens, 4 lanes, 8 new tokens,
128 positions, the reduced config, weights from seed 0).  For
mixtral-8x22b both run and their final lines are equal; llava,
deepseek, jamba and whisper run through the port alone, since each reference run spends its
time on jit compiles, and their lines are the counts the engine's
schedule implies (the reference's, which no token value moves: the
engine stops a request at ``max_new`` here).  Without a card the
launcher raises unless given ``--device cpu``.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# 8 requests through 4 lanes: two waves of 8 batched steps, 6 prompt tokens
# a request
LINE = "finished=8 decode_steps=16 prefill_tokens=48"


def _last_line(module: str, *args: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", module, *args], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_mixtral_line_equals_the_reference_launchers():
    arch = ("--arch", "mixtral-8x22b")
    got = _last_line("repro_torch.launch.serve", *arch, "--device", "cpu")
    want = _last_line("repro.launch.serve", *arch)
    assert got == want == LINE


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "deepseek-v3-671b", "jamba-v0.1-52b",
                                  "whisper-large-v3"])
def test_port_launcher_serves_the_family(arch):
    got = _last_line("repro_torch.launch.serve", "--arch", arch, "--device",
                     "cpu")
    assert got == LINE


def test_launcher_flags_move_the_counts(capsys):
    """The reference's flags, in process: 3 requests of 6 prompt tokens
    through 2 lanes, 4 new tokens each."""
    from repro_torch.launch import serve
    serve.main(["--arch", "deepseek-v3-671b", "--device", "cpu",
                "--requests", "3", "--lanes", "2", "--max-new", "4",
                "--max-seq", "32"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == \
        "finished=3 decode_steps=8 prefill_tokens=18"


def test_launcher_raises_without_cuda(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "mixtral-8x22b"])
