"""Tensor parallelism of the four families whose mixers split otherwise
than gqa's, against ``repro``'s ``LM(cfg, mesh=Mesh(devices (1, 2),
("data", "model")))``, a mesh of GSPMD-auto axes (the reference shards
these mixers through its parameter specs alone; the port runs each rank's
program):

* deepseek-v3-671b: MLA by heads (``wq_b``, ``wk_b``, ``wv_b`` by
  columns, ``wo`` by rows, the latent replicated), its MoE through
  ``moe_spmd`` (sigmoid scores, one shared expert) and the MTP block;
* jamba-v0.1-52b: mamba by channels, ``w_in``'s halves exchanged
  (rank 0's shard is all of ``x``, rank 1's all of ``z``), with gqa, MLP
  and MoE layers;
* rwkv6-1.6b: the time mix by heads (the decay LoRA replicated, the state
  split), the channel mix by ``c_k`` columns and ``c_v`` rows;
* whisper-large-v3: the decoder's cross-attention and the encoder by
  heads, a prefill over encoder ``frames``.

One module fixture writes seeded float32 weights and inputs for the
reduced configs and runs at once the reference in one subprocess over 4
host devices and the port in one world of two gloo ranks
(``_torch_tp_rank.run_cases``).  Prefill logits, three decode steps,
``train_loss`` and every gradient shard agree within 1e-5 (the MoE
cases' gradients against the reference's unsharded ones: its
``moe_spmd`` under a mesh does not sum its replicated inputs'
cotangents); the collectives of serving are counted, and
``gather_params`` of every rank's shards gives the weights back bit for
bit.
"""

import pytest

from _torch_tp_checks import check_grads, check_serve_collectives, \
    check_serving, round_trips
from _torch_tp_rank import run_cases

B, S = 2, 16
CASES = [
    dict(name="deepseek", arch="deepseek-v3-671b", mesh=[1, 2]),
    dict(name="jamba", arch="jamba-v0.1-52b", mesh=[1, 2]),
    dict(name="rwkv", arch="rwkv6-1.6b", mesh=[1, 2]),
    dict(name="whisper", arch="whisper-large-v3", mesh=[1, 2]),
]
NAMES = [c["name"] for c in CASES]
BY_NAME = dict(zip(NAMES, CASES))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("tp_families"), CASES, 2,
                     batch=B, seq=S)


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_tp_family_prefill_and_decode_vs_reference(runs, name):
    """Both ranks' prefill logits (whisper's over its encoder frames) and
    three decode steps equal the reference's."""
    check_serving(*runs, BY_NAME[name])


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_tp_family_loss_and_sharded_grads_vs_reference(runs, name):
    """``train_loss`` on both ranks, and each rank's gradient of each of
    its shards (jamba's ``w_in`` shard among them) against that slice of
    the reference's."""
    assert check_grads(*runs, BY_NAME[name]) > 0


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_tp_family_collectives_counted(runs, name):
    """What crossed ``model`` in serving: the psums and gathers the
    family's split layers imply, and their bytes."""
    check_serve_collectives(runs[1], BY_NAME[name], batch=B, seq=S)


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_tp_family_shards_round_trip(runs, name):
    """``shard_params`` then ``gather_params`` over the mesh gives every
    leaf back bit for bit."""
    assert round_trips(runs[1], BY_NAME[name])
