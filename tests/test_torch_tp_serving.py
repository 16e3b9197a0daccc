"""Serving over a mesh beyond the tp = 2 program of ``test_torch_tp.py``,
against ``repro``'s ``LM(cfg, mesh=...)`` over GSPMD-auto axes:

* mixtral-8x22b with ``moe_gather_decode`` at ``(1, 2)``: each decode
  step's MoE runs ``moe_gather_spmd`` (the rank's routed picks of its
  experts, one psum); prefill and training run ``moe_spmd``;
* llama3.2-1b served over ``(2, 1)``, the batch split over ``data`` (each
  rank its lanes of the cache and ``length``, no collective);
* llama3.2-1b over ``(2, 2)``, a world of four ranks: data and tensor
  parallelism at once.

One module fixture runs the reference in one subprocess over 4 host
devices and the port in a world of four gloo ranks for the ``(2, 2)``
case and one of two for the others (``_torch_tp_rank.run_cases``).  Each
rank's prefill logits and three decode steps equal the reference's rows
of its lanes, the mean of the data ranks' losses and gradient shards the
reference's, within 1e-5; the collectives are counted.  In process: the
sequence splits of the cache build, with each rank's chunk, and a batch
that does not divide over ``data`` raises (the splits are held to the
reference in ``test_torch_tp_seqcache.py``).
"""

import dataclasses

import pytest

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.models.common import Spec

from _torch_tp_checks import check_grads, check_serve_collectives, \
    check_serving, round_trips
from _torch_tp_rank import rank_mesh, run_cases

B, S = 4, 16
TWO = [
    dict(name="mixtral_gather", arch="mixtral-8x22b", mesh=[1, 2],
         replace={"moe_gather_decode": True}),
    dict(name="llama_data", arch="llama3.2-1b", mesh=[2, 1]),
]
FOUR = [dict(name="llama_data_tp", arch="llama3.2-1b", mesh=[2, 2])]
CASES = TWO + FOUR
NAMES = [c["name"] for c in CASES]
BY_NAME = dict(zip(NAMES, CASES))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> {case name: (the reference's outputs, [each rank's])}."""
    two = run_cases(tmp_path_factory.mktemp("tp_two"), TWO, 2, batch=B,
                    seq=S)
    four = run_cases(tmp_path_factory.mktemp("tp_four"), FOUR, 4, batch=B,
                     seq=S)
    return {**{c["name"]: two for c in TWO},
            **{c["name"]: four for c in FOUR}}


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_tp_serving_prefill_and_decode_vs_reference(runs, name):
    """Each rank's prefill logits and three decode steps on its lanes
    equal the reference's rows."""
    check_serving(*runs[name], BY_NAME[name])
    assert round_trips(runs[name][1], BY_NAME[name])


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_tp_serving_loss_and_sharded_grads_vs_reference(runs, name):
    """The data ranks' mean loss and mean gradient of each shard against
    the reference's (mixtral's against its unsharded gradients)."""
    assert check_grads(*runs[name], BY_NAME[name]) > 0


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_tp_serving_collectives_counted(runs, name):
    """One psum a split layer (the gather MoE's too), the embedding's and
    the logits' gather over ``model``; nothing over ``data``."""
    check_serve_collectives(runs[name][1], BY_NAME[name], batch=B, seq=S)


def _llama(**kw):
    return dataclasses.replace(get_config("llama3.2-1b", reduced=True), **kw)


def test_sequence_splits_build():
    """``cache_seq_shard`` at tp > 1 and a batch-1 cache over a data axis
    above 1 build, with each rank's chunk of the sequence (the split
    leaves' local shapes); a batch of 1 without a data axis, and
    ``cache_seq_shard`` at tp = 1, build whole; a batch that does not
    divide over ``data`` still raises."""
    seq = _llama(cache_seq_shard=True)
    model = lm.LM(seq, mesh=rank_mesh((1, 2), 0), device="cpu")
    assert model.seq_split(4).axes == ("model",)
    assert lm.init_params(seq, device="cpu", tp=2)["embed"].shape == (
        seq.vocab_size, seq.d_model)
    k = model.init_cache(4, 16)["stages"][0][0]["mixer"]["k"]
    assert k.shape == (seq.num_layers, 4, 8, seq.num_kv_heads, seq.head_dim)
    whole = lm.LM(seq, mesh=rank_mesh((2, 1), 0), device="cpu")
    assert whole.seq_split(4) is None
    assert whole.init_cache(4, 16)["stages"][0][0]["mixer"]["k"].shape[
        1:3] == (2, 16)
    model = lm.LM(_llama(), mesh=rank_mesh((2, 2), 3), device="cpu")
    tmpl = model.cache_template(1, 16)
    assert tmpl["length"].spec == Spec(None)
    cache = model.init_cache(1, 16)
    assert cache["length"].shape == (1,)
    assert cache["stages"][0][0]["mixer"]["k"].shape[1:4] == (1, 8, 1)
    assert model.seq_split(1).axes == ("data",)
    with pytest.raises(ValueError, match="batch of 3.*data axis of 2"):
        model.init_cache(3, 16)
    one = lm.LM(_llama(), mesh=rank_mesh((1, 2), 1), device="cpu")
    assert one.init_cache(1, 16)["length"].shape == (1,)
    assert one.seq_split(1) is None


def test_batch_must_divide_over_data():
    """A batch that does not split over the data axis raises, naming both
    sizes; one that does gives each rank its lanes."""
    model = lm.LM(_llama(), mesh=rank_mesh((2, 1), 1), device="cpu")
    with pytest.raises(ValueError, match="batch of 3.*data axis of 2"):
        model.init_cache(3, 16)
    cache = model.init_cache(6, 16)
    assert cache["length"].shape == (3,)
    assert cache["stages"][0][0]["mixer"]["k"].shape[1] == 3
