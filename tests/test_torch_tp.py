"""Tensor parallelism of the port (``LM`` over a ``launch/mesh.py`` mesh)
against ``repro``'s ``LM(cfg, mesh=Mesh(devices (1, 2), ("data",
"model")))``, a mesh of GSPMD-auto axes.

One module fixture writes seeded float32 weights (the port's template at
tp = 2, drawn by ``init_params`` on the CPU) and inputs for five reduced
cases, then runs at once the reference in one subprocess over 4 host
devices (jitted, the weights placed by ``shardings_for(mesh,
model.pspecs())``) and the port in one spawned gloo world of two CPU ranks
(``tests/_torch_tp_rank.py``'s ``run_cases``, whose ranks take their
shards through ``launch.mesh.shard_params``).  The cases:

* llama3.2-1b: q and kv heads split, the MLP split, vocab-parallel
  embedding, logits and cross entropy;
* qwen2.5-14b with ``pad_attn_heads`` (5 q heads padded to 6, split; its
  one kv head and ``bq`` replicated) and without (attention replicated);
* mixtral through ``moe_spmd`` (2 of 4 experts a rank, at a capacity
  factor of 0.5 so that picks drop), and with one shared expert (its
  partial sum folded into the one psum).

Prefill logits, three decode steps, ``train_loss`` and every leaf's
gradient (each rank's shard against the reference's slice) agree within
``TOL``.  For the MoE cases the gradients are the reference's without a
mesh: its ``moe_spmd`` under a mesh does not sum the cotangents of its
``model``-replicated inputs (the router's gradient comes out at 0.48x
of the unsharded one), while its loss and logits are the function's.  In process: the padded model equals the unpadded one, and
the spmd bins hold exactly the whole binning's lanes.  The other mixers
at tp = 2 (mla, mamba, rwkv, whisper's cross-attention and encoder),
``moe_gather_decode`` and a data axis in serving are held to the
reference in ``test_torch_tp_families.py`` and
``test_torch_tp_serving.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import sorted_leaves

from _torch_tp_rank import case_config, counts, path_key, rank_mesh, \
    run_cases

TOL = 1e-5
B, S = 2, 16
CASES = [
    dict(name="llama", arch="llama3.2-1b", mesh=[1, 2]),
    dict(name="qwen_pad", arch="qwen2.5-14b", mesh=[1, 2],
         replace={"pad_attn_heads": True}),
    dict(name="qwen", arch="qwen2.5-14b", mesh=[1, 2]),
    dict(name="mixtral", arch="mixtral-8x22b", mesh=[1, 2],
         moe={"capacity_factor": 0.5}),
    dict(name="mixtral_shared", arch="mixtral-8x22b", mesh=[1, 2],
         moe={"num_shared": 1}),
]
NAMES = [c["name"] for c in CASES]


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """The five cases once through the reference (one subprocess) and the
    port (one world of two gloo ranks), at once.  -> (ref, [rank 0, rank
    1]) of loaded ``.npz`` outputs."""
    return run_cases(tmp_path_factory.mktemp("tp"), CASES, 2, batch=B,
                     seq=S)


def _close(got, want, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_tp_prefill_and_decode_vs_reference(tp_runs, name):
    """Every rank's prefill logits (the whole vocabulary: its columns
    gathered in rank order) and three decode steps equal the
    reference's."""
    ref, ranks = tp_runs
    for r, out in enumerate(ranks):
        for f in ["prefill"] + [f"decode{i}" for i in range(3)]:
            _close(out[f"{name}/{f}"], ref[f"{name}/{f}"], f"rank {r} {f}")


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_tp_loss_and_sharded_grads_vs_reference(tp_runs, name):
    """``train_loss`` on every rank, and each rank's gradient of each of
    its shards against that slice of the reference's gradient."""
    ref, ranks = tp_runs
    case = CASES[NAMES.index(name)]
    cfg = case_config(case)
    specs = dict((path_key(p), s) for p, s in
                 sorted_leaves(lm.param_pspecs(cfg, 2)))
    for r, out in enumerate(ranks):
        _close(out[f"{name}/loss"], ref[f"{name}/loss"], f"rank {r} loss")
        mesh = rank_mesh(case["mesh"], r)
        n = 0
        for k, spec in specs.items():
            want = ref[f"{name}/g/{k}"]
            want = want[mesh_mod.local_index(want.shape, spec, mesh)]
            got = out[f"{name}/g/{k}"]
            assert got.shape == want.shape, k
            _close(got, want, f"rank {r} grad {k}")
            n += 1
        assert n == len([k for k in ref if k.startswith(f"{name}/g/")])


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_tp_collectives_counted(tp_runs, name):
    """What crossed the ``model`` axis in serving: one psum a layer for
    each split mixer and ffn plus the embedding's, and one all_gather of
    the logits, for the prefill and each decode step; and where the decode
    cache splits ``head_dim`` (qwen2.5-14b's one kv head), for each layer
    of each decode step one psum of the partial scores, one all_gather of
    the outputs' columns (B x heads x head_dim / 2) and, where the q heads
    split, one of the new token's q; nothing else."""
    ref, ranks = tp_runs
    cfg = case_config(CASES[NAMES.index(name)])
    split_attn = lm._tp(lm.q_heads(cfg, 2), 2)
    per_call = 1 + cfg.num_layers * (1 + int(split_attn))
    hd_split = lm.gqa_cache_split(cfg, 2, False) == "head_dim"
    assert hd_split == name.startswith("qwen")
    heads, n = lm.q_heads(cfg, 2), 3 * cfg.num_layers * hd_split
    gathers = {"calls": 4 + n * (1 + split_attn),
               "bytes": 4 * B * (cfg.vocab_size // 2) * 4
               + n * B * heads * cfg.head_dim // 2 * 4
               + n * split_attn * B * heads // 2 * cfg.head_dim * 4}
    for out in ranks:
        stats = counts(out[f"{name}/stats_serve"])
        assert set(stats) == {"all_gather/model/float32",
                              "psum/model/float32"}, stats
        assert stats["all_gather/model/float32"] == gathers
        assert stats["psum/model/float32"]["calls"] == 4 * per_call + n


def test_padded_model_equals_unpadded():
    """A model with ``pad_attn_heads`` at tp = 2 run whole (no mesh) gives
    the unpadded model's logits, decode steps and loss when its real heads
    carry the same weights: the padded heads contribute zero in train,
    prefill and decode."""
    base = dataclasses.replace(get_config("qwen2.5-14b", reduced=True),
                               dtype="float32")
    pad = dataclasses.replace(base, pad_attn_heads=True)
    H = base.num_heads
    pp = lm.init_params(pad, 3, device="cpu", dtype=torch.float32, tp=2)
    up = lm.init_params(base, 4, device="cpu", dtype=torch.float32)
    for li, layer in enumerate(up["stages"][0]):
        mp = pp["stages"][0][li]["mixer"]
        for k, v in layer["mixer"].items():
            if k in ("wq", "bq", "wo"):
                axis = {"wq": 2, "bq": 1, "wo": 1}[k]
                mp[k].narrow(axis, 0, H).copy_(v)
            else:
                mp[k].copy_(v)
        pp["stages"][0][li]["ffn"] = layer["ffn"]
    for k in ("embed", "final_norm", "lm_head"):
        pp[k] = up[k]
    m_pad = lm.LM(pad, tp=2, device="cpu")
    m_up = lm.LM(base, device="cpu")
    assert pp["stages"][0][0]["mixer"]["wq"].shape[2] == 6
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 512, (2, 8)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks.roll(1, 1)}
    with torch.no_grad():
        np.testing.assert_allclose(m_pad.prefill(pp, batch),
                                   m_up.prefill(up, batch), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(m_pad.train_loss(pp, batch)[0],
                                   m_up.train_loss(up, batch)[0], rtol=1e-6,
                                   atol=1e-6)
        c_pad, c_up = m_pad.init_cache(2, 16), m_up.init_cache(2, 16)
        for i in range(3):
            l_pad, c_pad = m_pad.decode_step(pp, toks[:, i:i + 1], c_pad)
            l_up, c_up = m_up.decode_step(up, toks[:, i:i + 1], c_up)
            np.testing.assert_allclose(l_pad, l_up, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tp", [2, 4])
def test_spmd_bins_hold_the_whole_binnings_lanes(tp):
    """Each ``model`` rank's bins (``moe.spmd_bins``) are exactly the
    lanes that the whole binning (``moe.bins``, held to the reference's in
    ``test_torch_moe.py``) gives its experts, the same picks dropped."""
    E, k, T, C = 8, 2, 64, 12
    idx = torch.from_numpy(np.random.default_rng(tp).integers(
        0, E, (T, k)))
    idx = torch.where(idx[:, 1:] == idx[:, :1],
                      torch.stack([idx[:, 0], (idx[:, 0] + 1) % E], 1), idx)
    lane_tok, dest = moe_mod.bins(idx, E, C)
    e_loc = E // tp
    dropped = dest == E * C
    assert dropped.any()
    for m in range(tp):
        lt, de = moe_mod.spmd_bins(idx, E, e_loc, m, C)
        lo, hi = m * e_loc * C, (m + 1) * e_loc * C
        torch.testing.assert_close(lt, lane_tok[lo:hi], rtol=0, atol=0)
        mine = (dest >= lo) & (dest < hi)
        torch.testing.assert_close(de[mine], dest[mine] - lo, rtol=0,
                                   atol=0)
        assert (de[~mine] == e_loc * C).all()
