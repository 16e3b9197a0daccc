"""Tensor parallelism of the port (``LM`` over a ``launch/mesh.py`` mesh)
against ``repro``'s ``LM(cfg, mesh=Mesh(devices (1, 2), ("data",
"model")))``, a mesh of GSPMD-auto axes.

One module fixture writes seeded float32 weights (the port's template at
tp = 2, drawn by ``init_params`` on the CPU) and inputs for five reduced
cases, then runs at once the reference in one subprocess over 4 host
devices (jitted, the weights placed by ``shardings_for(mesh,
model.pspecs())``) and the port in one spawned gloo world of two CPU ranks
(``tests/_torch_tp_rank.py``, which takes each rank's shards through
``launch.mesh.shard_params``).  The cases:

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
of the unsharded one), while its loss and logits are the function's.  In process: the padded model equals the unpadded one, the
spmd bins hold exactly the whole binning's lanes, and the mixers whose
sharded program is not ported refuse tp = 2.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import sorted_leaves

from _torch_tp_rank import case_config, counts, path_key, start_world

ROOT = Path(__file__).resolve().parents[1]
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

REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch.mesh import shardings_for
    from repro.models.lm import LM
    data = np.load(sys.argv[1])
    out = {}

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    for case in json.loads(str(data["cases"])):
        name = case["name"]
        cfg = dataclasses.replace(get_config(case["arch"], reduced=True),
                                  dtype="float32", **case.get("replace", {}))
        if "moe" in case:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **case["moe"]))
        # Auto axes (GSPMD), as the reference's LM is written for;
        # jax.make_mesh now makes Explicit ones
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(
            case["mesh"]), ("data", "model"))
        model = LM(cfg, mesh=mesh)
        flat, tdef = jax.tree_util.tree_flatten_with_path(model.abstract())
        params = jax.tree_util.tree_unflatten(tdef, [
            jnp.asarray(data[name + "/w/" + key(p)]) for p, _ in flat])
        params = jax.device_put(params, shardings_for(mesh, model.pspecs()))
        toks = jnp.asarray(data[name + "/tokens"])
        batch = {"tokens": toks, "labels": jnp.asarray(data[name + "/labels"])}
        out[name + "/prefill"] = jax.jit(model.prefill)(params,
                                                         {"tokens": toks})
        cache = model.init_cache(toks.shape[0], int(data["max_seq"]))
        step = jax.jit(model.decode_step)
        for i in range(int(data["decode_steps"])):
            logits, cache = step(params, toks[:, i:i + 1], cache)
            out[name + "/decode" + str(i)] = logits
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: model.train_loss(p, b, remat=True),
            has_aux=True))(params, batch)
        out[name + "/loss"] = loss
        if cfg.moe is not None:
            # moe_spmd's shard_map does not sum the cotangents of its
            # model-replicated inputs (router, x) over model: its
            # gradients are not the function's; take the unsharded ones
            whole = LM(cfg)
            params = jax.device_get(params)
            (_, _), grads = jax.jit(jax.value_and_grad(
                lambda p, b: whole.train_loss(p, b, remat=True),
                has_aux=True))(params, batch)
        for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            out[name + "/g/" + key(p)] = g
    np.savez(sys.argv[2], **{k: np.asarray(v, np.float32)
                             for k, v in out.items()})
    print("REF_OK")
""")


def _weights(cfg, seed: int) -> dict:
    """The case's whole float32 weights at tp = 2 (padded heads too)."""
    params = lm.init_params(cfg, seed, device="cpu", dtype=torch.float32,
                            tp=2)
    return {path_key(p): t.numpy() for p, t in sorted_leaves(params)}


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """The five cases once through the reference (one subprocess) and the
    port (one world of two gloo ranks), at once.  -> (ref, [rank 0, rank
    1]) of loaded ``.npz`` outputs."""
    root = tmp_path_factory.mktemp("tp")
    arrays = dict(cases=np.asarray(json.dumps(CASES)), max_seq=32,
                  decode_steps=3)
    rng = np.random.default_rng(5)
    for i, case in enumerate(CASES):
        for k, v in _weights(case_config(case), i).items():
            arrays[f"{case['name']}/w/{k}"] = v
        for f in ("tokens", "labels"):
            arrays[f"{case['name']}/{f}"] = rng.integers(
                0, 512, (B, S)).astype(np.int32)
    cases = root / "cases.npz"
    np.savez(cases, **arrays)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT, str(cases),
                            str(root / "ref.npz")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        procs = start_world("tp", cases, root, 2, env)
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
        out, err = ref.communicate(timeout=300)
        assert "REF_OK" in out, err[-3000:]
    finally:
        ref.kill()
    return (dict(np.load(root / "ref.npz")),
            [dict(np.load(root / f"tp_rank{r}.npz")) for r in range(2)])


def _close(got, want, what: str) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=what)


def _rank_mesh(shape, rank: int):
    """A mesh's arithmetic for one rank, without a world."""
    return mesh_mod.Mesh(("data", "model"), dict(zip(("data", "model"),
                                                     shape)),
                         rank, torch.device("cpu"), {}, "gloo", "send_recv")


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
        mesh = _rank_mesh(case["mesh"], r)
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
    the logits, for the prefill and each decode step; nothing else."""
    ref, ranks = tp_runs
    cfg = case_config(CASES[NAMES.index(name)])
    split_attn = lm._tp(lm.q_heads(cfg, 2), 2)
    per_call = 1 + cfg.num_layers * (1 + int(split_attn))
    for out in ranks:
        stats = counts(out[f"{name}/stats_serve"])
        assert set(stats) == {"all_gather/model/float32",
                              "psum/model/float32"}, stats
        assert stats["all_gather/model/float32"] == {
            "calls": 4, "bytes": 4 * B * (cfg.vocab_size // 2) * 4}
        assert stats["psum/model/float32"]["calls"] == 4 * per_call


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


@pytest.mark.parametrize("arch,mixer", [
    ("deepseek-v3-671b", "mla"), ("jamba-v0.1-52b", "mamba"),
    ("rwkv6-1.6b", "rwkv"), ("whisper-large-v3", "gqa_cross")])
def test_unported_mixers_refuse_tp(arch, mixer):
    cfg = get_config(arch, reduced=True)
    for make in (lambda: lm.LM(cfg, tp=2, device="cpu"),
                 lambda: lm.init_params(cfg, device="cpu", tp=2)):
        with pytest.raises(NotImplementedError,
                           match=f"'{mixer}' mixer.*item 18c"):
            make()
