"""The training path of the port (``repro_torch.train``, ``LM.train_loss``,
``launch/train.py``) on the CPU, against ``repro``'s.

The first tests mirror ``tests/test_train_serve.py:30-130`` through the
port.  The rest hold the port against the reference on the same inputs
(made from a seed with numpy, or the reference's own weights carried across
by ``params_from_reference``):

* ``SyntheticLM`` batches (text, vision, audio) and the ``Prefetcher``'s
  replay, bit for bit;
* ``lr_schedule`` over a range of steps within 1e-7, ``zero1_spec`` equal
  to ``PartitionSpec``'s entries, and ``adamw_update`` on a random tree
  within 1e-6 (the same float32 expressions in the same order; ``pow`` and
  ``sqrt`` may round one ulp apart);
* ``LM.train_loss`` and every leaf's gradient against ``jax.value_and_grad``
  of the reference's ``train_loss`` for the reduced llama3.2-1b and
  rwkv6-1.6b: float32 1e-5 for the loss and 1e-4 for the gradients (both
  sides compute in float32 from identical weights, sums in another order;
  measured 5e-7 and 9e-7), bf16 5e-2 (``tests/test_torch_models.py:40``:
  the fused entry does not round the normalized rows to bf16 before the
  product; measured 2e-4 and 3e-3);
* three ``make_train_step`` steps against the reference's jitted step, with
  and without ``microbatch=4``, in float32: loss and gnorm within 1e-5
  relative each step, the first and second moments within 1e-4 of each
  leaf's largest value and the parameters within 2e-5 (Adam divides each
  gradient by its own scale, so the sums' order shows through it; measured
  1.0e-5, 5e-6);
* checkpoints across the packages, leaf for leaf and bit for bit.

Module-scoped fixtures build each reference model and jit once.
"""

import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as P

from repro import train as r_train
from repro.configs import TrainConfig as RTrainConfig
from repro.configs import get_config as r_get_config
from repro.models import lm as r_lm
from repro.train import optimizer as r_opt
from repro_torch import train
from repro_torch.configs import TrainConfig, get_config
from repro_torch.models import common, lm
from repro_torch.train import optimizer, step as t_step

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama3.2-1b", "rwkv6-1.6b"]
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (5e-2, 5e-2)}  # loss, grads


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("llama3.2-1b", reduced=True)
    model = lm.LM(cfg, device="cpu")
    return cfg, model, model.init(0)


def _batch(cfg, seq=32, batch=4, step=0, seed=1):
    return train.SyntheticLM(cfg.vocab_size, seq, batch,
                             seed=seed).global_batch_at(step)


def _leaves(tree):
    return [t for _, t in common.sorted_leaves(tree)]


def _np(a) -> np.ndarray:
    """A reference array as float32 numpy (bf16 widened exactly)."""
    return np.asarray(jax.device_get(a)).astype(np.float32)


# ------------------------------------ tests/test_train_serve.py, ported
def test_train_step_decreases_loss_on_learnable_data(tiny):
    cfg, model, params = tiny
    tcfg = TrainConfig(total_steps=40, warmup_steps=4, learning_rate=2e-3)
    state = train.init_state(params)
    step = train.make_train_step(model, tcfg)
    toks = np.ones((4, 32), np.int32) * 7  # learnable: a constant sequence
    batch = {"tokens": toks, "labels": toks}
    first = None
    for _ in range(25):
        state, m = step(state, batch)
        first = first if first is not None else float(m["loss"])
    assert float(m["loss"]) < first * 0.5  # memorizes a constant stream


def test_grad_accum_matches_full_batch(tiny):
    cfg, model, params = tiny
    batch = _batch(cfg, 32, 8, seed=0)
    t0 = TrainConfig(microbatch=0, learning_rate=1e-3)
    t1 = TrainConfig(microbatch=4, learning_rate=1e-3)
    s0, m0 = train.make_train_step(model, t0)(train.init_state(params), batch)
    s1, m1 = train.make_train_step(model, t1)(train.init_state(params), batch)
    np.testing.assert_allclose(float(m0["loss"]), float(m1["loss"]),
                               rtol=5e-2)
    # parameters move in the same direction at comparable magnitude
    p = _leaves(params)[0].float()
    d0 = _leaves(s0.params)[0].float() - p
    d1 = _leaves(s1.params)[0].float() - p
    cos = float((d0 * d1).sum() / (d0.norm() * d1.norm()))
    assert cos > 0.9


def test_checkpoint_restart_is_bitexact(tiny, tmp_path):
    cfg, model, params = tiny
    step = train.make_train_step(model, TrainConfig(total_steps=20,
                                                    warmup_steps=2))
    state = train.init_state(params)
    for i in range(3):
        state, _ = step(state, _batch(cfg, step=i, seed=0))
    train.save(str(tmp_path), int(state.step), state.tree())
    state_a = state
    for i in (3, 4):
        state_a, m_a = step(state_a, _batch(cfg, step=i, seed=0))
    t = train.restore(str(tmp_path), state.tree())
    state_b = dataclasses.replace(train.init_state(params),
                                  params=t["params"], m=t["m"], v=t["v"],
                                  step=t["step"])
    for i in (3, 4):
        state_b, m_b = step(state_b, _batch(cfg, step=i, seed=0))
    assert torch.equal(m_a["loss"], m_b["loss"])
    for a, b in zip(_leaves(state_a.tree()), _leaves(state_b.tree())):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_retention_and_latest(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(4.0)}
    for s in (1, 2, 3, 4, 5):
        train.save(d, s, tree, retain=2)
    assert train.latest_step(d) == 5
    kept = [x for x in os.listdir(d) if x.startswith("step_")]
    assert len(kept) == 2
    assert train.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        train.restore(str(tmp_path / "none"), tree)


@settings(deadline=None, max_examples=20)
@given(st.integers(1, 64), st.integers(1, 1024))
def test_lr_schedule_bounds(warm, total):
    tcfg = TrainConfig(warmup_steps=warm, total_steps=max(total, warm + 1),
                       learning_rate=1e-3)
    for s in [0, warm, total // 2, total]:
        lr = float(train.lr_schedule(tcfg, torch.tensor(s, dtype=torch.int32)))
        assert 0.0 <= lr <= 1e-3 + 1e-9


@settings(deadline=None, max_examples=30)
@given(st.sampled_from([(16, 2048), (8, 64, 64), (2048,), (3, 5)]),
       st.integers(2, 16))
def test_zero1_spec_validity(shape, data):
    spec = train.zero1_spec((), shape, data)
    for ax, dim in zip(spec, shape):
        if ax == "data":
            assert dim % data == 0


def test_data_pipeline_deterministic_replay():
    src = train.SyntheticLM(1000, 16, 4, seed=3)
    a = src.global_batch_at(7)
    b = src.global_batch_at(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    p1 = train.Prefetcher(src)
    p1.seek(5)
    first = p1.get()
    np.testing.assert_array_equal(first["tokens"],
                                  src.global_batch_at(5)["tokens"])


# ----------------------------------------------------- against the reference
@pytest.mark.parametrize("frontend", [None, "vision", "audio"])
def test_synthetic_batches_equal_reference(frontend):
    kw = dict(seed=5, frontend=frontend, d_model=24, aux_len=6)
    r = r_train.SyntheticLM(777, 19, 3, **kw)
    t = train.SyntheticLM(777, 19, 3, **kw)
    for s in (0, 1, 1000, 2**20 + 3):
        rb, tb = r.global_batch_at(s), t.global_batch_at(s)
        assert rb.keys() == tb.keys()
        for k in rb:
            assert rb[k].dtype == tb[k].dtype and rb[k].shape == tb[k].shape
            np.testing.assert_array_equal(rb[k], tb[k])


def test_prefetcher_replays_as_the_reference():
    r = r_train.Prefetcher(r_train.SyntheticLM(500, 8, 2, seed=2), depth=3)
    t = train.Prefetcher(train.SyntheticLM(500, 8, 2, seed=2), depth=3)
    for p in (r, t):
        p.seek(4)
    for _ in range(5):
        rb, tb = r.get(), t.get()
        np.testing.assert_array_equal(rb["labels"], tb["labels"])
    assert (r.stats.produced, r.next_step) == (t.stats.produced, t.next_step)


@pytest.mark.parametrize("warm,total,lr", [(1, 10, 1e-3), (4, 40, 2e-3),
                                           (100, 1000, 3e-4), (7, 8, 0.5)])
def test_lr_schedule_matches_reference(warm, total, lr):
    kw = dict(warmup_steps=warm, total_steps=total, learning_rate=lr)
    rc, tc = RTrainConfig(**kw), TrainConfig(**kw)
    steps = np.arange(0, total + 5, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: r_opt.lr_schedule(rc, s))(steps))
    got = train.lr_schedule(tc, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=1e-7 * lr)


@pytest.mark.parametrize("spec,shape,data", [
    ((), (16, 2048), 4), ((None, "model"), (8, 64, 64), 8),
    (("model",), (2048,), 16), ((), (3, 5), 2), ((None,), (6, 4), 4),
    (("data",), (8, 8), 2)])
def test_zero1_spec_matches_reference(spec, shape, data):
    assert train.zero1_spec(spec, shape, data) == \
        tuple(r_opt.zero1_spec(P(*spec), shape, data))


def _random_tree(rng):
    """A small parameter-like tree of float32 numpy leaves."""
    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"embed": f(11, 6), "stages": [{"w": f(2, 6, 5), "n": f(2, 6)}],
            "final_norm": f(6)}


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(7)
    params = _random_tree(rng)
    tcfg = dict(warmup_steps=2, total_steps=10, learning_rate=1e-2,
                grad_clip=0.5)
    rs = r_opt.init_state(jax.tree.map(jnp.asarray, params))
    ts = optimizer.init_state(common.tree_map(torch.from_numpy, params))
    for _ in range(3):
        grads = _random_tree(rng)
        rs = r_opt.adamw_update(RTrainConfig(**tcfg), rs,
                                jax.tree.map(jnp.asarray, grads))
        ts = optimizer.adamw_update(TrainConfig(**tcfg), ts, common.tree_map(
            torch.from_numpy, grads))
    assert int(rs.step) == int(ts.step) == 3 and ts.step.dtype == torch.int32
    for name in ("params", "m", "v"):
        for r, t in zip(jax.tree.leaves(getattr(rs, name)),
                        _leaves(getattr(ts, name))):
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-6)


@pytest.fixture(scope="module")
def pairs():
    """(arch, dtype) -> the reference's model, weights and jitted
    value_and_grad, and the port's model and the same weights."""
    out = {}

    def get(arch, dtype):
        if (arch, dtype) not in out:
            rc = dataclasses.replace(r_get_config(arch, reduced=True),
                                     dtype=dtype)
            tc = dataclasses.replace(get_config(arch, reduced=True),
                                     dtype=dtype)
            rm = r_lm.LM(rc)
            rp = rm.init(0)
            if dtype == "float32":  # weights and gradients in float32
                rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
            vg = jax.jit(jax.value_and_grad(
                lambda p, b: rm.train_loss(p, b, remat=True), has_aux=True))
            tm = lm.LM(tc, device="cpu")
            tp = lm.params_from_reference(jax.device_get(rp), device="cpu")
            out[arch, dtype] = (rm, rp, vg, tm, tp)
        return out[arch, dtype]
    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(pairs, arch, dtype):
    _, rp, vg, tm, tp = pairs(arch, dtype)
    b = _batch(tm.cfg)
    (r_loss, r_met), r_grads = vg(rp, {k: jnp.asarray(v)
                                       for k, v in b.items()})
    loss, grads = t_step.value_and_grad(t_step.make_loss_fn(tm), tp,
                                        {k: torch.as_tensor(v)
                                         for k, v in b.items()})
    loss_tol, grad_tol = TOL[dtype]
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=loss_tol,
                               atol=loss_tol)
    _, t_met = tm.train_loss(tp, {k: torch.as_tensor(v)
                                  for k, v in b.items()})
    assert float(t_met["aux"]) == float(r_met["aux"]) == 0.0
    r_leaves = jax.tree.leaves(r_grads)
    t_leaves = _leaves(grads)
    assert len(r_leaves) == len(t_leaves)
    for (path, t), r in zip(common.sorted_leaves(grads), r_leaves):
        assert t.dtype == (torch.float32 if dtype == "float32"
                           else torch.bfloat16) or path[-1] in ("w0", "u")
        np.testing.assert_allclose(t.float().numpy(), _np(r), rtol=grad_tol,
                                   atol=grad_tol, err_msg=str(path))


@pytest.mark.parametrize("microbatch", [0, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(pairs, arch, microbatch):
    rm, rp, _, tm, tp = pairs(arch, "float32")
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20,
              microbatch=microbatch)
    r_fn = jax.jit(r_train.make_train_step(rm, RTrainConfig(**kw)))
    t_fn = train.make_train_step(tm, TrainConfig(**kw))
    rs, ts = r_train.init_state(rp), train.init_state(tp)
    for i in range(3):
        b = _batch(tm.cfg, 32, 8, step=i)
        rs, r_m = r_fn(rs, {k: jnp.asarray(v) for k, v in b.items()})
        ts, t_m = t_fn(ts, b)
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(float(t_m[k]), float(r_m[k]),
                                       rtol=1e-5)
        assert int(t_m["step"]) == int(r_m["step"]) == i + 1
    for name in ("m", "v"):
        for r, t in zip(jax.tree.leaves(getattr(rs, name)),
                        _leaves(getattr(ts, name))):
            r = _np(r)
            assert float(np.abs(t.numpy() - r).max()) <= \
                1e-4 * float(np.abs(r).max())
    for r, t in zip(jax.tree.leaves(rs.params), _leaves(ts.params)):
        np.testing.assert_allclose(t.numpy(), _np(r), rtol=0, atol=2e-5)


def test_remat_on_and_off_give_equal_grads(pairs):
    for arch in ARCHS:
        _, _, _, tm, tp = pairs(arch, "float32")
        b = {k: torch.as_tensor(v) for k, v in _batch(tm.cfg).items()}
        got = {}
        for remat in (True, False):
            got[remat] = t_step.value_and_grad(
                lambda p, bb: tm.train_loss(p, bb, remat=remat), tp, b)
        assert torch.equal(got[True][0], got[False][0])
        for a, c in zip(_leaves(got[True][1]), _leaves(got[False][1])):
            assert torch.equal(a, c)


def test_ce_chunks_as_the_reference(pairs):
    """``_ce`` takes chunks of 512 positions where they divide S, else one
    chunk, as the reference's scan; the loss agrees either way."""
    rm, rp, _, tm, tp = pairs("llama3.2-1b", "float32")
    rng = np.random.default_rng(9)
    for S in (1024, 600):
        h = rng.standard_normal((1, S, tm.cfg.d_model)).astype(np.float32)
        lab = rng.integers(0, tm.cfg.vocab_size, (1, S)).astype(np.int32)
        want = float(rm._ce(rp, jnp.asarray(h), jnp.asarray(lab)))
        got = float(tm._ce(tp, torch.from_numpy(h), torch.from_numpy(lab)))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_checkpoints_cross_the_packages(pairs, tmp_path):
    """A checkpoint ``repro`` saves restores in the port, and one the port
    saves restores in ``repro``, leaf for leaf and bit for bit (bf16
    weights, float32 moments, the int32 step)."""
    rm, rp, _, tm, tp = pairs("llama3.2-1b", "bfloat16")
    b = _batch(tm.cfg)
    tcfg = dict(total_steps=20, warmup_steps=2)
    rs, _ = jax.jit(r_train.make_train_step(rm, RTrainConfig(**tcfg)))(
        r_train.init_state(rp), {k: jnp.asarray(v) for k, v in b.items()})
    ts, _ = train.make_train_step(tm, TrainConfig(**tcfg))(
        train.init_state(tp), b)
    r_dir, t_dir = str(tmp_path / "repro"), str(tmp_path / "port")
    r_train.save(r_dir, int(rs.step), rs.tree())
    train.save(t_dir, int(ts.step), ts.tree())
    # the reference's checkpoint in the port
    got = train.restore(r_dir, ts.tree())
    for (path, t), r in zip(common.sorted_leaves(got),
                            jax.tree.leaves(rs.tree())):
        r = np.asarray(jax.device_get(r))
        assert str(t.dtype).split(".")[1] == r.dtype.name, path
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          r.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), r)
    # the port's checkpoint in the reference
    got = r_train.restore(t_dir, rs.tree())
    for r, t in zip(jax.tree.leaves(got), _leaves(ts.tree())):
        r = np.asarray(jax.device_get(r))
        assert r.dtype.name == str(t.dtype).split(".")[1]
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(r.view(np.int16),
                                          t.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(r, t.numpy())
    assert train.latest_step(r_dir) == r_train.latest_step(t_dir) == 1


def test_int8_grad_compression_needs_a_mesh_of_ranks(tiny):
    """Ported behaviour: the int8 pod exchange (held to the reference in
    ``test_torch_train_mesh.py``) runs over a ``launch.mesh.Mesh`` of
    ranks, and a mesh-like object with a second pod, which has no
    collectives, is refused."""
    _, model, _ = tiny
    tcfg = TrainConfig(grad_compression="int8")
    pods = types.SimpleNamespace(shape={"pod": 2, "data": 1, "model": 1})
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        train.make_train_step(model, tcfg, mesh=pods)
    # one pod (or no mesh) takes the plain step, as in the reference
    train.make_train_step(model, tcfg)
    train.make_train_step(model, tcfg, mesh=types.SimpleNamespace(
        shape={"pod": 1, "data": 1, "model": 1}))


def test_every_family_loss_term_runs(tiny):
    """Ported behaviour: a vlm's patches branch (only the text positions
    carry loss), deepseek's MTP term, jamba's mamba scan and MoE aux loss
    and whisper's encoder over frames give finite losses, checked against
    the reference in ``tests/test_torch_models.py``."""
    cfg, model, params = tiny
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    vcfg = dataclasses.replace(cfg, family="vlm", vision_tokens=4)
    vis = lm.LM(vcfg, device="cpu")
    vb = dict(b, patches=torch.randn(4, 4, cfg.d_model))
    loss, _ = vis.train_loss(vis.init(0), vb)
    assert torch.isfinite(loss)
    ds = lm.LM(get_config("deepseek-v3-671b", reduced=True), device="cpu")
    dp = ds.init(0)
    h = torch.randn(4, 32, ds.cfg.d_model).to(torch.bfloat16)
    assert torch.isfinite(ds._mtp_loss(dp, h, b["labels"]))
    jamba = lm.LM(get_config("jamba-v0.1-52b", reduced=True), device="cpu")
    loss, met = jamba.train_loss(jamba.init(0), b)
    assert torch.isfinite(loss) and float(met["aux"]) > 0
    wcfg = get_config("whisper-large-v3", reduced=True)
    whisper = lm.LM(wcfg, device="cpu")
    wb = dict(b, frames=torch.randn(4, wcfg.encoder_seq, wcfg.d_model))
    loss, _ = whisper.train_loss(whisper.init(0), wb)
    assert torch.isfinite(loss)


def test_launcher_trains_checkpoints_and_resumes_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch
    args = ["--arch", "rwkv6-1.6b", "--seq", "32", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path)]
    launch.main(args + ["--steps", "2"])
    assert train.latest_step(str(tmp_path)) == 2
    launch.main(args + ["--steps", "3", "--resume"])
    out = capsys.readouterr().out
    assert "step    1  loss" in out and "resumed from step 2" in out
    assert train.latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-large-v3"])
def test_launcher_trains_the_hybrid_and_encdec_families_on_cpu(arch, capsys):
    """The launcher's defaults (128 positions, 4 rows; whisper's audio
    frontend gives its frames, moved to the device with the batch)."""
    from repro_torch.launch import train as launch
    launch.main(["--arch", arch, "--steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step    1  loss" in out and out.strip().endswith("done")


def test_train_lm_torch_example_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
         "--steps", "4", "--d-model", "32", "--seq", "16", "--batch", "2",
         "--device", "cpu"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        capture_output=True, text=True, timeout=300, check=True)
    assert "restarting from checkpoint 2" in out.stdout
    assert "done at step 4" in out.stdout
