"""The port's in-place train step (``make_train_step(..., inplace=True)``,
``adamw_update(..., inplace=True)``), the counterpart of the reference's
``jax.jit(step, donate_argnums=0)``, on the CPU.

* three in-place steps equal three functional steps bit for bit (loss,
  gnorm, step and every leaf of params, ``m`` and ``v``), from equal
  states, for the plain step and ``microbatch=2``, each with a bf16 and a
  float32 reduced llama3.2-1b; the step hands back the state it was given,
  and every leaf keeps its storage (``data_ptr``);
* the same over a mesh, in one spawned world of two gloo ranks
  (``tests/_torch_tp_rank.py``): ZeRO-1 at ``(2, 1)`` (each rank's slices
  of ``m`` and ``v``, the parameters gathered whole into their own
  tensors) and the int8 pod exchange at ``(2, 1, 1)`` (``ef`` written in
  place too);
* the in-place step against the reference's jitted step with its state
  donated, three steps from the same float32 weights (carried across by
  ``lm.params_from_reference``), within the tolerance of
  ``tests/test_torch_train.py::test_train_steps_match_reference``;
* ``adamw_update(..., inplace=True)`` on a random tree of bf16 and
  float32 leaves equal to the functional update bit for bit;
* ``launch/train.py --device cpu --resume`` restoring into the state's own
  tensors (``checkpoint.restore_into``) replays a run bit for bit, and
  ``restore_into`` refuses a tree of another shape.
"""

import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import train as r_train
from repro.configs import TrainConfig as RTrainConfig
from repro.configs import get_config as r_get_config
from repro.models import lm as r_lm
from repro_torch import train
from repro_torch.configs import TrainConfig, get_config
from repro_torch.models import common, lm
from repro_torch.train import checkpoint, optimizer

from _torch_tp_rank import case_config, path_key, start_world

ROOT = Path(__file__).resolve().parents[1]
STEPS = 3
TCFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)


def _leaves(tree):
    return [t for _, t in common.sorted_leaves(tree)]


def _ptrs(state) -> list:
    return [t.data_ptr() for t in _leaves(state.tree())]


def _equal(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _states(cfg, dtype):
    """Two equal fresh states of ``cfg``'s weights from seed 0."""
    params = lm.init_params(cfg, 0, device="cpu", dtype=dtype)
    return (train.init_state(params),
            train.init_state(common.tree_map(torch.clone, params)))


@pytest.mark.parametrize("microbatch", [0, 2])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_inplace_step_equals_functional_bit_for_bit(dtype, microbatch):
    cfg = dataclasses.replace(get_config("llama3.2-1b", reduced=True),
                              dtype=dtype)
    model = lm.LM(cfg, device="cpu")
    tcfg = TrainConfig(microbatch=microbatch, **TCFG)
    fstate, istate = _states(cfg, getattr(torch, dtype))
    held, ptrs = istate, _ptrs(istate)
    fstep = train.make_train_step(model, tcfg)
    istep = train.make_train_step(model, tcfg, inplace=True)
    src = train.SyntheticLM(cfg.vocab_size, 32, 4, seed=3)
    for i in range(STEPS):
        batch = src.global_batch_at(i)
        fstate, fm = fstep(fstate, batch)
        istate, im = istep(istate, batch)
        assert istate is held
        for k in ("loss", "gnorm", "step"):
            assert _equal(fm[k], im[k]), k
    assert int(istate.step) == STEPS
    for a, b in zip(_leaves(fstate.tree()), _leaves(istate.tree())):
        assert _equal(a, b)
    assert _ptrs(istate) == ptrs


def test_functional_step_leaves_its_input_untouched():
    cfg = get_config("llama3.2-1b", reduced=True)
    model = lm.LM(cfg, device="cpu")
    state, _ = _states(cfg, torch.bfloat16)
    before = [t.clone() for t in _leaves(state.tree())]
    new, _ = train.make_train_step(model, TrainConfig(**TCFG))(
        state, train.SyntheticLM(cfg.vocab_size, 32, 4).global_batch_at(0))
    assert new is not state
    assert all(_equal(a, b) for a, b in zip(before, _leaves(state.tree())))
    assert not all(_equal(a, b) for a, b in zip(
        _leaves(state.params), _leaves(new.params)))


def test_adamw_update_in_place_equals_functional():
    """A random tree of bf16 and float32 leaves (of other sizes, visited
    smallest first, not in the tree's order), a nonzero starting state and
    a clipped gradient."""
    rng = np.random.default_rng(4)

    def draw(shape, dtype=torch.float32, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(dtype)

    def tree(fn):
        return {"a": fn((37, 5)), "b": fn((300,)),
                "c": {"d": fn((3, 4, 8)), "e": fn((1,))}}

    params = tree(lambda s: draw(s, torch.bfloat16))
    params["b"] = params["b"].float()
    grads = common.tree_map(lambda p: draw(tuple(p.shape), p.dtype, 30.0),
                            params)
    m, v = tree(draw), tree(lambda s: draw(s).abs())
    cfg = TrainConfig(**TCFG)

    def state():
        return optimizer.TrainState(
            common.tree_map(torch.clone, params), common.tree_map(
                torch.clone, m), common.tree_map(torch.clone, v),
            torch.tensor(3, dtype=torch.int32))

    f = optimizer.adamw_update(cfg, state(), grads)
    s = state()
    ptrs = _ptrs(s)
    i = optimizer.adamw_update(cfg, s, dict(grads), inplace=True)
    assert i is s and _ptrs(s) == ptrs and int(s.step) == 4
    assert float(optimizer.global_norm(grads)) > cfg.grad_clip
    for a, b in zip(_leaves(f.tree()), _leaves(i.tree())):
        assert _equal(a, b)


# ---------------------------------------------------------- over a mesh
CASES = [
    dict(name="zero", arch="llama3.2-1b", mesh=[2, 1],
         axes=["data", "model"], inplace=True, steps=STEPS),
    dict(name="pod", arch="llama3.2-1b", mesh=[2, 1, 1],
         axes=["pod", "data", "model"], tcfg={"grad_compression": "int8"},
         inplace=True, steps=STEPS),
]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The cases once through a world of two gloo ranks -> [rank 0's
    outputs, rank 1's]."""
    root = tmp_path_factory.mktemp("train_inplace")
    arrays = dict(cases=np.asarray(json.dumps(CASES)))
    rng = np.random.default_rng(11)
    for case in CASES:
        cfg = case_config(case)
        params = lm.init_params(cfg, 2, device="cpu", dtype=torch.float32)
        for p, t in common.sorted_leaves(params):
            arrays[f"{case['name']}/w/{path_key(p)}"] = t.numpy()
        for i in range(STEPS):
            for f in ("tokens", "labels"):
                arrays[f"{case['name']}/{f}{i}"] = rng.integers(
                    0, cfg.vocab_size, (4, 16)).astype(np.int32)
    cases = root / "cases.npz"
    np.savez(cases, **arrays)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    procs = start_world("train", cases, root, 2, env)
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            p.kill()
    return [dict(np.load(root / f"train_rank{r}.npz")) for r in range(2)]


@pytest.mark.mesh
@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_inplace_mesh_step_equals_functional_bit_for_bit(mesh_runs, name):
    """Each rank's in-place state after three steps equals its functional
    state bit for bit: the gathered parameters, its ZeRO-1 slices of ``m``
    and ``v`` (and, over pods, ``ef``), the step; so do the losses and
    gnorms; the step handed back the state it was given, every leaf in
    its own storage."""
    for out in mesh_runs:
        assert bool(out[f"{name}/inplace/same_object"])
        assert bool(out[f"{name}/inplace/storage_kept"])
        for i in range(STEPS):
            for k in ("loss", "gnorm"):
                np.testing.assert_array_equal(out[f"{name}/inplace/{k}{i}"],
                                              out[f"{name}/{k}{i}"])
        assert int(out[f"{name}/inplace/step"]) == int(out[f"{name}/step"]) \
            == STEPS
        parts = ("params", "m", "v") + (("ef",) if name == "pod" else ())
        n = 0
        for part in parts:
            pre = f"{name}/{part}/"
            for k in (k for k in out if k.startswith(pre)):
                got = out[f"{name}/inplace/{part}/{k[len(pre):]}"]
                assert got.dtype == out[k].dtype
                np.testing.assert_array_equal(got, out[k], err_msg=k)
                n += 1
        assert n > 0
    if name == "pod":
        assert any(np.abs(v).max() > 0 for k, v in mesh_runs[0].items()
                   if k.startswith("pod/inplace/ef/"))


# ------------------------------------------------ against the reference
@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-1.6b"])
def test_inplace_steps_match_donated_reference(arch):
    rc = dataclasses.replace(r_get_config(arch, reduced=True),
                             dtype="float32")
    rm = r_lm.LM(rc)
    rp = jax.tree.map(lambda a: a.astype(jnp.float32), rm.init(0))
    tm = lm.LM(dataclasses.replace(get_config(arch, reduced=True),
                                   dtype="float32"), device="cpu")
    ts = train.init_state(lm.params_from_reference(jax.device_get(rp),
                                                   device="cpu"))
    held = ts
    r_fn = jax.jit(r_train.make_train_step(rm, RTrainConfig(**TCFG)),
                   donate_argnums=0)
    t_fn = train.make_train_step(tm, TrainConfig(**TCFG), inplace=True)
    rs = r_train.init_state(rp)
    for i in range(STEPS):
        b = train.SyntheticLM(tm.cfg.vocab_size, 32, 8,
                              seed=1).global_batch_at(i)
        rs, r_m = r_fn(rs, {k: jnp.asarray(v) for k, v in b.items()})
        ts, t_m = t_fn(ts, b)
        for k in ("loss", "gnorm"):
            np.testing.assert_allclose(float(t_m[k]), float(r_m[k]),
                                       rtol=1e-5)
        assert int(t_m["step"]) == int(r_m["step"]) == i + 1
    assert ts is held
    for name in ("m", "v"):
        for r, t in zip(jax.tree.leaves(getattr(rs, name)),
                        _leaves(getattr(ts, name))):
            r = np.asarray(r, np.float32)
            assert float(np.abs(t.numpy() - r).max()) <= \
                1e-4 * float(np.abs(r).max())
    for r, t in zip(jax.tree.leaves(rs.params), _leaves(ts.params)):
        np.testing.assert_allclose(t.numpy(), np.asarray(r, np.float32),
                                   rtol=0, atol=2e-5)


# ------------------------------------------------------------ restarts
def test_launcher_resume_into_the_state_replays_bit_for_bit(tmp_path):
    """Four steps straight against two steps, a checkpoint, and a
    ``--resume`` to four: the two final checkpoints are equal leaf for
    leaf, bit for bit."""
    from repro_torch.launch import train as launch
    args = ["--arch", "llama3.2-1b", "--seq", "32", "--device", "cpu"]
    straight, resumed = str(tmp_path / "a"), str(tmp_path / "b")
    launch.main(args + ["--steps", "4", "--checkpoint-dir", straight])
    launch.main(args + ["--steps", "2", "--checkpoint-dir", resumed])
    launch.main(args + ["--steps", "4", "--checkpoint-dir", resumed,
                        "--resume"])
    assert train.latest_step(straight) == train.latest_step(resumed) == 4
    a, b = (Path(d) / "step_00000004" for d in (straight, resumed))
    names = sorted(p.name for p in a.glob("leaf_*.npy"))
    assert names == sorted(p.name for p in b.glob("leaf_*.npy"))
    for n in names:
        x, y = np.load(a / n), np.load(b / n)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.atleast_1d(x).view(np.uint8),
                                      np.atleast_1d(y).view(np.uint8),
                                      err_msg=n)


def test_restore_into_writes_the_tree_and_refuses_another(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3).to(torch.bfloat16),
            "b": torch.tensor(7, dtype=torch.int32)}
    checkpoint.save(str(tmp_path), 5, tree)
    into = {"a": torch.zeros(2, 3, dtype=torch.bfloat16),
            "b": torch.tensor(0, dtype=torch.int32)}
    ptrs = [t.data_ptr() for t in _leaves(into)]
    assert checkpoint.restore_into(str(tmp_path), into) == 5
    assert all(_equal(into[k], tree[k]) for k in tree)
    assert ptrs == [t.data_ptr() for t in _leaves(into)]
    with pytest.raises(ValueError, match="leaf"):
        checkpoint.restore_into(str(tmp_path), {
            "a": torch.zeros(3, 2, dtype=torch.bfloat16), "b": into["b"]})
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore_into(str(tmp_path), {"a": into["a"]})
