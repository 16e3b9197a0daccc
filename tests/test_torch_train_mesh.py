"""The port's sharded training (``train/step.py`` and ``train/optimizer.py``
over a ``launch/mesh.py`` mesh) against ``repro``'s ``make_train_step(...,
mesh=mesh)``.

One module fixture writes the cases, then runs at once the reference in
one subprocess over 4 host devices and the port in one spawned gloo world
of two CPU ranks (``tests/_torch_tp_rank.py``):

* ``exchange``: ``_int8_pod_exchange`` on each pod's seeded gradients and
  residuals, the reference's called inside a fully manual ``shard_map``
  over a ``("pod",)`` mesh of 2 devices; the port's over a ``(2, 1, 1)``
  mesh.  The sum and the new residual agree bit for bit (so do the int8
  values and scales: both are functions of them);
* ``zero``: two steps of the reduced llama3.2-1b over a ``(2, 1)`` mesh
  with ZeRO-1 (each rank updates its half of every ``m``, ``v`` and
  parameter, then gathers);
* ``pod``: two steps over ``(2, 1, 1)`` with the int8 pod exchange, the
  reference's over ``Mesh((2, 1, 1), ("pod", "data", "model"))`` of
  GSPMD-auto axes with a mesh-less model, as its own test builds it;
* ``gather``: ``shard_params`` then ``gather_params`` over ``(1, 2)``.
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

from repro_torch.models import lm
from repro_torch.models.common import sorted_leaves
from repro_torch.train import optimizer as opt

from _torch_tp_rank import case_config, counts, path_key, start_world

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
LR = 1e-3
# ef's equality: the two packages' gradients differ in their last bits
# (each sums in its own order), and so does g - q * scale
EF_TOL = 1e-6
B, S = 4, 16
LEAVES = {"a": (37, 5), "b": (64,), "c": (3, 4, 8)}
CASES = [
    dict(name="exchange", arch="llama3.2-1b", mesh=[2, 1, 1],
         axes=["pod", "data", "model"], exchange=list(LEAVES)),
    dict(name="zero", arch="llama3.2-1b", mesh=[2, 1],
         axes=["data", "model"]),
    dict(name="pod", arch="llama3.2-1b", mesh=[2, 1, 1],
         axes=["pod", "data", "model"], tcfg={"grad_compression": "int8"}),
    dict(name="gather", arch="llama3.2-1b", mesh=[1, 2],
         axes=["data", "model"], gather=True),
]

REF_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.configs import TrainConfig, get_config
    from repro.launch.mesh import shardings_for
    from repro.models.lm import LM
    from repro.train import init_state, make_train_step, state_pspecs
    from repro.train.step import _int8_pod_exchange
    data = np.load(sys.argv[1])
    out = {}

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    def mesh_of(case):
        n = int(np.prod(case["mesh"]))
        return Mesh(np.asarray(jax.devices()[:n]).reshape(case["mesh"]),
                    tuple(case["axes"]))

    for case in json.loads(str(data["cases"])):
        name = case["name"]
        if case.get("gather"):
            continue
        if case.get("exchange"):
            mesh = Mesh(np.asarray(jax.devices()[:2]), ("pod",))
            g = {k: jnp.stack([jnp.asarray(data[f"{name}/g{p}/{k}"])
                               for p in range(2)]) for k in case["exchange"]}
            e = {k: jnp.stack([jnp.asarray(data[f"{name}/e{p}/{k}"])
                               for p in range(2)]) for k in case["exchange"]}

            def body(g, e):
                sq = lambda t: jax.tree.map(lambda x: x[0], t)
                total, new_e = _int8_pod_exchange(sq(g), sq(e), 2)
                ex = lambda t: jax.tree.map(lambda x: x[None], t)
                return ex(total), ex(new_e)

            fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("pod"),
                                                              P("pod")),
                                   out_specs=(P("pod"), P("pod"))))
            total, new_e = fn(g, e)
            for k in case["exchange"]:
                for p in range(2):
                    out[f"{name}/total{p}/{k}"] = total[k][p]
                    out[f"{name}/new_e{p}/{k}"] = new_e[k][p]
            continue
        cfg = dataclasses.replace(get_config(case["arch"], reduced=True),
                                  dtype="float32")
        mesh = mesh_of(case)
        pod = "pod" in case["axes"]
        model = LM(cfg, mesh=None if pod else mesh)
        flat, tdef = jax.tree_util.tree_flatten_with_path(model.abstract())
        params = jax.tree_util.tree_unflatten(tdef, [
            jnp.asarray(data[name + "/w/" + key(p)]) for p, _ in flat])
        tcfg = TrainConfig(learning_rate=1e-3, **case.get("tcfg", {}))
        comp = tcfg.grad_compression == "int8"
        state = init_state(params, compression=comp)
        if not pod:
            specs = state_pspecs(model.pspecs(), model.abstract(),
                                 data_size=mesh.shape["data"], zero1=True)
            sh = shardings_for(mesh, specs.tree())
            state = dataclasses.replace(
                state, params=jax.device_put(state.params, sh["params"]),
                m=jax.device_put(state.m, sh["m"]),
                v=jax.device_put(state.v, sh["v"]))
        with mesh:
            step = jax.jit(make_train_step(model, tcfg,
                                           mesh=mesh if pod else None))
            for i in range(2):
                batch = {f: jnp.asarray(data[f"{name}/{f}{i}"])
                         for f in ("tokens", "labels")}
                state, met = step(state, batch)
                out[f"{name}/loss{i}"] = met["loss"]
        for part in ("params", "m", "v", "ef"):
            tree = state.tree().get(part)
            if tree is None:
                continue
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
                out[f"{name}/{part}/" + key(p)] = x
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
    print("REF_OK")
""")


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """The cases once through the reference and the port, at once ->
    (cases, ref, [rank 0, rank 1])."""
    root = tmp_path_factory.mktemp("train_mesh")
    arrays = dict(cases=np.asarray(json.dumps(CASES)))
    rng = np.random.default_rng(9)
    for case in CASES:
        name = case["name"]
        if case.get("exchange"):
            for p in range(2):
                for k, shape in LEAVES.items():
                    g = rng.standard_normal(shape).astype(np.float32)
                    e = (rng.standard_normal(shape) * 1e-2).astype(
                        np.float32)
                    if k == "c":  # a scale of exactly 1: ties of the round
                        e[:] = 0
                        g.flat[:6] = [127.0, 0.5, -0.5, 1.5, 2.5, -126.5]
                    arrays[f"{name}/g{p}/{k}"] = g
                    arrays[f"{name}/e{p}/{k}"] = e
            continue
        cfg = case_config(case)
        params = lm.init_params(cfg, 1, device="cpu", dtype=torch.float32)
        for p, t in sorted_leaves(params):
            arrays[f"{name}/w/{path_key(p)}"] = t.numpy()
        for i in range(2):
            for f in ("tokens", "labels"):
                arrays[f"{name}/{f}{i}"] = rng.integers(
                    0, cfg.vocab_size, (B, S)).astype(np.int32)
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
        procs = start_world("train", cases, root, 2, env)
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
        out, err = ref.communicate(timeout=300)
        assert "REF_OK" in out, err[-3000:]
    finally:
        ref.kill()
    return (dict(np.load(cases)), dict(np.load(root / "ref.npz")),
            [dict(np.load(root / f"train_rank{r}.npz")) for r in range(2)])


def _rank_mesh(case, rank: int):
    from repro_torch.launch import mesh as mesh_mod
    return mesh_mod.Mesh(case["axes"], dict(zip(case["axes"], case["mesh"])),
                         rank, torch.device("cpu"), {}, "gloo", "send_recv")


def _exchange_op_by_op(cases, leaf: str, pod: int):
    """The reference's expressions for one pod, in numpy float32, each op
    rounded as written -> (total, new_e)."""
    g = [cases[f"exchange/g{p}/{leaf}"] + cases[f"exchange/e{p}/{leaf}"]
         for p in range(2)]
    sc = [np.maximum(np.abs(x).max() / np.float32(127.0), np.float32(1e-12))
          for x in g]
    q = [np.clip(np.round(x / s), -127, 127).astype(np.int8).astype(
        np.float32) for x, s in zip(g, sc)]
    total = q[pod] * sc[pod] + q[1 - pod] * sc[1 - pod]
    return total / np.float32(2), g[pod] - q[pod] * sc[pod], g[pod]


@pytest.mark.mesh
@pytest.mark.parametrize("leaf", list(LEAVES))
def test_int8_pod_exchange_bit_for_bit(train_runs, leaf):
    """The port's sum and new residual equal the reference's expressions
    evaluated op by op bit for bit (q and the scale too: the sum and the
    residual are made of them); the reference's jitted function differs
    only where XLA's CPU backend contracts ``g - q * scale`` and ``total +
    q_peer * s_peer`` into fused multiply-adds, which round the product
    once: within two ulps of the leaf's largest ``|g + e|``.  Only the
    int8 values and one float32 scale a leaf cross the pod axis."""
    cases, ref, ranks = train_runs
    for p, out in enumerate(ranks):
        total, new_e, g = _exchange_op_by_op(cases, leaf, p)
        fma_ulps = 2 * np.spacing(np.abs(g).max())
        for f, want in (("total", total), ("new_e", new_e)):
            got = out[f"exchange/{f}/{leaf}"]
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32),
                                          err_msg=f"pod {p} {f}")
            np.testing.assert_allclose(got, ref[f"exchange/{f}{p}/{leaf}"],
                                       rtol=0, atol=fma_ulps,
                                       err_msg=f"pod {p} {f}")
    stats = counts(ranks[0]["exchange/stats"])
    n = sum(int(np.prod(s)) for s in LEAVES.values())
    assert stats == {
        "ppermute/pod/int8": {"calls": len(LEAVES), "bytes": n},
        "ppermute/pod/float32": {"calls": len(LEAVES),
                                 "bytes": 4 * len(LEAVES)}}


def _state_leaves(out, name: str, part: str) -> dict:
    pre = f"{name}/{part}/"
    return {k[len(pre):]: v for k, v in out.items() if k.startswith(pre)}


@pytest.mark.mesh
def test_zero1_steps_match_reference(train_runs):
    """Two ZeRO-1 steps over (2, 1): the loss, the parameters (equal on
    both ranks, gathered after the update) within 1e-5, and each rank's
    ``m`` / ``v`` slices those of the reference's whole moments."""
    cases, ref, ranks = train_runs
    case = CASES[1]
    cfg = case_config(case)
    specs = dict((path_key(p), s) for p, s in
                 sorted_leaves(lm.param_pspecs(cfg, 1)))
    for r, out in enumerate(ranks):
        for i in range(2):
            np.testing.assert_allclose(out[f"zero/loss{i}"],
                                       ref[f"zero/loss{i}"], rtol=TOL,
                                       atol=TOL)
        got = _state_leaves(out, "zero", "params")
        want = _state_leaves(ref, "zero", "params")
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
            np.testing.assert_array_equal(got[k],
                                          ranks[0][f"zero/params/{k}"])
        mesh = _rank_mesh(case, r)
        n_sliced = 0
        for part in ("m", "v"):
            for k, x in _state_leaves(out, "zero", part).items():
                w = want_full = ref[f"zero/{part}/{k}"]
                d = opt.zero_dim(specs[k], want_full.shape, 2)
                if d is not None:
                    n_sliced += 1
                    w = opt.zero_slice(torch.from_numpy(want_full), d, mesh,
                                       ("data",)).numpy()
                assert x.shape == w.shape, k
                np.testing.assert_allclose(x, w, rtol=TOL, atol=TOL,
                                           err_msg=f"{part} {k}")
        assert n_sliced > 0
    stats = counts(ranks[0]["zero/stats"])
    assert set(stats) == {"psum/data/float32", "all_gather/data/float32"}


@pytest.mark.mesh
def test_int8_pod_steps_match_reference(train_runs):
    """Two steps over (2, 1, 1) with the int8 exchange: the loss within
    1e-5; the parameters within 1e-5 and ``ef`` within ``EF_TOL`` (1e-6,
    against residuals near 1e-4), each on at least 99.9% of the elements, and elsewhere within two Adam steps and one
    quantization step: the reference's fused multiply-adds (see the test
    above) round some ``g / scale`` the other way; ``ef`` nonzero; only
    int8 values (and each leaf's float32 scale, and the loss's mean)
    crossed the pod axis.  The reference returns its state with ``out_specs
    P()`` over the pods, so the ``ef`` it returns (and feeds both pods in
    its next step) is pod 0's; the port keeps each pod's own, and only
    pod 0's is compared."""
    cases, ref, ranks = train_runs
    cfg = case_config(CASES[2])
    n_params = sum(int(np.prod(lf.shape)) for _, lf in
                   sorted_leaves(lm.param_template(cfg)))
    n_leaves = len(sorted_leaves(lm.param_template(cfg)))
    for out in ranks:
        for i in range(2):
            np.testing.assert_allclose(out[f"pod/loss{i}"],
                                       ref[f"pod/loss{i}"], rtol=TOL,
                                       atol=TOL)
        close = total = 0
        for k, x in _state_leaves(out, "pod", "params").items():
            d = np.abs(x - ref[f"pod/params/{k}"])
            close += int((d <= TOL).sum())
            total += x.size
            # an element whose int8 value rounds the other way moves by
            # Adam's normalized step, which is at most about lr a step
            assert d.max() <= 2 * 2 * LR, k
        assert close >= 0.999 * total, (close, total)
        if out is not ranks[0]:  # the reference's ef is pod 0's (below)
            continue
        same = total = 0
        for k, e in _state_leaves(out, "pod", "ef").items():
            w = ref[f"pod/ef/{k}"]
            same += int((np.abs(e - w) <= EF_TOL).sum())
            total += e.size
            # |ef| <= scale / 2: one step is twice the largest residual
            step = 2 * max(np.abs(w).max(), np.abs(e).max())
            assert np.abs(e - w).max() <= step * (1 + 1e-3), k
        assert same >= 0.999 * total, (same, total)
        assert any(np.abs(e).max() > 0 for e in
                   _state_leaves(out, "pod", "ef").values())
        stats = counts(out["pod/stats"])
        assert stats == {
            "ppermute/pod/int8": {"calls": 2 * n_leaves,
                                  "bytes": 2 * n_params},
            "ppermute/pod/float32": {"calls": 2 * n_leaves,
                                     "bytes": 2 * 4 * n_leaves},
            "psum/pod/float32": {"calls": 2, "bytes": 2 * 4}}, stats


@pytest.mark.mesh
def test_shard_then_gather_params_is_the_tree(train_runs):
    cases, _, ranks = train_runs
    for out in ranks:
        got = _state_leaves(out, "gather", "params")
        assert got
        for k, x in got.items():
            want = cases[f"gather/w/{k}"]
            assert x.dtype == want.dtype
            np.testing.assert_array_equal(x, want, err_msg=k)
