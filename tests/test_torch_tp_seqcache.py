"""The sequence splits of the decode cache against ``repro``'s ``LM(cfg,
mesh=...)`` over GSPMD-auto axes, which partitions the same specs:

* ``cache_seq_shard`` at tp = 2, the cache's sequence over ``model``:
  llama3.2-1b (gqa, its 4 lanes at lengths whose last leaves rank 1 no
  live position) and deepseek-v3-671b (mla) at ``(1, 2)``;
* a batch-1 cache over a data axis of 2 (``long_500k``'s shape), the
  sequence over ``data``: mixtral-8x22b (a rolling window of 32 slots,
  decoding across its wrap and so from rank 1's slots to rank 0's),
  jamba-v0.1-52b and rwkv6-1.6b (whose states are replicated over data)
  at ``(2, 1)``, llama3.2-1b at ``(2, 2)`` (four ranks: its heads over
  ``model`` too) and over a ``(2, 1, 1)`` pod mesh, the sequence over
  ``("pod", "data")``.

One module fixture writes seeded float32 weights, a seeded whole cache
(every leaf, and ``length``) and tokens for each case, then runs at once
the reference in one subprocess over 4 host devices (its cache placed by
its own ``cache_template`` specs) and the port in a world of two gloo
ranks and one of four (``tests/_torch_tp_rank.py seq``: each rank takes
its slice of the cache under the port's specs).  Each rank's logits of
every decode step equal the reference's rows within 1e-5; the steps cross
the ranks' chunk boundary (and a range with no live position is the
usual case early on).  The split leaves' specs are the reference's, their
local shapes the chunk, and each step adds the collectives of the design:
one ``all_gather`` of the flash partials a gqa or mla layer over the split
axes, and, where the sequence splits over ``model`` and the mixer's heads
do too, one ``all_gather`` of the new token's heads.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.models.common import sorted_leaves

from _torch_tp_checks import close, serve_calls
from _torch_tp_rank import ROOT, case_config, counts, path_key, start_world

STEPS = 4
MAX_SEQ = 32
TWO = [
    dict(name="llama_seqshard", arch="llama3.2-1b", mesh=[1, 2],
         replace={"cache_seq_shard": True}, lengths=[14, 3, 27, 0]),
    dict(name="deepseek_seqshard", arch="deepseek-v3-671b", mesh=[1, 2],
         replace={"cache_seq_shard": True}, lengths=[14, 5]),
    dict(name="mixtral_long", arch="mixtral-8x22b", mesh=[2, 1],
         lengths=[62]),
    dict(name="jamba_long", arch="jamba-v0.1-52b", mesh=[2, 1],
         lengths=[14]),
    dict(name="rwkv_long", arch="rwkv6-1.6b", mesh=[2, 1], lengths=[14]),
    dict(name="llama_long_pod", arch="llama3.2-1b", mesh=[2, 1, 1],
         axes=list(mesh_mod.AXES_3D), lengths=[14]),
]
FOUR = [dict(name="llama_long_tp", arch="llama3.2-1b", mesh=[2, 2],
             lengths=[14])]
CASES = TWO + FOUR
for _c in CASES:
    _c["max_seq"] = MAX_SEQ
NAMES = [c["name"] for c in CASES]
BY_NAME = dict(zip(NAMES, CASES))
SPLIT_LEAVES = ("k", "v", "c", "r")

# The reference's side: each case's LM over a mesh of GSPMD-auto axes, its
# weights and its seeded cache placed by shardings_for of its own specs,
# STEPS jitted decode steps; and its cache_template specs as JSON.
REF_SEQ_SCRIPT = textwrap.dedent("""
    import dataclasses, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.launch.mesh import shardings_for
    from repro.models.lm import LM, Leaf
    data = np.load(sys.argv[1])
    out = {}

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    def entry(e):
        return list(e) if isinstance(e, tuple) else e

    for case in json.loads(str(data["cases"])):
        name = case["name"]
        cfg = dataclasses.replace(get_config(case["arch"], reduced=True),
                                  dtype="float32", **case.get("replace", {}))
        n = int(np.prod(case["mesh"]))
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(
            case["mesh"]), tuple(case.get("axes", ("data", "model"))))
        model = LM(cfg, mesh=mesh)
        flat, tdef = jax.tree_util.tree_flatten_with_path(model.abstract())
        params = jax.tree_util.tree_unflatten(tdef, [
            jnp.asarray(data[name + "/w/" + key(p)]) for p, _ in flat])
        params = jax.device_put(params, shardings_for(mesh, model.pspecs()))
        toks = jnp.asarray(data[name + "/tokens"])
        tmpl = model.cache_template(toks.shape[0], case["max_seq"])
        is_leaf = lambda x: isinstance(x, Leaf)
        leaves, cdef = jax.tree_util.tree_flatten_with_path(tmpl,
                                                            is_leaf=is_leaf)
        out[name + "/specs"] = json.dumps({
            key(p): json.dumps([entry(e) for e in lf.spec])
            for p, lf in leaves})
        cache = jax.tree_util.tree_unflatten(cdef, [
            jnp.asarray(data[name + "/c/" + key(p)]) for p, _ in leaves])
        specs = jax.tree.map(lambda lf: lf.spec, tmpl, is_leaf=is_leaf)
        cache = jax.device_put(cache, shardings_for(mesh, specs))
        step = jax.jit(model.decode_step)
        for i in range(toks.shape[1]):
            logits, cache = step(params, toks[:, i:i + 1], cache)
            out[name + "/decode" + str(i)] = np.asarray(logits, np.float32)
    np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
    print("REF_OK")
""")


def _case_arrays(cases: list) -> dict:
    """Seeded float32 weights, a whole seeded cache (``length`` the case's
    lengths) and STEPS tokens a lane for each of ``cases``."""
    arrays = {}
    rng = np.random.default_rng(7)
    for i, case in enumerate(cases):
        cfg = case_config(case)
        name = case["name"]
        tp = case["mesh"][-1]
        params = lm.init_params(cfg, i, device="cpu", dtype=torch.float32,
                                tp=tp)
        for path, t in sorted_leaves(params):
            arrays[f"{name}/w/{path_key(path)}"] = t.numpy()
        batch = len(case["lengths"])
        tmpl = lm.LM(cfg, tp=tp, device="cpu").cache_template(
            batch, case["max_seq"])
        for path, lf in sorted_leaves(tmpl):
            arrays[f"{name}/c/{path_key(path)}"] = (
                np.asarray(case["lengths"], np.int32) if path == ("length",)
                else (0.5 * rng.standard_normal(lf.shape)).astype(np.float32))
        arrays[f"{name}/tokens"] = rng.integers(
            0, cfg.vocab_size, (batch, STEPS)).astype(np.int32)
    return arrays


def _write(path: Path, arrays: dict, cases: list) -> Path:
    """``cases`` and their arrays of ``arrays`` in one ``.npz``."""
    names = {c["name"] for c in cases}
    np.savez(path, cases=np.asarray(json.dumps(cases)),
             **{k: v for k, v in arrays.items() if k.split("/")[0] in names})
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """-> (the reference's outputs, {case name: [each rank's outputs]})."""
    root = tmp_path_factory.mktemp("seqcache")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    arrays = _case_arrays(CASES)
    every = _write(root / "cases.npz", arrays, CASES)
    worlds = {2: (root / "two", TWO), 4: (root / "four", FOUR)}
    files = {}
    for world, (sub, cases) in worlds.items():
        sub.mkdir()
        files[world] = _write(sub / "cases.npz", arrays, cases)
    ref = subprocess.Popen([sys.executable, "-c", REF_SEQ_SCRIPT, str(every),
                            str(root / "ref.npz")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    procs = {}
    try:
        for world, (sub, _) in worlds.items():
            procs[world] = start_world("seq", files[world], sub, world, env)
        for world, ps in procs.items():
            for p in ps:
                _, err = p.communicate(timeout=300)
                assert p.returncode == 0, err[-3000:]
        out, err = ref.communicate(timeout=300)
        assert "REF_OK" in out, err[-3000:]
    finally:
        ref.kill()
        for ps in procs.values():
            for p in ps:
                p.kill()
    ranks = {}
    for world, (sub, cases) in worlds.items():
        outs = [dict(np.load(sub / f"seq_rank{r}.npz")) for r in range(world)]
        ranks.update({c["name"]: outs for c in cases})
    return dict(np.load(root / "ref.npz")), ranks


def _data_rank(case: dict, r: int) -> int:
    """Rank ``r``'s index over the data axes (pod-major)."""
    return r // case["mesh"][-1]


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_seq_split_decode_vs_reference(runs, name):
    """Each rank's logits of every decode step equal the reference's rows:
    all of a batch-1 cache's on every rank; its rows over data else."""
    ref, ranks = runs
    case = BY_NAME[name]
    batch = len(case["lengths"])
    D = int(np.prod(case["mesh"][:-1]))
    for r, out in enumerate(ranks[name]):
        for i in range(STEPS):
            want = ref[f"{name}/decode{i}"]
            b = batch if batch == 1 else batch // D
            k = 0 if batch == 1 else _data_rank(case, r)
            close(out[f"{name}/decode{i}"], want[k * b:(k + 1) * b],
                  f"rank {r} step {i}")
        np.testing.assert_array_equal(
            out[f"{name}/length"],
            np.asarray(case["lengths"])[k * b:(k + 1) * b] + STEPS)


def _seq_axes(case: dict) -> tuple:
    """The axes of size above 1 that the case's cache sequence splits
    over."""
    axes = case.get("axes", list(mesh_mod.AXES_2D))
    shape = dict(zip(axes, case["mesh"]))
    over = (("pod", "data") if len(case["lengths"]) == 1 else ("model",))
    return tuple(a for a in axes if a in over and shape[a] > 1)


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_seq_split_specs_and_chunks(runs, name):
    """The split leaves' batch and sequence entries are the reference's
    (under ``cache_seq_shard`` the whole spec: no head axis), every other
    leaf's batch entry too; each rank holds a chunk of ``max_seq`` over
    the split axes' size."""
    ref, ranks = runs
    case = BY_NAME[name]
    want = json.loads(str(ref[f"{name}/specs"]))
    n = int(np.prod([dict(zip(case.get("axes", mesh_mod.AXES_2D),
                              case["mesh"]))[a] for a in _seq_axes(case)]))
    assert n == 2
    for out in ranks[name]:
        got = json.loads(str(out[f"{name}/specs"]))
        shapes = json.loads(str(out[f"{name}/local_shapes"]))
        assert sorted(got) == sorted(want)
        split = 0
        for path, spec in got.items():
            g, w = json.loads(spec), json.loads(want[path])
            leaf = path.split("/")[-1]
            if path == "length":
                assert g[:1] == w[:1], path
            elif path.split("/")[-2] == "mixer" and leaf in SPLIT_LEAVES:
                split += 1
                assert g[:3] == w[:3], (path, g, w)
                if w[2] == "model":
                    assert g == w, (path, g, w)
                assert shapes[path][2] == MAX_SEQ // n, (path, shapes[path])
            else:
                assert g[:2] == w[:2], (path, g, w)
        assert split > 0 or case["arch"] == "rwkv6-1.6b"


@pytest.mark.mesh
@pytest.mark.parametrize("name", NAMES)
def test_seq_split_collectives_counted(runs, name):
    """Each decode step's collectives: the tp program's over ``model``
    (``serve_calls``), plus one ``all_gather`` of (o, m, l) a gqa or mla
    layer over the split axes, plus one of the new token's heads over
    ``model`` where the sequence splits over ``model`` and the heads do
    too; the partials' gather moves the layer's float32 (B, heads, width +
    2)."""
    _, ranks = runs
    case = BY_NAME[name]
    cfg = case_config(case)
    M = case["mesh"][-1]
    want = {}
    if M > 1:
        for op, n in serve_calls(cfg, M, False).items():
            if n:
                want[(op, "model")] = STEPS * n
    axes = "+".join(_seq_axes(case))
    attn = [(mixer, repeat) for repeat, group in lm.make_program(cfg)
            for mixer, _ in group if mixer in ("gqa", "mla")]
    for mixer, repeat in attn:
        key = ("all_gather", axes)
        want[key] = want.get(key, 0) + STEPS * repeat
        if axes == "model" and lm._splits(mixer, cfg, M):
            want[key] += STEPS * repeat
    for out in ranks[name]:
        stats = counts(out[f"{name}/stats_serve"])
        got = {}
        for k, v in stats.items():
            op, ax, _ = k.split("/")
            got[(op, ax)] = got.get((op, ax), 0) + v["calls"]
        assert got == want, (stats, want)
