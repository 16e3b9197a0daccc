"""One rank of a CPU gloo world for ``tests/test_torch_tp.py``,
``tests/test_torch_tp_families.py``, ``tests/test_torch_tp_serving.py``,
``tests/test_torch_tp_seqcache.py``, ``tests/test_torch_tp_hdsplit.py`` and
``tests/test_torch_train_mesh.py``,
and the helpers those tests share.

    python tests/_torch_tp_rank.py MODE CASES INIT RANK WORLD OUT

``CASES`` is an ``.npz`` the test wrote: the cases as JSON and, for each,
the whole weights (``<case>/w/<path>``) and inputs; ``INIT`` the file of
a ``file://`` rendezvous; ``RANK`` this rank of ``WORLD``.  The rank
joins a gloo world and, for each case, builds the case's mesh
(``launch.mesh.make_mesh`` on the CPU), takes its shards of the weights
(``launch.mesh.shard_params``) and runs the port:

* ``tp``: prefill logits, three decode steps, ``train_loss`` and every
  leaf's gradient of the rank's shards, and the mesh's collective counts,
  all on the rank's rows of the batch (its share over ``data``; whisper's
  ``frames`` too); and whether ``gather_params`` of its shards gives the
  whole weights back bit for bit;
* ``seq``: decode steps from a seeded cache (``<case>/c/<path>``, whole,
  each rank taking its slice under the cache's specs) of ``<case>/tokens``
  (the whole batch's), each step's logits on the rank's rows, the mesh's
  collective counts of the steps, and the cache's specs as JSON;
* ``train``: two steps of ``train.make_train_step`` over the case's mesh
  from the rank's share of each global batch (its params gathered whole,
  its ZeRO-1 slices of ``m`` / ``v`` / ``ef``, the mesh's counts), and
  ``_int8_pod_exchange`` on the pod's gradients; a case with ``inplace``
  runs ``steps`` steps of the functional and of the in-place step from
  equal states and writes the in-place state too (under ``inplace/``),
  with whether it is the same object and every leaf kept its storage.

It writes its outputs to ``OUT`` and imports only torch, numpy and
``repro_torch``.  :data:`REF_SCRIPT` (the reference's side, a text run in a
subprocess over 4 host devices) and :func:`run_cases` serve the test files
that compare a world of ranks with ``repro``; :data:`REF_SEQ_SCRIPT` and
:func:`run_seq_worlds` those that decode from seeded whole caches.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.models.common import sorted_leaves, tree_from_sorted_leaves, \
    tree_map
from repro_torch.train import init_state, make_train_step
from repro_torch.train import step as t_step

MAX_SEQ = 32
DECODE_STEPS = 3
ROOT = Path(__file__).resolve().parents[1]


def case_config(case: dict):
    """The reduced config of a case, in float32, with its overrides."""
    cfg = dataclasses.replace(get_config(case["arch"], reduced=True),
                              dtype="float32", **case.get("replace", {}))
    if "moe" in case:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **case["moe"]))
    return cfg


def path_key(path) -> str:
    return "/".join(str(k) for k in path)


def counts(stats) -> dict:
    """A rank's ``Mesh.stats_json()`` (as saved) without the host
    seconds."""
    return {k: {f: v[f] for f in ("calls", "bytes")}
            for k, v in json.loads(str(stats)).items()}


def weights_of(data, name: str, template):
    """The case's whole weights (host arrays) in ``template``'s tree."""
    leaves = [data[f"{name}/w/{path_key(p)}"]
              for p, _ in sorted_leaves(template)]
    return tree_from_sorted_leaves(template, leaves)


def _tensor(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def run_tp(data, case: dict, rank: int, out: dict) -> None:
    name = case["name"]
    cfg = case_config(case)
    mesh = mesh_mod.make_mesh(case["mesh"], device="cpu")
    model = lm.LM(cfg, mesh=mesh)
    full = weights_of(data, name, lm.param_template(cfg, model.tp))
    params = mesh_mod.shard_params(full, model.pspecs(), mesh)
    back = mesh_mod.gather_params(params, model.pspecs(), mesh)
    out[f"{name}/round_trip"] = np.asarray(all(
        np.array_equal(b.numpy(), f) for (_, b), (_, f) in
        zip(sorted_leaves(back), sorted_leaves(full))))
    # the rank's rows of the batch: its share over the data axes
    n_batch = data[f"{name}/tokens"].shape[0]
    b = n_batch // mesh.axis_size(mesh_mod.BATCH_AXES)
    rows = slice(mesh.axis_index(mesh_mod.BATCH_AXES) * b,
                 (mesh.axis_index(mesh_mod.BATCH_AXES) + 1) * b)
    toks = _tensor(data[f"{name}/tokens"][rows])
    labels = _tensor(data[f"{name}/labels"][rows])
    inputs = {"tokens": toks}
    if f"{name}/frames" in data:
        inputs["frames"] = _tensor(data[f"{name}/frames"][rows])
    mesh.reset_stats()
    with torch.no_grad():
        out[f"{name}/prefill"] = model.prefill(params, inputs)
        cache = model.init_cache(n_batch, MAX_SEQ)
        for i in range(DECODE_STEPS):
            logits, cache = model.decode_step(params, toks[:, i:i + 1],
                                              cache)
            out[f"{name}/decode{i}"] = logits
    out[f"{name}/stats_serve"] = np.asarray(json.dumps(mesh.stats_json()))
    loss, grads = t_step.value_and_grad(
        t_step.make_loss_fn(model), params, dict(inputs, labels=labels))
    out[f"{name}/loss"] = loss
    for path, g in sorted_leaves(grads):
        out[f"{name}/g/{path_key(path)}"] = g
    out[f"{name}/stats"] = np.asarray(json.dumps(mesh.stats_json()))


def spec_json(spec) -> str:
    return json.dumps([list(e) if isinstance(e, tuple) else e
                       for e in spec])


def run_seq(data, case: dict, rank: int, out: dict) -> None:
    name = case["name"]
    cfg = case_config(case)
    mesh = mesh_mod.make_mesh(case["mesh"], case.get("axes", mesh_mod.AXES_2D),
                              device="cpu")
    model = lm.LM(cfg, mesh=mesh)
    full = weights_of(data, name, lm.param_template(cfg, model.tp))
    params = mesh_mod.shard_params(full, model.pspecs(), mesh)
    toks = data[f"{name}/tokens"]
    batch, max_seq = toks.shape[0], int(case["max_seq"])
    tmpl = model.cache_template(batch, max_seq)
    specs = mesh_mod.shardings_for(mesh, tree_map(lambda lf: lf.spec, tmpl))
    cache = model.init_cache(batch, max_seq)
    for (path, c), (_, spec) in zip(sorted_leaves(cache),
                                    sorted_leaves(specs)):
        whole = data[f"{name}/c/{path_key(path)}"]
        c.copy_(_tensor(whole[mesh_mod.local_index(whole.shape, spec,
                                                   mesh)]))
    out[f"{name}/specs"] = np.asarray(json.dumps(
        {path_key(p): spec_json(lf.spec) for p, lf in sorted_leaves(tmpl)}))
    out[f"{name}/local_shapes"] = np.asarray(json.dumps(
        {path_key(p): list(c.shape) for p, c in sorted_leaves(cache)}))
    # the rank's rows: all of a batch-1 cache's, else its share over data
    b = cache["length"].shape[0]
    k = 0 if batch == 1 else mesh.axis_index(mesh_mod.BATCH_AXES)
    rows = _tensor(toks[k * b:(k + 1) * b])
    mesh.reset_stats()
    with torch.no_grad():
        for i in range(rows.shape[1]):
            logits, cache = model.decode_step(params, rows[:, i:i + 1],
                                              cache)
            out[f"{name}/decode{i}"] = logits
    out[f"{name}/stats_serve"] = np.asarray(json.dumps(mesh.stats_json()))
    out[f"{name}/length"] = cache["length"]


def run_train(data, case: dict, rank: int, out: dict) -> None:
    name = case["name"]
    cfg = case_config(case)
    mesh = mesh_mod.make_mesh(case["mesh"], case["axes"], device="cpu")
    if case.get("exchange"):  # the pod exchange alone, on the pod's leaves
        g = {k: _tensor(data[f"{name}/g{mesh.axis_index('pod')}/{k}"])
             for k in case["exchange"]}
        e = {k: _tensor(data[f"{name}/e{mesh.axis_index('pod')}/{k}"])
             for k in case["exchange"]}
        total, new_e = t_step._int8_pod_exchange(g, e, 2, mesh)
        for k in case["exchange"]:
            out[f"{name}/total/{k}"] = total[k]
            out[f"{name}/new_e/{k}"] = new_e[k]
        out[f"{name}/stats"] = np.asarray(json.dumps(mesh.stats_json()))
        return
    model = lm.LM(cfg, mesh=mesh)
    if case.get("gather"):  # shard_params, then gather_params
        full = weights_of(data, name, lm.param_template(cfg, model.tp))
        specs = model.pspecs()
        back = mesh_mod.gather_params(
            mesh_mod.shard_params(full, specs, mesh), specs, mesh)
        for path, x in sorted_leaves(back):
            out[f"{name}/params/{path_key(path)}"] = x
        return
    tcfg = TrainConfig(learning_rate=1e-3, **case.get("tcfg", {}))
    full = weights_of(data, name, lm.param_template(cfg, model.tp))
    pspecs = model.pspecs()
    params = mesh_mod.shard_params(full, pspecs, mesh)
    state = init_state(params, compression=tcfg.grad_compression == "int8",
                       mesh=mesh, pspecs=pspecs, zero1=tcfg.zero1)
    step = make_train_step(model, tcfg)
    n = mesh.axis_size(("pod", "data"))
    k = mesh.axis_index(("pod", "data"))
    inplace = None
    if case.get("inplace"):
        inplace = init_state(mesh_mod.shard_params(full, pspecs, mesh),
                             compression=tcfg.grad_compression == "int8",
                             mesh=mesh, pspecs=pspecs, zero1=tcfg.zero1)
        held = inplace
        ptrs = [t.data_ptr() for _, t in sorted_leaves(inplace.tree())]
        istep = make_train_step(model, tcfg, inplace=True)
    mesh.reset_stats()
    for i in range(case.get("steps", 2)):
        batch = {f: data[f"{name}/{f}{i}"] for f in ("tokens", "labels")}
        b = batch["tokens"].shape[0] // n
        share = {f: _tensor(v[k * b:(k + 1) * b]) for f, v in batch.items()}
        state, met = step(state, share)
        out[f"{name}/loss{i}"] = met["loss"]
        if inplace is not None:
            inplace, imet = istep(inplace, share)
            out[f"{name}/inplace/loss{i}"] = imet["loss"]
            out[f"{name}/inplace/gnorm{i}"] = imet["gnorm"]
            out[f"{name}/gnorm{i}"] = met["gnorm"]
    if inplace is None:
        out[f"{name}/stats"] = np.asarray(json.dumps(mesh.stats_json()))
    else:
        out[f"{name}/inplace/same_object"] = np.asarray(inplace is held)
        out[f"{name}/inplace/storage_kept"] = np.asarray(ptrs == [
            t.data_ptr() for _, t in sorted_leaves(inplace.tree())])
    out[f"{name}/step"] = state.step
    if inplace is not None:
        out[f"{name}/inplace/step"] = inplace.step
    for part in ("params", "m", "v", "ef"):
        for pre, st in (("", state), ("inplace/", inplace)):
            tree = None if st is None else getattr(st, part)
            if tree is None:
                continue
            for path, x in sorted_leaves(tree):
                out[f"{name}/{pre}{part}/{path_key(path)}"] = x


# The reference's side of the tp cases: each case's LM over a mesh of
# GSPMD-auto axes (jax.make_mesh now makes Explicit ones, under which its LM
# fails), its weights placed by shardings_for(mesh, model.pspecs()); the
# prefill, three decode steps and the loss and gradients, jitted.  A case
# with a MoE takes the gradients of the unsharded model: the reference's
# moe_spmd under a mesh does not sum the cotangents of its model-replicated
# inputs (router, x) over model.
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
        n = int(np.prod(case["mesh"]))
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(
            case["mesh"]), ("data", "model"))
        model = LM(cfg, mesh=mesh)
        flat, tdef = jax.tree_util.tree_flatten_with_path(model.abstract())
        params = jax.tree_util.tree_unflatten(tdef, [
            jnp.asarray(data[name + "/w/" + key(p)]) for p, _ in flat])
        params = jax.device_put(params, shardings_for(mesh, model.pspecs()))
        toks = jnp.asarray(data[name + "/tokens"])
        inputs = {"tokens": toks}
        if name + "/frames" in data:
            inputs["frames"] = jnp.asarray(data[name + "/frames"])
        batch = dict(inputs, labels=jnp.asarray(data[name + "/labels"]))
        out[name + "/prefill"] = jax.jit(model.prefill)(params, inputs)
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


def seq_case_arrays(cases: list, steps: int) -> dict:
    """Seeded float32 weights, a whole seeded cache (``length`` the case's
    lengths) and ``steps`` tokens a lane for each of ``cases``."""
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
            0, cfg.vocab_size, (batch, steps)).astype(np.int32)
    return arrays


def _write_cases(path: Path, arrays: dict, cases: list) -> Path:
    """``cases`` and their arrays of ``arrays`` in one ``.npz``."""
    names = {c["name"] for c in cases}
    np.savez(path, cases=np.asarray(json.dumps(cases)),
             **{k: v for k, v in arrays.items() if k.split("/")[0] in names})
    return path


def run_seq_worlds(root, worlds: dict, steps: int) -> tuple:
    """``worlds`` (``{world size: cases}``) from seeded whole caches
    (:func:`seq_case_arrays`): every case through :data:`REF_SEQ_SCRIPT`
    in one subprocess and each world's cases through one world of gloo
    ranks in ``seq`` mode, all at once -> (the reference's outputs, {case
    name: [each rank's outputs]})."""
    root = Path(root)
    every_case = [c for cases in worlds.values() for c in cases]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    arrays = seq_case_arrays(every_case, steps)
    every = _write_cases(root / "cases.npz", arrays, every_case)
    worlds = {w: (root / f"world{w}", cases) for w, cases in worlds.items()}
    files = {}
    for world, (sub, cases) in worlds.items():
        sub.mkdir()
        files[world] = _write_cases(sub / "cases.npz", arrays, cases)
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


def run_cases(root, cases: list, world: int, *, batch: int = 2,
              seq: int = 16, timeout: float = 300) -> tuple:
    """Seeded float32 weights (``init_params`` on the CPU at the case
    mesh's tp) and inputs for ``cases``, run at once through
    :data:`REF_SCRIPT` and a world of ``world`` gloo ranks in ``tp`` mode
    -> (the reference's outputs, [each rank's]), each a loaded
    ``.npz``."""
    root = Path(root)
    arrays = dict(cases=np.asarray(json.dumps(cases)), max_seq=MAX_SEQ,
                  decode_steps=DECODE_STEPS)
    rng = np.random.default_rng(5)
    for i, case in enumerate(cases):
        cfg = case_config(case)
        params = lm.init_params(cfg, i, device="cpu", dtype=torch.float32,
                                tp=case["mesh"][-1])
        for path, t in sorted_leaves(params):
            arrays[f"{case['name']}/w/{path_key(path)}"] = t.numpy()
        for f in ("tokens", "labels"):
            arrays[f"{case['name']}/{f}"] = rng.integers(
                0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        if cfg.is_encdec:
            arrays[f"{case['name']}/frames"] = rng.standard_normal(
                (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    cases_file = root / "cases.npz"
    np.savez(cases_file, **arrays)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    env.pop("XLA_FLAGS", None)
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT,
                            str(cases_file), str(root / "ref.npz")], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    procs = []
    try:
        procs = start_world("tp", cases_file, root, world, env)
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
        out, err = ref.communicate(timeout=timeout)
        assert "REF_OK" in out, err[-3000:]
    finally:
        ref.kill()
        for p in procs:
            p.kill()
    return (dict(np.load(root / "ref.npz")),
            [dict(np.load(root / f"tp_rank{r}.npz")) for r in range(world)])


def rank_mesh(shape, rank: int):
    """A ``(data, model)`` mesh's arithmetic for one rank, without a
    world."""
    return mesh_mod.Mesh(("data", "model"),
                         dict(zip(("data", "model"), shape)), rank,
                         torch.device("cpu"), {}, "gloo", "send_recv")


def start_world(mode: str, cases_file, root, world: int, env: dict) -> list:
    """Spawn the ``world`` ranks of one gloo world on ``cases_file``
    (``OMP_NUM_THREADS=1``, loopback); -> their ``Popen``s, whose outputs
    are ``root / f"{mode}_rank{r}.npz"``."""
    env = dict(env, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    rdv = Path(root) / f"rdv_{mode}"
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(cases_file),
         str(rdv), str(r), str(world), str(Path(root) / f"{mode}_rank{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def main(mode: str, cases_file: str, init_file: str, rank: int, world: int,
         out_file: str) -> None:
    data = np.load(cases_file)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    out = {}
    try:
        for case in json.loads(str(data["cases"])):
            {"tp": run_tp, "seq": run_seq,
             "train": run_train}[mode](data, case, rank, out)
    finally:
        dist.destroy_process_group()
    np.savez(out_file, **{k: (v.detach().numpy() if torch.is_tensor(v)
                              else v) for k, v in out.items()})


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]),
         int(sys.argv[5]), sys.argv[6])
