"""One rank of a CPU gloo world for ``tests/test_torch_tp.py`` and
``tests/test_torch_train_mesh.py``.

    python tests/_torch_tp_rank.py MODE CASES INIT RANK WORLD OUT

``CASES`` is an ``.npz`` the test wrote: the cases as JSON and, for each,
the whole weights (``<case>/w/<path>``) and inputs; ``INIT`` the file of
a ``file://`` rendezvous; ``RANK`` this rank of ``WORLD``.  The rank
joins a gloo world and, for each case, builds the case's mesh
(``launch.mesh.make_mesh`` on the CPU), takes its shards of the weights
(``launch.mesh.shard_params``) and runs the port:

* ``tp``: prefill logits, three decode steps, ``train_loss`` and every
  leaf's gradient of the rank's shards, and the mesh's collective counts;
* ``train``: two steps of ``train.make_train_step`` over the case's mesh
  from the rank's share of each global batch (its params gathered whole,
  its ZeRO-1 slices of ``m`` / ``v`` / ``ef``, the mesh's counts), and
  ``_int8_pod_exchange`` on the pod's gradients.

It writes its outputs to ``OUT`` and imports only torch, numpy and
``repro_torch``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import TrainConfig, get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.models.common import sorted_leaves, tree_from_sorted_leaves
from repro_torch.train import init_state, make_train_step
from repro_torch.train import step as t_step

MAX_SEQ = 32
DECODE_STEPS = 3


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
    toks = _tensor(data[f"{name}/tokens"])
    labels = _tensor(data[f"{name}/labels"])
    mesh.reset_stats()
    with torch.no_grad():
        out[f"{name}/prefill"] = model.prefill(params, {"tokens": toks})
        cache = model.init_cache(toks.shape[0], MAX_SEQ)
        for i in range(DECODE_STEPS):
            logits, cache = model.decode_step(params, toks[:, i:i + 1],
                                              cache)
            out[f"{name}/decode{i}"] = logits
    out[f"{name}/stats_serve"] = np.asarray(json.dumps(mesh.stats_json()))
    loss, grads = t_step.value_and_grad(
        t_step.make_loss_fn(model), params,
        {"tokens": toks, "labels": labels})
    out[f"{name}/loss"] = loss
    for path, g in sorted_leaves(grads):
        out[f"{name}/g/{path_key(path)}"] = g
    out[f"{name}/stats"] = np.asarray(json.dumps(mesh.stats_json()))


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
    mesh.reset_stats()
    for i in range(2):
        batch = {f: data[f"{name}/{f}{i}"] for f in ("tokens", "labels")}
        b = batch["tokens"].shape[0] // n
        state, met = step(state, {f: _tensor(v[k * b:(k + 1) * b])
                                  for f, v in batch.items()})
        out[f"{name}/loss{i}"] = met["loss"]
    out[f"{name}/stats"] = np.asarray(json.dumps(mesh.stats_json()))
    for part in ("params", "m", "v", "ef"):
        tree = getattr(state, part)
        if tree is None:
            continue
        for path, x in sorted_leaves(tree):
            out[f"{name}/{part}/{path_key(path)}"] = x


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
            (run_tp if mode == "tp" else run_train)(data, case, rank, out)
    finally:
        dist.destroy_process_group()
    np.savez(out_file, **{k: (v.detach().numpy() if torch.is_tensor(v)
                              else v) for k, v in out.items()})


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]),
         int(sys.argv[5]), sys.argv[6])
