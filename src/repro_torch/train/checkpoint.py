"""Atomic, retained checkpoints: the reference's ``train/checkpoint.py``
for trees of tensors.

Layout (one directory per step), the reference's, so that a checkpoint
either package writes restores in the other:

    <dir>/step_000200.tmp/...      (written first)
    <dir>/step_000200/manifest.json  + leaf_<i>.npy
    <dir>/LATEST                   (atomic pointer file)

Leaves are saved as host numpy in the reference's flat order
(``models.common.sorted_leaves``, that of ``jax.tree.flatten``); bf16
leaves are stored as float32 (``.npy`` has no bf16) with their dtype in the
manifest.  ``restore`` rebuilds the structure of ``tree_like`` with each
leaf on that leaf's device; it never reads ``manifest["treedef"]``, which
is the port's own description of the tree.  ``save`` is atomic (tmp dir +
rename) and keeps ``retain`` newest checkpoints.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.models.common import sorted_leaves, tree_from_sorted_leaves


def _treedef(tree) -> str:
    """The tree's structure with ``*`` for each leaf, keys sorted."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    return "None" if tree is None else "*"


def _host(leaf) -> tuple:
    """-> (numpy array to save, its dtype's name): bf16 as float32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree, *, retain: int = 3) -> str:
    leaves = [t for _, t in sorted_leaves(tree)]
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "num_leaves": len(leaves),
                "treedef": _treedef(tree), "dtypes": []}
    for i, leaf in enumerate(leaves):
        arr, dtype = _host(leaf)
        manifest["dtypes"].append(dtype)
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(name)
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    _gc(ckpt_dir, retain)
    return final


def _gc(ckpt_dir: str, retain: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-retain]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip().split("_")[1])


def restore(ckpt_dir: str, tree_like, *, step: int | None = None):
    """Restore into the structure of ``tree_like``: each leaf a tensor of
    the saved dtype on the device of ``tree_like``'s leaf (the CPU for a
    leaf that is not a tensor)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for i, (_, ref) in enumerate(sorted_leaves(tree_like)):
        t = torch.from_numpy(np.load(os.path.join(d, f"leaf_{i:05d}.npy")))
        if manifest["dtypes"][i] == "bfloat16":
            t = t.to(torch.bfloat16)
        out.append(t.to(ref.device if isinstance(ref, torch.Tensor)
                        else "cpu"))
    return tree_from_sorted_leaves(tree_like, out)
