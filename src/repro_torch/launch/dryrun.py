"""Multi-pod dry run: trace one rank's program of every (arch x shape x
mesh) cell on the ``meta`` device.  The reference's ``launch/dryrun.py``
in PyTorch.

The reference lowers and compiles each cell's step on 256 or 512
placeholder devices; a compile that succeeds proves the sharding and
collective program coherent.  The port's program is one rank's (each
rank runs its share and calls the collectives itself), and a world of
256 ranks is not started for a dry run.  So per cell the dry run:

  1. builds the full config and rank 0's inputs of the production mesh
     (``launch/mesh.py::make_meta_mesh``: ``(16, 16)`` or ``(2, 16,
     16)``) as ``meta`` tensors of the rank's local shapes (the batch,
     the cache, the parameters and the ZeRO-1 state, each through the
     reference's specs and ``local_shape``); nothing is allocated;
  2. runs the rank's step (``make_train_step(..., inplace=True)`` with
     remat, ``prefill`` or ``decode_step(..., inplace=True)``) under
     ``launch/hlo_analysis.py::CostMode``, which counts its FLOPs, bytes,
     collective bytes and peak live bytes;
  3. runs the steps of rank 0's neighbours along each axis too and
     requires each pair to issue the same sequence of collectives
     (op, axes, shape, dtype) over the axis they share: where they differ
     a real world would hang.  This check stands in for the coherence the
     reference's compile proves;
  4. writes the counts, the exact argument bytes of the rank, the
     roofline's three terms on the H100's constants
     (``launch/roofline.py``), the kernel calls and, for a decode cell,
     the cache's bytes a rank and spec a leaf, into
     ``experiments/dryrun_torch/<cell>.json``.

What differs from the reference: ``build_cell`` returns a :class:`Cell`
(the step, the rank's meta arguments and their specs) and takes another
shape than ``SHAPES``'s; a record has ``trace_s`` where the reference has
``lower_s`` and ``compile_s``, ``temp_size_in_bytes`` is the peak of the
bytes the step creates (outputs included) above its arguments, and there
is no generated code or HLO.  The train step updates its state and the
serve step writes its cache in place, the counterparts of the reference's
donated state and cache, so neither holds a second copy;
``alias_size_in_bytes`` is the bytes of the outputs whose storage is an
argument's (the state, or the cache), as the reference's.  The
``moegather`` variant's local picks depend on the routing; on ``meta``
they are all T*k picks (the reference's static count of gathered slices,
``src/repro/models/moe.py:147-159``), which a cell records as
``assumed``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
      [--variant seqcache] [--skip-done]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs import SHAPES, all_archs, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch import hlo_analysis
from repro_torch.launch import roofline as roof
from repro_torch.launch.mesh import (local_shape, make_meta_mesh, neighbour,
                                     shardings_for)
from repro_torch.models import lm as lm_mod
from repro_torch.models.common import (Spec, sorted_leaves, tree_leaves,
                                       tree_map)
from repro_torch.models.lm import LM, Leaf
from repro_torch.train import init_state, make_train_step, state_pspecs
from repro_torch.train.optimizer import TrainState

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")


def cell_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("long_500k needs sub-quadratic attention; "
                f"{cfg.name} is pure full-attention (DESIGN.md §4)")
    return None


def _batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The input batch as :class:`Leaf` s of the whole arrays, each with
    its spec."""
    B = shape.global_batch
    S = shape.seq_len
    bspec = "data" if B % 16 == 0 else None
    out = {}
    if shape.kind in ("train", "prefill"):
        S_text = S - cfg.vision_tokens if cfg.vision_tokens else S
        out["tokens"] = Leaf((B, S_text), "int32", spec=Spec(bspec, None))
        if shape.kind == "train":
            out["labels"] = Leaf((B, S_text), "int32", spec=Spec(bspec, None))
        if cfg.vision_tokens:
            out["patches"] = Leaf((B, cfg.vision_tokens, cfg.d_model),
                                  "float32", spec=Spec(bspec, None, None))
        if cfg.is_encdec:
            out["frames"] = Leaf((B, cfg.encoder_seq, cfg.d_model),
                                 "float32", spec=Spec(bspec, None, None))
    else:  # decode: one token per sequence
        out["tokens"] = Leaf((B, 1), "int32", spec=Spec(bspec, None))
    return out


def _cache_specs(model: LM, shape: ShapeConfig) -> tuple:
    """(the cache template, its max_seq): ``swa``'s rolling window cuts
    the sequence."""
    cfg = model.cfg
    max_seq = shape.seq_len
    if cfg.attn_kind == "swa" and cfg.window:
        max_seq = min(max_seq, cfg.window)  # rolling-window cache
    return model.cache_template(shape.global_batch, max_seq), max_seq


VARIANTS = {
    "padheads": {"pad_attn_heads": True},
    "seqcache": {"cache_seq_shard": True},
    "moegather": {"moe_gather_decode": True},
}


@dataclasses.dataclass
class Cell:
    """A cell's step on one rank: ``fn(*args)``; ``args`` the rank's
    inputs as meta tensors of its local shapes, ``whole`` the same trees
    as :class:`Leaf` s of the whole arrays (shape, dtype and spec),
    ``max_seq`` the cache's length (decode)."""

    fn: Callable
    args: tuple
    whole: tuple
    cfg: ModelConfig
    shape: ShapeConfig
    model: LM
    mesh: Any
    max_seq: int = 0


def _local(lf: Leaf, mesh) -> torch.Tensor:
    shape = local_shape(lf.shape, shardings_for(mesh, lf.spec), mesh)
    return torch.empty(shape, dtype=lm_mod._DTYPES[lf.dtype], device="meta")


def _map(fn, tree):
    """``tree_map`` through a :class:`TrainState` too."""
    if isinstance(tree, TrainState):
        return TrainState(*(_map(fn, getattr(tree, f.name))
                            for f in dataclasses.fields(tree)))
    if isinstance(tree, tuple):
        return tuple(_map(fn, t) for t in tree)
    return tree_map(fn, tree)


def _with_specs(tmpl, specs):
    return tree_map(lambda lf, sp: dataclasses.replace(lf, spec=sp),
                    tmpl, specs)


def build_cell(arch: str, shape_name: str, mesh, variant: str | None = None,
               *, shape: ShapeConfig | None = None,
               cfg: ModelConfig | None = None) -> Cell:
    """The cell's step on ``mesh``'s rank (a ``MetaMesh``, or a live
    ``Mesh`` whose step :func:`materialize` feeds); ``shape`` replaces
    ``SHAPES[shape_name]`` and ``cfg`` ``get_config(arch)`` (a reduced
    config, in the tests).  The train and serve steps update their state
    and cache in place, as the reference donates them."""
    cfg = cfg or get_config(arch)
    if variant:
        for v in variant.split("+"):
            cfg = dataclasses.replace(cfg, **VARIANTS[v])
    shape = shape or SHAPES[shape_name]
    model = LM(cfg, mesh=mesh)
    batch = _batch_specs(cfg, shape)
    tmpl = lm_mod.param_template(cfg, model.tp)

    if shape.kind == "train":
        # the reference donates the state (donate_argnums=(0,))
        step = make_train_step(model, TrainConfig(remat="block"), mesh=mesh,
                               inplace=True)
        dsz = mesh.shape["data"] * mesh.shape.get("pod", 1)
        st_specs = state_pspecs(model.pspecs(), model.abstract(),
                                data_size=dsz, zero1=True)
        f32 = lambda lf: dataclasses.replace(lf, dtype="float32")
        st = TrainState(tmpl, _with_specs(tree_map(f32, tmpl),
                                          st_specs.m),
                        _with_specs(tree_map(f32, tmpl), st_specs.v),
                        Leaf((), "int32", spec=Spec()))
        whole = (st, batch)
        args = _map(lambda lf: _local(lf, mesh), whole)
        return Cell(step, args, whole, cfg, shape, model, mesh)

    params = tree_map(lambda lf: _local(lf, mesh), tmpl)
    if shape.kind == "prefill":
        whole = (tmpl, batch)
        args = (params, tree_map(lambda lf: _local(lf, mesh), batch))
        return Cell(model.prefill, args, whole, cfg, shape, model, mesh)

    cache_tmpl, max_seq = _cache_specs(model, shape)
    cache = tree_map(lambda lf: _local(lf, mesh), cache_tmpl)
    model.cache_batch = shape.global_batch  # as init_cache sets it

    def serve_step(params, tokens, cache):
        # the reference donates the cache (donate_argnums=(2,)): the step
        # writes the new token into it and hands the same tensors back
        return model.decode_step(params, tokens, cache, inplace=True)

    whole = (tmpl, batch["tokens"], cache_tmpl)
    args = (params, _local(batch["tokens"], mesh), cache)
    return Cell(serve_step, args, whole, cfg, shape, model, mesh, max_seq)


def materialize(cell: Cell, seed: int = 0) -> tuple:
    """Live inputs of ``cell``'s step on its model's device (the rank's
    shares, from ``seed``): the parameters from ``LM.init``, the ZeRO-1
    state from ``init_state``, random tokens and float32 patches or
    frames, and a zero cache from ``init_cache``."""
    model, mesh, shape = cell.model, cell.mesh, cell.shape
    dev = model.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)

    def batch_leaf(t):
        if t.dtype == torch.int32:
            return torch.randint(0, cell.cfg.vocab_size, tuple(t.shape),
                                 generator=gen, device=dev,
                                 dtype=torch.int32)
        return torch.randn(tuple(t.shape), generator=gen, device=dev,
                           dtype=t.dtype)

    params = model.init(seed)
    if shape.kind == "train":
        state = init_state(params, mesh=mesh, pspecs=model.pspecs(),
                           zero1=True)
        return state, tree_map(batch_leaf, cell.args[1])
    if shape.kind == "prefill":
        return params, tree_map(batch_leaf, cell.args[1])
    cache = model.init_cache(shape.global_batch, cell.max_seq)
    return params, batch_leaf(cell.args[1]), cache


def _nbytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in _tensors(tree)))


def _tensors(tree) -> list:
    if isinstance(tree, TrainState):
        return _tensors(tree.tree())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _alias_bytes(args, out) -> int:
    """The bytes of ``out``'s tensors whose storage is one of ``args``'
    (each storage once): what the step hands back in its arguments'
    buffers, the reference's ``alias_size_in_bytes``."""
    held = {t.untyped_storage()._cdata for t in _tensors(args)}
    seen, n = set(), 0
    for t in _tensors(out):
        key = t.untyped_storage()._cdata
        if key in held and key not in seen:
            seen.add(key)
            n += t.numel() * t.element_size()
    return n


def _arg_bytes_per_device(whole, chips: int) -> int:
    total = 0
    for lf in _leaves(whole):
        total += int(np.prod(lf.shape)) * torch.empty(
            (), dtype=lm_mod._DTYPES[lf.dtype]).element_size()
    return total // chips  # upper bound assumes full sharding


def _leaves(tree) -> list:
    if isinstance(tree, TrainState):
        return _leaves(tree.tree())
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, Leaf) else []


def trace(cell: Cell):
    """Run ``cell``'s step once under a ``CostMode`` -> (its outputs, the
    mode)."""
    with hlo_analysis.CostMode(mesh=cell.mesh, device="meta") as mode:
        out = cell.fn(*cell.args)
    return out, mode


def trace_rank(arch: str, shape_name: str, multi_pod: bool,
               variant: str | None, rank: int) -> dict:
    """Trace rank ``rank``'s step of a cell -> ``{"rank", "records" (its
    collectives, as tuples), "trace_s"}``, and for rank 0 the cell's
    record fields (memory, roofline, kernel calls, cache specs)."""
    mesh = make_meta_mesh(multi_pod=multi_pod, rank=rank)
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh, variant)
    out, mode = trace(cell)
    res = {"rank": rank, "trace_s": time.time() - t0,
           "records": [dataclasses.astuple(r) for r in mesh.records]}
    if rank:
        return res
    shape, chips = cell.shape, mesh.size
    n_dense, n_expert = roof.count_params_split(
        lm_mod.param_template(cell.cfg), Leaf)
    mf = roof.model_flops_for(cell.cfg, shape, n_dense, n_expert)
    rl = roof.analyse(mode.cost, chips=chips, model_flops=mf)
    res["rec"] = {
        "memory_analysis": {
            "argument_size_in_bytes": _nbytes(cell.args),
            "output_size_in_bytes": _nbytes(out),
            "alias_size_in_bytes": _alias_bytes(cell.args, out),
            "temp_size_in_bytes": int(mode.peak_live_bytes),
            "arguments_per_device_estimate":
                _arg_bytes_per_device(cell.whole, chips)},
        "roofline": rl.to_dict(),
        "n_params_dense": n_dense,
        "n_params_expert": n_expert,
        "mesh_stats": mesh.stats_json(),
        "collectives": len(mesh.records),
        "kernels": mode.summary()["kernels"],
        "dot_flops_per_device": mode.dot_flops,
    }
    if shape.kind == "decode":
        res["rec"]["cache_bytes"] = _nbytes(cell.args[2])
        res["rec"]["cache_specs"] = {
            "/".join(str(p) for p in path): list(sp)
            for path, sp in sorted_leaves(tree_map(
                lambda lf: shardings_for(mesh, lf.spec), cell.whole[2]))}
        if cell.cfg.moe and cell.cfg.moe_gather_decode \
                and cell.args[1].shape[0] <= 64:
            res["rec"]["assumed"] = {"moe_gather_local_picks": (
                "T*k, the reference's static count of gathered slices "
                "(meta has no routing values)")}
    return res


def _cell_ranks(multi_pod: bool) -> dict:
    """Rank 0 and its neighbour along each axis: ``{"self" or axis:
    rank}``."""
    mesh = make_meta_mesh(multi_pod=multi_pod)
    return {"self": 0, **{a: neighbour(mesh, a) for a in mesh.axis_names}}


def _collective_seq(records, axis: str) -> list:
    """The (op, axes, shape, dtype) of each collective over ``axis``."""
    return [r[:4] for r in records if axis in r[1].split("+")]


def _skip_or_head(arch, shape_name, multi_pod, variant) -> dict:
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "chips": make_meta_mesh(multi_pod=multi_pod).size}
    reason = cell_skip_reason(get_config(arch), SHAPES[shape_name])
    if reason:
        rec["status"] = "skip"
        rec["reason"] = reason
    return rec


def _assemble(rec: dict, traced: dict) -> dict:
    """A cell's record from its ranks' traces (``{rank: trace_rank's
    result}``): rank 0's counts, and each neighbour's collectives over
    the axis it shares with rank 0 equal to rank 0's, else an error."""
    ranks = _cell_ranks(rec["chips"] == 512)
    me = traced[0]
    for axis, r in ranks.items():
        if axis != "self" and _collective_seq(me["records"], axis) \
                != _collective_seq(traced[r]["records"], axis):
            raise RuntimeError(
                f"ranks 0 and {r} issue different collectives over "
                f"{axis!r}: a real world would hang")
    rec.update({"status": "ok", "trace_s": round(me["trace_s"], 1),
                **me["rec"], "collectives_agree": True,
                "ranks_traced": ranks,
                "trace_s_ranks": {str(r): round(traced[r]["trace_s"], 1)
                                  for r in ranks.values()}})
    return rec


def _error(rec: dict, err: str, tb: str) -> dict:
    rec.update({"status": "error", "error": err, "traceback": tb[-4000:]})
    return rec


def _safe_trace(*task) -> dict:
    try:
        return trace_rank(*task)
    except Exception as e:  # reported with the cell it belongs to
        return {"rank": task[-1], "error": repr(e),
                "traceback": traceback.format_exc()}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             variant: str | None = None) -> dict:
    """One cell, its ranks traced in this process."""
    return run_cells([(arch, shape_name, multi_pod, variant)])[0]


def run_cells(cells, *, jobs: int = 1, on_done=None) -> list:
    """Records of ``cells`` (``(arch, shape_name, multi_pod, variant)``
    each), their ranks traced in a pool of ``jobs`` spawned processes
    (in this process with ``jobs`` 1); ``on_done(rec)`` is called as each
    cell's record is complete.  A cell whose trace raises gets ``status:
    "error"`` and the traceback."""
    recs = [_skip_or_head(*c) for c in cells]
    tasks = [(*c, r) for c, rec in zip(cells, recs)
             if rec.get("status") != "skip"
             for r in sorted(set(_cell_ranks(c[2]).values()))]
    pending = {i: len(set(_cell_ranks(c[2]).values()))
               for i, (c, rec) in enumerate(zip(cells, recs))
               if rec.get("status") != "skip"}
    traced = {i: {} for i in pending}
    for i, rec in enumerate(recs):
        if i not in pending and on_done:
            on_done(rec)

    def finish(task, res):
        i = cells.index(task[:4])
        traced[i][task[4]] = res
        if len(traced[i]) < pending[i]:
            return
        bad = [t for t in traced[i].values() if "error" in t]
        try:
            if bad:
                _error(recs[i], bad[0]["error"], bad[0]["traceback"])
            else:
                _assemble(recs[i], traced[i])
        except Exception as e:
            _error(recs[i], repr(e), traceback.format_exc())
        if on_done:
            on_done(recs[i])

    if jobs <= 1:
        for t in tasks:
            finish(t, _safe_trace(*t))
        return recs
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed
    with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        futs = {pool.submit(_safe_trace, *t): t for t in tasks}
        for f in as_completed(futs):
            finish(futs[f], f.result())
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="'+'-joined perf variants: " + ",".join(VARIANTS))
    ap.add_argument("--skip-done", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes tracing ranks at once")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    cells = []
    archs = all_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    tags = {}
    todo = []
    for a, s, mp in cells:
        tag = f"{a}__{s}__{'pod2' if mp else 'pod1'}"
        if args.variant:
            tag += "__" + args.variant.replace("+", "_")
        out = os.path.join(args.out, tag + ".json")
        if args.skip_done and os.path.exists(out):
            print(f"[dryrun] {tag}: cached")
            continue
        tags[(a, s, mp)] = (tag, out)
        todo.append((a, s, mp, args.variant))

    def write(rec):
        tag, out = tags[(rec["arch"], rec["shape"],
                         rec["mesh"] in ("2x16x16", "pod2"))]
        with open(out, "w") as f:
            json.dump(rec, f, indent=1)
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f" dominant={r['dominant']}"
                     f" step={r['step_time_s']:.4f}s mfu={r['mfu']:.3f}"
                     f" trace={rec['trace_s']}s")
        elif status == "error":
            extra = " " + rec["error"][:200]
        print(f"[dryrun] {tag}: {status}{extra}", flush=True)

    t0 = time.time()
    recs = run_cells(todo, jobs=args.jobs, on_done=write)
    counts = {k: sum(r["status"] == k for r in recs)
              for k in ("ok", "skip", "error")}
    print(f"[dryrun] {len(recs)} cells: {counts} in "
          f"{time.time() - t0:.1f} s", flush=True)
    return recs


if __name__ == "__main__":
    main()
