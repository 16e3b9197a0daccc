"""The port's compile-time tools (``launch/{dryrun,roofline,hlo_analysis,
report}.py``) against the reference's, on the CPU.

* the closed forms of ``tests/test_hlo_analysis.py`` with the port's
  counter, on the CPU and on ``meta``: a 10-trip loop of 128^3 matmuls
  counted 10x, nested 5 x 10 loops 50x, the remat gradient of
  ``torch.utils.checkpoint`` at 4x (rel 0.1), a gather from a bank below
  two bank reads, ``0 < bytes <= bytes_upper``, a psum inside a 7-trip
  loop on the mesh stand-in counted 7x;
* the counter's dot FLOPs equal ``FlopCounterMode``'s on a program with no
  kernel wrapper;
* a reduced llama3.2-1b train, prefill and decode step through the
  dry run's builders at mesh ``(1, 1)`` counted the same on ``meta`` and
  on the CPU (every count, op by op), each wrapper's work once;
* ``count_params_split`` and ``model_flops_for`` equal the reference's
  for all ten configs and the four ``SHAPES``;
* a cell's ``argument_size_in_bytes`` equal to the local bytes of the
  reference's parameter, state, batch and cache specs at ``(16, 16)``;
* the six cells of ``chip_smoke.py`` phase 19 (a) end to end, each
  ``ok`` or ``skip``, with ``collectives_agree``;
* ``report``'s tables equal the reference's on the same cell dicts;
* the gqa cache layout over ``model`` in a decode cell's specs, the
  reference's ``head_dim`` split, and its bytes a rank; the in-place
  serve step of qwen2.5-14b at ``decode_32k`` holds no second cache;
* the in-place train step (the reference's donated state): at a small
  ZeRO-1 cell its arguments plus temporaries fall, against the functional
  step's, by at least the rank's ``m`` and ``v`` bytes;
  ``alias_size_in_bytes`` is the state's bytes for a train cell and the
  cache's for a decode cell; ``mul_``, ``add_``, ``copy_`` and an
  ``out=`` form add no storage to the peak.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.launch import report as r_report
from repro.launch import roofline as r_roof
from repro.models import lm as r_lm
from repro.train import optimizer as r_opt
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeConfig, TrainConfig,
                                  get_config)
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.hlo_analysis import CostMode
from repro_torch.models import lm
from repro_torch.models.common import sorted_leaves
from repro_torch.train import make_train_step

DEVICES = ("cpu", "meta")
N = 128


def _mats(device, *shapes):
    gen = torch.Generator().manual_seed(0)
    return [torch.randn(s, generator=gen).to(device) for s in shapes]


# ------------------------------------------------------------ closed forms
@pytest.mark.parametrize("device", DEVICES)
def test_loop_flops_counted_once_a_trip(device):
    x, w = _mats(device, (N, N), (N, N))
    with CostMode() as c:
        for _ in range(10):
            x = x @ w
    assert c.cost.flops / (2 * N**3 * 10) == pytest.approx(1.0, rel=0.01)
    assert c.dot_flops == 2 * N**3 * 10


@pytest.mark.parametrize("device", DEVICES)
def test_nested_loop_flops(device):
    x, w = _mats(device, (N, N), (N, N))
    with CostMode() as c:
        for _ in range(5):
            for _ in range(10):
                x = x @ w
    assert c.cost.flops / (2 * N**3 * 50) == pytest.approx(1.0, rel=0.01)


@pytest.mark.parametrize("device", DEVICES)
def test_grad_remat_flops_ratio(device):
    x, w = _mats(device, (N, N), (N, N))
    w.requires_grad_(True)

    def body(c):
        return torch.tanh(c @ w)

    with CostMode() as c:
        out = x
        for _ in range(10):
            out = checkpoint(body, out, use_reentrant=False)
        torch.autograd.grad(out.sum(), w)
    # fwd + recompute + 2 bwd dots = 4x the forward matmul flops (the
    # first trip's input needs no gradient: 3.9)
    assert c.cost.flops / (2 * N**3 * 10) == pytest.approx(4.0, rel=0.1)


@pytest.mark.parametrize("device", DEVICES)
def test_gather_counts_output_not_operand(device):
    bank, = _mats(device, (512, 1024))
    idx = torch.randint(0, 512, (8, 2), generator=torch.Generator()
                        .manual_seed(1)).to(device)
    with CostMode() as c:
        acc = torch.zeros((), device=device)
        for i in range(8):
            acc = acc + bank[idx[i]].sum()
    bank_bytes = 512 * 1024 * 4
    assert 0 < c.cost.bytes < 2 * bank_bytes
    assert c.by_op["index"][2] == 8 * 2 * (2 * 1024 * 4)


@pytest.mark.parametrize("device", DEVICES)
def test_bytes_fused_below_upper(device):
    x, w = _mats(device, (256, 256), (256, 256))
    with CostMode() as c:
        torch.tanh(x @ w) * 2.0 + 1.0
    assert 0 < c.cost.bytes <= c.cost.bytes_upper
    assert c.cost.bytes == 3 * 256 * 256 * 4  # the dot alone materializes


@pytest.mark.parametrize("device", DEVICES)
def test_in_place_and_out_forms_add_no_storage(device):
    """Writes into tensors made before the counter (a state's leaves) are
    not new live bytes: in-place ops and ``out=`` forms alike."""
    a, b = _mats(device, (N, N), (N, N))
    with CostMode(device=device) as c:
        a.mul_(2.0).add_(b)
        a.copy_(b)
        torch.mul(b, 3.0, out=a)
        torch.div(a, b, out=a)
        torch.sub(b, a, out=a)
    assert c.peak_live_bytes == 0
    with CostMode(device=device) as c:
        torch.mul(b, 3.0)
    assert c.peak_live_bytes == N * N * 4


def test_collective_bytes_multiply_by_trips():
    mesh = mesh_mod.make_meta_mesh(axis_shapes=(4, 1))
    x = torch.empty((64, 64), device="meta")
    with CostMode(mesh=mesh) as c:
        for _ in range(7):
            x = mesh.psum(x, "data") * 0.5
    per = 64 * 64 * 4
    assert c.cost.coll_total / per == 7
    assert c.cost.coll_bytes == {"all-reduce": 7 * per}
    assert mesh.stats_json() == {"psum/data/float32": dict(
        calls=7, bytes=7 * per, s=0.0)}
    assert [r.op for r in mesh.records] == ["psum"] * 7


def test_meta_mesh_refuses_values_and_shapes_collectives():
    mesh = mesh_mod.make_meta_mesh(multi_pod=True, rank=5)
    assert mesh.coords == {"pod": 0, "data": 0, "model": 5}
    assert isinstance(mesh, mesh_mod.Mesh) and mesh.size == 512
    x = torch.empty((3, 8), dtype=torch.bfloat16, device="meta")
    assert mesh.all_gather(x, "model", dim=1).shape == (3, 128)
    assert mesh.all_gather(x, ("pod", "data")).shape == (96, 8)
    assert mesh.ppermute(x, "pod", [(0, 1), (1, 0)]).shape == (3, 8)
    assert mesh.pmax(x, "data").dtype == torch.bfloat16
    with pytest.raises(ValueError, match="meta"):
        mesh.psum(torch.zeros(3), "model")
    assert mesh_mod.neighbour(mesh, "model") == 6
    assert mesh_mod.neighbour(mesh, "pod") == 256 + 5


def test_dot_flops_equal_flop_counter_mode():
    x, w1, w2, b = _mats("cpu", (4, 16, 32), (32, 64), (64, 32), (32,))
    w1.requires_grad_(True)

    def prog():
        h = torch.einsum("bsd,df->bsf", x, w1)
        y = torch.nn.functional.linear(torch.relu(h), w2.T, b)
        z = torch.bmm(y, y.transpose(1, 2))
        return torch.autograd.grad(z.sum(), w1)

    with FlopCounterMode(display=False) as fc:
        prog()
    with CostMode() as c:
        prog()
    assert c.dot_flops == fc.get_total_flops() > 0


# ------------------------------------------------- meta against the CPU
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rdv = tmp_path_factory.mktemp("rdv")
    dist.init_process_group("gloo", init_method=f"file://{rdv}/rdv", rank=0,
                            world_size=1)
    yield mesh_mod.make_debug_mesh(1, 1, device="cpu")
    dist.destroy_process_group()


STEP_SHAPES = [ShapeConfig("train_small", 64, 2, "train"),
               ShapeConfig("prefill_small", 64, 2, "prefill"),
               ShapeConfig("decode_small", 32, 2, "decode")]


@pytest.mark.parametrize("shape", STEP_SHAPES, ids=lambda s: s.kind)
def test_reduced_llama_step_counts_equal_on_meta_and_cpu(world, shape):
    cfg = get_config("llama3.2-1b", reduced=True)
    modes = {}
    for name, mesh in (("meta", mesh_mod.make_meta_mesh(axis_shapes=(1, 1))),
                       ("cpu", world)):
        cell = dryrun.build_cell("llama3.2-1b", None, mesh, shape=shape,
                                 cfg=cfg)
        feed = (lambda: cell.args) if name == "meta" else \
            (lambda: dryrun.materialize(cell, 0))
        cell.fn(*feed())  # warm the per-device tables (rope)
        args = feed()
        with CostMode(mesh=mesh, device=name) as modes[name]:
            cell.fn(*args)
    a, b = modes["meta"], modes["cpu"]
    assert a.summary() == b.summary()
    assert a.by_op == b.by_op
    # each wrapper's work counted once: the aten ops plus the kernels
    kern = a.kernels
    assert a.cost.flops == pytest.approx(
        sum(v[1] for v in a.by_op.values())
        + sum(k["flops"] for k in kern.values()), rel=1e-12)
    per_layer = 5  # q, k, v, gate, up
    fwd = per_layer * cfg.num_layers * (2 if shape.kind == "train" else 1)
    assert kern["fused_norm_matmul"]["calls"] == fwd
    S = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    d, hd = cfg.d_model, cfg.head_dim
    F = [cfg.num_heads * hd, cfg.num_kv_heads * hd, cfg.num_kv_heads * hd,
         cfg.d_ff, cfg.d_ff]
    mult = 2 if shape.kind == "train" else 1
    assert kern["fused_norm_matmul"]["flops"] == mult * cfg.num_layers * sum(
        2 * S * d * f for f in F)
    if shape.kind == "train":
        assert kern["fused_norm_matmul_bwd"]["calls"] == fwd // 2
        assert "fused_norm_matmul_bwd" not in b.by_op
    else:
        assert "fused_norm_matmul_bwd" not in kern


# ------------------------------------------------ params and model FLOPs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_split_equals_reference(arch):
    got = roofline.count_params_split(lm.param_template(get_config(arch)),
                                      lm.Leaf)
    want = r_roof.count_params_split(
        r_lm.param_template(r_get_config(arch)), r_lm.Leaf)
    assert got == want


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_for_equals_reference(arch, shape):
    split = r_roof.count_params_split(
        r_lm.param_template(r_get_config(arch)), r_lm.Leaf)
    assert roofline.model_flops_for(get_config(arch), SHAPES[shape],
                                    *split) == \
        r_roof.model_flops_for(r_get_config(arch), R_SHAPES[shape], *split)


def test_roofline_terms_on_h100_constants():
    from repro_torch.launch.hlo_analysis import HloCost
    r = roofline.analyse(HloCost(989e12, 3.35e12, 0, {"all-reduce": 50e9}),
                         chips=256, model_flops=989e12 * 128)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 1.0, 1.0)
    assert r.mfu == 0.5 and r.coll_by_kind == {"all-reduce": 50000000000}
    assert set(r.to_dict()) == set(r_roof.Roofline(
        0, 0, 0, {}, 1, 0).to_dict()) - {"raw_xla_flops", "raw_xla_bytes"}


# ------------------------------------------------------- argument bytes
def _ref_local_bytes(tree, spec_tree, mesh_shape: dict) -> int:
    """Bytes of one rank's shards of ``tree`` (reference leaves with
    ``shape`` and ``dtype``) under ``spec_tree`` (PartitionSpecs)."""
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: hasattr(x, "shape"))
    specs = jax.tree.leaves(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for x, sp in zip(leaves, specs, strict=True):
        n = 1
        for i, dim in enumerate(x.shape):
            e = sp[i] if i < len(sp) else None
            axes = () if e is None else (e,) if isinstance(e, str) else e
            n *= dim // int(np.prod([mesh_shape[a] for a in axes]))
        total += n * np.dtype(_np_dtype(x.dtype)).itemsize
    return total


def _np_dtype(dt):
    return {"bfloat16": np.uint16}.get(str(dt), dt)


MESH = {"data": 16, "model": 16}


def test_train_cell_argument_bytes_equal_reference_specs():
    arch, shape = "llama3.2-1b", "train_4k"
    cell = dryrun.build_cell(arch, shape, mesh_mod.make_meta_mesh())
    model = r_lm.LM(r_get_config(arch), tp=16)
    params, specs = model.abstract(), model.pspecs()
    st = r_opt.state_pspecs(specs, params, data_size=16, zero1=True)
    want = (_ref_local_bytes(params, specs, MESH)
            + 2 * _ref_local_bytes(jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, np.float32), params),
                st.m, MESH)
            + 4  # the step
            + 2 * 256 // 16 * 4096 * 4)  # tokens and labels over data
    assert dryrun._nbytes(cell.args) == want


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "deepseek-v3-671b"])
def test_decode_cell_argument_bytes_equal_reference_specs(arch):
    cell = dryrun.build_cell(arch, "decode_32k", mesh_mod.make_meta_mesh())
    model = r_lm.LM(r_get_config(arch), tp=16)
    tmpl = model.cache_template(128, 32768)
    is_leaf = lambda x: isinstance(x, r_lm.Leaf)
    cache = jax.tree.map(lambda lf: jax.ShapeDtypeStruct(
        lf.shape, r_lm._np_dtype(lf.dtype)), tmpl, is_leaf=is_leaf)
    cspecs = jax.tree.map(lambda lf: lf.spec, tmpl, is_leaf=is_leaf)
    want = (_ref_local_bytes(model.abstract(), model.pspecs(), MESH)
            + 128 // 16 * 4 + _ref_local_bytes(cache, cspecs, MESH))
    assert dryrun._nbytes(cell.args) == want


def test_decode_cell_pins_the_gqa_cache_layout_over_model():
    """Where a gqa cache's kv heads do not split with the q heads, the
    port splits ``head_dim`` over ``model``, as the reference does.
    llama3.2-1b's 8 kv heads do not split over 16: a rank holds 64 / 16 =
    4 columns of each, the reference's spec and 1/16 of the cache."""
    cell = dryrun.build_cell("llama3.2-1b", "decode_32k",
                             mesh_mod.make_meta_mesh())
    k = cell.whole[2]["stages"][0][0]["mixer"]["k"]
    assert tuple(k.spec) == (None, "data", None, None, "model")
    assert tuple(cell.args[2]["stages"][0][0]["mixer"]["k"].shape) == (
        16, 8, 32768, 8, 4)
    ref = r_lm.LM(r_get_config("llama3.2-1b"), tp=16).cache_template(
        128, 32768)["stages"][0][0]["mixer"]["k"]
    assert tuple(ref.spec) == (None, "data", None, None, "model")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-14b"])
def test_decode_cell_argument_bytes_with_head_dim_split(arch):
    """A gqa decode cell's arguments a rank are the reference's local
    bytes of its parameter, token and cache specs at ``(16, 16)``: a
    cache of 536,870,912 B a rank for llama3.2-1b and 3,221,225,472 B for
    qwen2.5-14b at ``decode_32k``."""
    cell = dryrun.build_cell(arch, "decode_32k", mesh_mod.make_meta_mesh())
    model = r_lm.LM(r_get_config(arch), tp=16)
    tmpl = model.cache_template(128, 32768)
    is_leaf = lambda x: isinstance(x, r_lm.Leaf)
    cache = jax.tree.map(lambda lf: jax.ShapeDtypeStruct(
        lf.shape, r_lm._np_dtype(lf.dtype)), tmpl, is_leaf=is_leaf)
    cspecs = jax.tree.map(lambda lf: lf.spec, tmpl, is_leaf=is_leaf)
    cache_bytes = _ref_local_bytes(cache, cspecs, MESH)
    assert dryrun._nbytes(cell.args[2]) == cache_bytes == {
        "llama3.2-1b": 536870912 + 128 // 16 * 4,
        "qwen2.5-14b": 3221225472 + 128 // 16 * 4}[arch]
    assert dryrun._nbytes(cell.args) == (
        _ref_local_bytes(model.abstract(), model.pspecs(), MESH)
        + 128 // 16 * 4 + cache_bytes)


# ---------------------------------------------------- cells end to end
PHASE19_CELLS = [("llama3.2-1b", "train_4k", False, None),
                 ("jamba-v0.1-52b", "long_500k", False, None),
                 ("llama3.2-1b", "decode_32k", False, "seqcache"),
                 ("mixtral-8x22b", "decode_32k", False, "moegather"),
                 ("qwen2.5-14b", "long_500k", False, None),
                 ("qwen2.5-14b", "decode_32k", False, None)]


@pytest.fixture(scope="module")
def phase19_cells():
    return dryrun.run_cells(PHASE19_CELLS, jobs=4)


@pytest.mark.parametrize("i", range(len(PHASE19_CELLS)),
                         ids=[c[0] + "-" + c[1] for c in PHASE19_CELLS])
def test_phase19_cells_end_to_end(phase19_cells, i):
    rec = phase19_cells[i]
    arch, shape, _, variant = PHASE19_CELLS[i]
    assert (rec["arch"], rec["shape"], rec["variant"]) == (arch, shape,
                                                           variant)
    if shape == "long_500k" and not get_config(arch).sub_quadratic:
        assert rec["status"] == "skip"
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["collectives_agree"] and rec["chips"] == 256
    assert rec["collectives"] > 0
    mem = rec["memory_analysis"]
    cell = dryrun.build_cell(arch, shape, mesh_mod.make_meta_mesh(), variant)
    assert mem["argument_size_in_bytes"] == dryrun._nbytes(cell.args)
    rl = rec["roofline"]
    assert rl["step_time_s"] == max(rl["compute_s"], rl["memory_s"],
                                    rl["collective_s"]) > 0
    assert rl["compute_s"] == rl["flops_per_device"] / 989e12
    assert 0 < rl["hbm_bytes_per_device"] <= rl["hbm_bytes_upper"]
    assert rec["kernels"]["fused_norm_matmul"]["calls"] > 0
    if shape == "train_4k":
        assert rec["kernels"]["fused_norm_matmul_bwd"]["calls"] == \
            5 * get_config(arch).num_layers
    if variant == "moegather":
        assert "moe_gather_local_picks" in rec["assumed"]
    # the state (train) and the cache (decode) are handed back in place
    aliased = {"train": dryrun._nbytes(cell.args[0]), "prefill": 0,
               "decode": dryrun._nbytes(cell.args[-1])}
    assert mem["alias_size_in_bytes"] == aliased[SHAPES[shape].kind]
    if SHAPES[shape].kind == "decode":
        assert rec["cache_specs"]


def test_decode_cell_holds_one_cache(phase19_cells):
    """qwen2.5-14b's serve step at ``decode_32k`` writes its cache in
    place, as the reference's donated one: the bytes it creates above its
    arguments (``temp_size_in_bytes``) are less than one cache of the
    rank (3,221,225,472 B), and the rank's arguments and temporaries fit
    an 80 GB card."""
    rec = phase19_cells[PHASE19_CELLS.index(
        ("qwen2.5-14b", "decode_32k", False, None))]
    assert rec["status"] == "ok", rec.get("traceback")
    mem = rec["memory_analysis"]
    assert mem["temp_size_in_bytes"] < 3221225472
    assert mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"] < 80e9
    assert rec["cache_specs"]["stages/0/0/mixer/k"] == [
        None, "data", None, None, "model"]


def test_report_tables_equal_reference(phase19_cells):
    cells = {(r["arch"], r["shape"], "pod1"): r for r in phase19_cells}
    assert report.roofline_table(cells) == r_report.roofline_table(cells)
    ref_dry = r_report.dryrun_table(
        {k: dict(v, compile_s=v.get("trace_s")) for k, v in cells.items()})
    assert report.dryrun_table(cells) == ref_dry.replace("compile_s",
                                                         "trace_s")
    assert report.pick_hillclimb(cells) == r_report.pick_hillclimb(cells)


# ------------------------------------------------- the donated state
def _traced(kind: str, inplace: bool, axis_shapes=(2, 1)):
    """A small cell of the reduced llama3.2-1b traced on meta; with
    ``inplace`` False its step swapped for the functional one."""
    cfg = get_config("llama3.2-1b", reduced=True)
    shape = {"train": ShapeConfig("train_small", 8, 2, "train"),
             "decode": ShapeConfig("decode_small", 32, 2, "decode")}[kind]
    cell = dryrun.build_cell("llama3.2-1b", None, mesh_mod.make_meta_mesh(
        axis_shapes=axis_shapes), shape=shape, cfg=cfg)
    if not inplace and kind == "train":
        cell.fn = make_train_step(cell.model, TrainConfig(remat="block"),
                                  mesh=cell.mesh)
    elif not inplace:
        cell.fn = cell.model.decode_step
    out, mode = dryrun.trace(cell)
    return cell, out, mode


def test_inplace_train_cell_holds_one_state():
    """The reduced llama3.2-1b's ZeRO-1 train cell at ``(2, 1)``, 2 x 8
    tokens: the functional trace makes a new state (its parameters whole,
    the rank's slices of ``m`` and ``v``) above its arguments; the
    in-place one hands back the state it was given, and its arguments
    plus temporaries fall by at least the rank's ``m`` and ``v`` bytes."""
    got = {inplace: _traced("train", inplace) for inplace in (False, True)}
    (cell, out_f, f), (_, out_i, i) = got[False], got[True]
    state = cell.args[0]
    args = dryrun._nbytes(cell.args)
    mv = dryrun._nbytes(state.m) + dryrun._nbytes(state.v)
    assert mv > 0 and dryrun._nbytes(state.m) < 4 * sum(
        t.numel() for _, t in sorted_leaves(state.params))  # sliced
    assert (args + f.peak_live_bytes) - (args + i.peak_live_bytes) >= mv
    assert dryrun._alias_bytes(got[True][0].args, out_i) == \
        dryrun._nbytes(got[True][0].args[0])
    assert dryrun._alias_bytes(cell.args, out_f) == 0
    assert out_i[0] is got[True][0].args[0]
    assert i.summary()["kernels"] == f.summary()["kernels"]


def test_alias_bytes_of_a_decode_cell_are_its_cache():
    for inplace in (True, False):
        cell, out, _ = _traced("decode", inplace, (1, 1))
        cache = dryrun._nbytes(cell.args[2])
        assert cache > 0
        assert dryrun._alias_bytes(cell.args, out) == (cache if inplace
                                                       else 0)
