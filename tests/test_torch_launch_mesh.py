"""The port's mesh and spec functions (``launch/mesh.py``, the spec rules
of ``models/lm.py`` and ``train/optimizer.py``) against ``repro``'s, in
process, without a world of ranks.

* ``param_pspecs`` and ``abstract_params`` equal the reference's
  (``PartitionSpec`` as a tuple, ``ShapeDtypeStruct`` as a meta tensor)
  for all ten configs, full and reduced, at tp 2 and 16, with
  ``pad_attn_heads`` on and off;
* ``state_pspecs`` (data size 16, ZeRO-1 on and off, with the int8
  exchange's ``ef``) and ``abstract_state``, ``expand_pod`` and
  ``tree_expand_pod`` over the same trees;
* the reference's production and debug shapes, built through
  ``make_mesh``;
* ``shard_params``: every rank's shards, put back at their
  ``local_index``, are the whole tree bit for bit (the gather over a world
  is ``tests/test_torch_train_mesh.py``'s);
* ``make_mesh``'s backend checks raise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as r_get_config
from repro.launch import mesh as r_mesh
from repro.models import lm as r_lm
from repro.train import optimizer as r_opt
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import lm
from repro_torch.models.common import Spec, sorted_leaves, tree_map
from repro_torch.train import optimizer as opt

SIZES = ("full", "reduced")


def _cfgs(arch: str, size: str, pad: bool):
    reduced = size == "reduced"
    r = dataclasses.replace(r_get_config(arch, reduced=reduced),
                            pad_attn_heads=pad)
    t = dataclasses.replace(get_config(arch, reduced=reduced),
                            pad_attn_heads=pad)
    return r, t


def _ref_leaves(tree, is_leaf):
    """``[(path, leaf)]`` of a reference tree, paths as the port's."""
    return [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p), x)
            for p, x in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]]


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _same_specs(got_tree, want_tree) -> None:
    got = sorted_leaves(got_tree)
    want = _ref_leaves(want_tree, _is_spec)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert isinstance(g, Spec), path
        assert tuple(g) == tuple(w), (path, g, w)


@pytest.mark.parametrize("pad", [False, True], ids=["nopad", "pad"])
@pytest.mark.parametrize("tp", [2, 16])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_and_abstract_params_match_reference(arch, size, tp,
                                                          pad):
    rcfg, cfg = _cfgs(arch, size, pad)
    _same_specs(lm.param_pspecs(cfg, tp), r_lm.param_pspecs(rcfg, tp))
    got = sorted_leaves(lm.abstract_params(cfg, tp))
    want = _ref_leaves(r_lm.abstract_params(rcfg, tp), None)
    assert len(got) == len(want)
    for (path, g), (_, w) in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[1] == str(w.dtype), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_pspecs_and_pod_expansion_match_reference(arch):
    """At tp 16 over a data size of 16, with and without ZeRO-1 and the
    int8 exchange's residual; then the pod expansion of the whole state's
    specs."""
    rcfg, cfg = _cfgs(arch, "full", True)
    ps, rps = lm.param_pspecs(cfg, 16), r_lm.param_pspecs(rcfg, 16)
    ab, rab = lm.abstract_params(cfg, 16), r_lm.abstract_params(rcfg, 16)
    for zero1 in (True, False):
        for comp in (True, False):
            got = opt.state_pspecs(ps, ab, data_size=16, zero1=zero1,
                                   compression=comp)
            want = r_opt.state_pspecs(rps, rab, data_size=16, zero1=zero1,
                                      compression=comp)
            _same_specs(got.tree(), want.tree())
            _same_specs(mesh_mod.tree_expand_pod(got.tree()),
                        r_mesh.tree_expand_pod(want.tree()))
    st = opt.abstract_state(ab, compression=True)
    rst = r_opt.abstract_state(rab, compression=True)
    for (path, g), (_, w) in zip(sorted_leaves(st.tree()),
                                 _ref_leaves(rst.tree(), None)):
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).split(".")[1] == str(w.dtype), path


@pytest.mark.parametrize("spec", [
    (), (None,), ("data",), ("model", None), (None, "data"),
    (("data", "model"), None), ("data", "model"), (("model", "data"),)])
def test_expand_pod_matches_reference(spec):
    got = mesh_mod.expand_pod(Spec(*spec))
    assert isinstance(got, Spec)
    assert tuple(got) == tuple(r_mesh.expand_pod(
        jax.sharding.PartitionSpec(*spec)))


def test_production_and_debug_shapes(one_rank_world):
    """The reference's shapes; each factory builds a mesh through
    ``make_mesh``, so a world of another size raises."""
    for multi_pod, shape, axes in ((False, (16, 16), ("data", "model")),
                                   (True, (2, 16, 16),
                                    ("pod", "data", "model"))):
        assert mesh_mod.PRODUCTION_SHAPES[multi_pod] == (shape, axes)
        with pytest.raises(ValueError,
                           match=f"needs {int(np.prod(shape))} ranks"):
            mesh_mod.make_production_mesh(multi_pod=multi_pod, device="cpu")
    m = mesh_mod.make_debug_mesh(device="cpu")
    assert isinstance(m, mesh_mod.Mesh)
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    with pytest.raises(ValueError, match="needs 8 ranks"):
        mesh_mod.make_debug_mesh(2, 4, device="cpu")


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 4)])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2.5-14b",
                                  "mixtral-8x22b"])
def test_shard_params_tiles_the_whole_tree(arch, shape):
    """Each rank's shards (contiguous, of the local shape) put back at
    their ``local_index`` rebuild every leaf bit for bit, and every element
    is held by exactly ``size / parts`` ranks."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              pad_attn_heads=True)
    tp = shape[1]
    full = tree_map(lambda t: t.numpy(), lm.init_params(
        cfg, 7, device="cpu", dtype=torch.float32, tp=tp))
    specs = lm.param_pspecs(cfg, tp)
    size = shape[0] * shape[1]
    meshes = [mesh_mod.Mesh(("data", "model"), dict(zip(("data", "model"),
                                                        shape)),
                            r, torch.device("cpu"), {}, "gloo", "send_recv")
              for r in range(size)]
    shards = [mesh_mod.shard_params(full, specs, m, "cpu") for m in meshes]
    for (path, x), (_, spec) in zip(sorted_leaves(full),
                                    sorted_leaves(specs)):
        rebuilt = np.zeros_like(x)
        hits = np.zeros(x.shape, np.int32)
        for m, sh in zip(meshes, shards):
            part = dict(sorted_leaves(sh))[path]
            assert part.is_contiguous()
            assert tuple(part.shape) == mesh_mod.local_shape(x.shape, spec, m)
            idx = mesh_mod.local_index(x.shape, spec, m)
            rebuilt[idx] = part.numpy()
            hits[idx] += 1
        np.testing.assert_array_equal(rebuilt, x, err_msg=str(path))
        n_parts = int(np.prod([m.axis_size(e) for e in spec
                               if e is not None]))
        assert (hits == size // n_parts).all(), path


@pytest.fixture
def one_rank_world(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_checks_raise(one_rank_world, monkeypatch):
    """No quiet fallback: a world of the wrong size, unknown axes, gloo for
    card tensors with a card a rank, and a backend that serves no CPU
    tensors, each raise; a CPU mesh over gloo builds."""
    m = mesh_mod.make_mesh((1, 1), device="cpu")
    assert m.backend == "gloo" and m.p2p == "send_recv"
    assert m.coords == {"data": 0, "model": 0}
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh_mod.make_mesh((1, 2), device="cpu")
    with pytest.raises(ValueError, match="mesh axes"):
        mesh_mod.make_mesh((1, 1), ("model", "data"), device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs nccl"):
        mesh_mod.make_mesh((1, 1), device="cuda:0")
    monkeypatch.setattr(mesh_mod, "_backends", lambda: {"cpu": "mpi"})
    with pytest.raises(RuntimeError, match="needs gloo"):
        mesh_mod.make_mesh((1, 1), device="cpu")


def test_make_mesh_needs_a_world():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized default process"):
        mesh_mod.make_mesh((1, 1), device="cpu")
