"""AdamW + cosine schedule + the ZeRO-1 optimizer-state spec: the
reference's ``train/optimizer.py`` in PyTorch.

The update keeps the reference's float32 expressions in their order
(``b1 ** step``, ``mhat / (sqrt(vhat) + 1e-8) + wd * p``, the global-norm
clip scale), leaf for leaf over the parameter tree, and is functional as
there by default: it returns a new state and changes no tensor of the old
one.  ``inplace=True`` writes the same values into the state's own
tensors, the counterpart of the reference's donated train state.
``zero1_spec`` and ``state_pspecs`` are pure functions over :class:`Spec`
trees, as the reference's over ``PartitionSpec``'s; ``abstract_state`` is
on the ``meta`` device.

ZeRO-1 at run time: over a mesh (``launch/mesh.py``) whose data axes
(:func:`zero_axes`) hold more than one rank, ``init_state`` gives each
rank the ``zero1_spec`` slice of ``m``, ``v`` and ``ef`` (of its own
shard of each parameter), and ``train.step`` updates the matching slice
of the parameter, then gathers it over those axes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.common import (Spec, sorted_leaves,
                                       tree_from_sorted_leaves, tree_leaves,
                                       tree_map)


@dataclasses.dataclass
class TrainState:
    params: Any
    m: Any
    v: Any
    step: torch.Tensor  # scalar int32, on the parameters' device
    ef: Any = None  # error-feedback residual (int8 grad compression)

    def tree(self):
        t = {"params": self.params, "m": self.m, "v": self.v,
             "step": self.step}
        if self.ef is not None:
            t["ef"] = self.ef
        return t


def _zeros_f32(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)


def zero_axes(mesh, compression: bool = False) -> tuple:
    """The mesh axes the optimizer state splits over (ZeRO-1): the batch
    axes, ``("pod", "data")`` or ``("data",)``; only ``data`` under the
    int8 pod exchange, which keeps the pods' states whole, as the
    reference's pod step does.  Empty when they hold one rank."""
    if mesh is None:
        return ()
    if compression and mesh.shape.get("pod", 1) > 1:
        axes = ("data",)
    else:
        axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if mesh.axis_size(axes) > 1 else ()


def zero_dim(param_spec, shape, size: int):
    """The dimension :func:`zero1_spec` splits over ``size`` ranks, or
    None."""
    spec = zero1_spec(param_spec, shape, size)
    return spec.index("data") if "data" in spec else None


def zero_slice(x: torch.Tensor, dim, mesh, axes) -> torch.Tensor:
    """This rank's part of ``x`` along ``dim`` over ``axes`` (``x`` itself
    when ``dim`` is None), a contiguous tensor of its own."""
    if dim is None:
        return x
    n = x.shape[dim] // mesh.axis_size(axes)
    return x.narrow(dim, mesh.axis_index(axes) * n, n).clone(
        memory_format=torch.contiguous_format)


def init_state(params, *, compression: bool = False, mesh=None, pspecs=None,
               zero1: bool = True) -> TrainState:
    """Zero moments (and ``ef``, the float32 error-feedback residual of
    the int8 exchange, with ``compression``); over ``mesh`` with
    ``zero1``, each rank's :func:`zero_dim` slice of them (``pspecs``:
    the parameters' spec tree)."""
    device = tree_leaves(params)[0].device
    axes = zero_axes(mesh, compression) if zero1 else ()

    def zeros(p, spec):
        shape = list(p.shape)
        d = zero_dim(spec, shape, mesh.axis_size(axes)) if axes else None
        if d is not None:
            shape[d] //= mesh.axis_size(axes)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    if axes:
        state_zeros = lambda: tree_map(zeros, params, pspecs)
    else:
        state_zeros = lambda: _zeros_f32(params)
    return TrainState(params, state_zeros(), state_zeros(),
                      torch.zeros((), dtype=torch.int32, device=device),
                      state_zeros() if compression else None)


def abstract_state(abstract_params, *, compression: bool = False
                   ) -> TrainState:
    """The state of ``abstract_params`` (meta tensors) on the ``meta``
    device: float32 moments (and ``ef``), an int32 step."""
    f32 = lambda x: torch.empty(x.shape, dtype=torch.float32, device="meta")
    return TrainState(abstract_params, tree_map(f32, abstract_params),
                      tree_map(f32, abstract_params),
                      torch.empty((), dtype=torch.int32, device="meta"),
                      tree_map(f32, abstract_params) if compression else None)


def zero1_spec(param_spec: tuple, shape: tuple, data_size: int) -> Spec:
    """Add 'data' sharding on the first free, divisible dim (ZeRO-1)."""
    spec = list(param_spec) + [None] * (len(shape) - len(param_spec))
    for i, (s, dim) in enumerate(zip(spec, shape)):
        if s is None and dim % max(data_size, 1) == 0 and dim >= data_size:
            spec[i] = "data"
            return Spec(*spec)
    return Spec(*spec)


def state_pspecs(param_pspecs, abstract_params, *, data_size: int,
                 zero1: bool = True, compression: bool = False) -> TrainState:
    """The state's spec tree: the parameters' specs, the moments' (and
    ``ef``'s) with ``zero1_spec``'s 'data' added."""
    if zero1:
        opt = tree_map(lambda sp, x: zero1_spec(sp, tuple(x.shape),
                                                data_size),
                       param_pspecs, abstract_params)
    else:
        opt = param_pspecs
    return TrainState(param_pspecs, opt, opt, Spec(),
                      opt if compression else None)


def lr_schedule(cfg: TrainConfig, step):
    """Linear warm-up, then cosine decay to 0 at ``total_steps``: a float32
    tensor for an integer ``step`` (a tensor or an int)."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.learning_rate * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """``sum(square(x.float()))`` with one float32 temporary of ``x``'s
    size (the square taken in place where ``float()`` made a copy)."""
    y = x.float()
    return torch.sum(torch.square(y) if y is x else y.square_())


def global_norm(grads):
    """The float32 L2 norm over every leaf of ``grads``."""
    return torch.sqrt(sum(sum_squares(g) for _, g in sorted_leaves(grads)))


def adamw_scalars(cfg: TrainConfig, step, gnorm) -> tuple:
    """-> (clip scale, learning rate, 1 - b1 ** step, 1 - b2 ** step) of
    the update that makes ``step`` (the advanced step) from a gradient of
    norm ``gnorm``."""
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, step)
    bc1 = 1.0 - cfg.b1 ** step.float()
    bc2 = 1.0 - cfg.b2 ** step.float()
    return scale, lr, bc1, bc2


def adamw_leaf(cfg: TrainConfig, scalars: tuple, p, g, m, v, *,
               inplace: bool = False) -> tuple:
    """One leaf's update -> (p, m, v): the reference's expressions, each op
    rounded as there, in two float32 scratch tensors (a 1.24e9-parameter
    model's update fits beside its state).  With ``inplace`` the new ``m``
    and ``v`` are written into ``m`` and ``v`` and the new parameter into
    ``p`` (``b1 * m + t`` as ``m.mul_(b1).add_(t)``, ``new.to(p.dtype)``
    as ``p.copy_(new)``: the same ops, so the same bits), and those
    tensors are returned; else three new tensors."""
    scale, lr, bc1, bc2 = scalars
    b1, b2 = cfg.b1, cfg.b2
    g = g.float() * scale
    t = g * (1 - b1)
    m = m.mul_(b1) if inplace else b1 * m
    m += t
    torch.square(g, out=t)
    torch.mul(t, 1 - b2, out=g)  # g is the scratch from here on
    v = v.mul_(b2) if inplace else b2 * v
    v += g
    torch.div(v, bc2, out=g)  # vhat
    g.sqrt_()
    g += 1e-8
    torch.div(m, bc1, out=t)  # mhat
    t /= g
    g.copy_(p)
    g *= cfg.weight_decay
    t += g  # delta
    t *= lr
    g.copy_(p)
    g -= t
    if inplace:
        return p.copy_(g), m, v
    return g.to(p.dtype), m, v


def leaf_order(leaves) -> list:
    """The order in which an update visits ``leaves``: the smallest first
    (ties in the tree's order), so the largest leaf's float32 scratch is
    made when the other gradient leaves have been used and freed.  Each
    leaf's update reads only its own leaves, so the order changes no
    value."""
    return sorted(range(len(leaves)), key=lambda i: leaves[i].numel())


def adamw_update(cfg: TrainConfig, state: TrainState, grads, *,
                 gnorm=None, inplace: bool = False) -> TrainState:
    """One AdamW step with global-norm clipping; ``gnorm``, when given, is
    the norm of the whole gradient (of which ``grads`` may be a rank's
    part).  Each gradient leaf is dropped once used, so a caller that
    passes ``grads`` without keeping it frees them one by one.

    Functional by default, as the reference's: a new state, the old one
    untouched.  With ``inplace`` the update writes ``params``, ``m`` and
    ``v`` into the state's own tensors and advances ``state.step`` in
    place, and returns ``state`` itself, bit for bit the functional
    step's: the counterpart of the reference's call sites, which donate
    the state to the jitted step.  The old values are gone then."""
    if gnorm is None:
        gnorm = global_norm(grads)
    step = state.step.add_(1) if inplace else state.step + 1
    scalars = adamw_scalars(cfg, step, gnorm)
    g_leaves = [g for _, g in sorted_leaves(grads)]
    del grads  # a leaf is freed once used when the caller holds no other
    leaves = list(zip(*([t for _, t in sorted_leaves(tree)] for tree in (
        state.params, state.m, state.v))))
    out = [None] * len(leaves)
    for i in leaf_order(g_leaves):
        box, g_leaves[i] = [g_leaves[i]], None
        out[i] = adamw_leaf(cfg, scalars, leaves[i][0], box.pop(),
                            *leaves[i][1:], inplace=inplace)
    if inplace:
        return state
    new_p, new_m, new_v = (tree_from_sorted_leaves(t, [o[j] for o in out])
                           for j, t in enumerate((state.params, state.m,
                                                  state.v)))
    return dataclasses.replace(state, params=new_p, m=new_m, v=new_v,
                               step=step)
