"""AdamW + cosine schedule + the ZeRO-1 optimizer-state spec: the
reference's ``train/optimizer.py`` in PyTorch.

The update keeps the reference's float32 expressions in their order
(``b1 ** step``, ``mhat / (sqrt(vhat) + 1e-8) + wd * p``, the global-norm
clip scale), leaf for leaf over the parameter tree, and is functional as
there: it returns a new state and changes no tensor of the old one (a
restarted run replays from a saved state).  ``zero1_spec`` is a pure
function over spec tuples whose entries are ``None`` or ``"data"``, as
``PartitionSpec``'s; the mesh-bound ``state_pspecs`` and
``abstract_state`` come with the port's mesh launcher.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.common import (sorted_leaves, tree_from_sorted_leaves,
                                       tree_leaves, tree_map)


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


def init_state(params, *, compression: bool = False) -> TrainState:
    device = tree_leaves(params)[0].device
    return TrainState(params, _zeros_f32(params), _zeros_f32(params),
                      torch.zeros((), dtype=torch.int32, device=device),
                      _zeros_f32(params) if compression else None)


def zero1_spec(param_spec: tuple, shape: tuple, data_size: int) -> tuple:
    """Add 'data' sharding on the first free, divisible dim (ZeRO-1)."""
    spec = list(param_spec) + [None] * (len(shape) - len(param_spec))
    for i, (s, dim) in enumerate(zip(spec, shape)):
        if s is None and dim % max(data_size, 1) == 0 and dim >= data_size:
            spec[i] = "data"
            return tuple(spec)
    return tuple(spec)


def lr_schedule(cfg: TrainConfig, step):
    """Linear warm-up, then cosine decay to 0 at ``total_steps``: a float32
    tensor for an integer ``step`` (a tensor or an int)."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.learning_rate * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))


def global_norm(grads):
    """The float32 L2 norm over every leaf of ``grads``."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for _, g in sorted_leaves(grads)))


def adamw_update(cfg: TrainConfig, state: TrainState, grads) -> TrainState:
    """One AdamW step with global-norm clipping."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + 1e-8) + cfg.weight_decay * \
            p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(p, g, m, v) for (_, p), (_, g), (_, m), (_, v) in zip(
        sorted_leaves(state.params), sorted_leaves(grads),
        sorted_leaves(state.m), sorted_leaves(state.v))]
    new_p, new_m, new_v = (tree_from_sorted_leaves(t, [o[j] for o in out])
                           for j, t in enumerate((state.params, state.m,
                                                  state.v)))
    return dataclasses.replace(state, params=new_p, m=new_m, v=new_v,
                               step=step)
