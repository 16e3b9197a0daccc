"""The train step builder: the reference's ``train/step.py`` in PyTorch.

Composition per step:
  1. (optional) gradient accumulation over microbatches, in float32;
  2. loss and gradients of the model's ``train_loss`` (remat per group of
     layers inside), by ``torch.autograd.grad`` over the parameter leaves;
  3. the AdamW update (``train.optimizer``).

The multi-pod int8 gradient exchange (``grad_compression="int8"`` over a
mesh with a ``pod`` axis) needs the port's mesh launcher and raises
``NotImplementedError`` until then.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models.common import (sorted_leaves, tree_from_sorted_leaves,
                                       tree_map)
from repro_torch.models.lm import LM
from repro_torch.train.optimizer import TrainState, adamw_update, global_norm


def _split_microbatches(batch, n):
    return {k: x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))
            for k, x in batch.items()}


def make_loss_fn(model: LM):
    def loss_fn(params, batch):
        loss, metrics = model.train_loss(params, batch, remat=True)
        return loss, metrics
    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """-> (loss, grads): the loss detached and the gradient of every leaf
    of ``params`` (in its dtype), without touching the leaves' own
    ``requires_grad``."""
    leaves = [t.detach().requires_grad_(True)
              for _, t in sorted_leaves(params)]
    with torch.enable_grad():
        loss, _ = loss_fn(tree_from_sorted_leaves(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_from_sorted_leaves(params, grads)


def make_train_step(model: LM, tcfg: TrainConfig, *, mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds (B, S) ``tokens`` and ``labels`` (numpy arrays or tensors),
    moved to the model's device.  ``mesh``, if given, is read for its
    ``shape`` mapping (its ``pod`` axis) only."""
    loss_fn = make_loss_fn(model)
    npods = dict(getattr(mesh, "shape", {})).get("pod", 1) \
        if mesh is not None else 1
    if tcfg.grad_compression == "int8" and npods > 1:
        raise NotImplementedError(
            "the int8 inter-pod gradient exchange (grad_compression='int8' "
            f"over {npods} pods) is not yet ported: it needs the mesh")
    device = model.device

    def grads_of(params, batch):
        if tcfg.microbatch and tcfg.microbatch > 1:
            mbs = _split_microbatches(batch, tcfg.microbatch)
            g_acc = tree_map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=x.device), params)
            l_acc = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(tcfg.microbatch):
                loss, g = value_and_grad(loss_fn, params,
                                         {k: v[i] for k, v in mbs.items()})
                g_acc = tree_map(lambda a, b: a + b.float(), g_acc, g)
                l_acc = l_acc + loss
            inv = 1.0 / tcfg.microbatch
            return tree_map(lambda x: x * inv, g_acc), l_acc * inv
        loss, g = value_and_grad(loss_fn, params, batch)
        return g, loss

    def plain_step(state: TrainState, batch):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        g, loss = grads_of(state.params, batch)
        new_state = adamw_update(tcfg, state, g)
        return new_state, {"loss": loss, "gnorm": global_norm(g),
                           "step": new_state.step}

    return plain_step
