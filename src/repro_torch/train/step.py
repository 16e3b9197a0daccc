"""The train step builder: the reference's ``train/step.py`` in PyTorch.

Composition per step:
  1. (optional) gradient accumulation over microbatches, in float32;
  2. loss and gradients of the model's ``train_loss`` (remat per group of
     layers inside), by ``torch.autograd.grad`` over the parameter leaves;
  3. over a mesh (``launch/mesh.py``), the gradients summed over the
     batch axes and divided by their size (each rank's loss is the mean
     over its share of the batch), then, with ZeRO-1, each rank's slice;
  4. (optional, multi-pod) the int8 inter-pod gradient exchange with error
     feedback (:func:`_int8_pod_exchange`): only int8 values and one
     float32 scale a leaf cross the ``pod`` axis;
  5. the AdamW update (``train.optimizer``), its clip reading the norm of
     the whole gradient, then the updated slices gathered over the ZeRO
     axes.

``make_train_step(..., inplace=True)`` is the counterpart of the
reference's ``jax.jit(step, donate_argnums=0)``: the step writes the new
state into the old state's tensors, so one state is alive at a time.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import (sorted_leaves, tree_from_sorted_leaves,
                                       tree_map)
from repro_torch.models.lm import LM
from repro_torch.train.optimizer import (TrainState, adamw_leaf,
                                         adamw_scalars, adamw_update,
                                         global_norm, leaf_order, sum_squares,
                                         zero_axes, zero_slice)


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


def _int8_pod_exchange(grads, ef, npods: int, mesh, max_axes=None, *,
                       inplace: bool = False):
    """Quantized inter-pod all-reduce with error feedback, the reference's
    function as this rank's program.  Per leaf, in float32: ``g + e``, a
    scale ``max(max|g| / 127, 1e-12)``, ``q = clip(round(g / scale), -127,
    127)`` as int8 (``round`` is half to even, as ``jnp.round``), the new
    residual ``g - q * scale``, then for each hop the peer's ``q`` and
    scale moved over the ``pod`` axis and summed in the reference's hop
    order, then ``/ npods``.  ``max_axes`` maps a leaf's path to the axes
    over which its max is taken (the ranks holding parts of it).  With
    ``inplace`` the new residual is written into ``ef``'s own leaves."""
    def one(path, g, e):
        g = g.float() + e
        amax = torch.max(torch.abs(g))
        if max_axes is not None:
            amax = mesh.pmax(amax, max_axes(path))
        scale = torch.clamp(amax / 127.0, min=1e-12)
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        new_e = (torch.sub(g, q.float() * scale, out=e) if inplace
                 else g - q.float() * scale)
        total = q.float() * scale
        for hop in range(1, npods):
            perm = [(i, (i + hop) % npods) for i in range(npods)]
            q_peer = mesh.ppermute(q, "pod", perm)
            s_peer = mesh.ppermute(scale, "pod", perm)
            total = total + q_peer.float() * s_peer
        return total / npods, new_e

    out = [one(path, g, e) for (path, g), (_, e) in zip(
        sorted_leaves(grads), sorted_leaves(ef))]
    return (tree_from_sorted_leaves(grads, [o[0] for o in out]),
            tree_from_sorted_leaves(ef, [o[1] for o in out]))


def make_train_step(model: LM, tcfg: TrainConfig, *, mesh=None,
                    inplace: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    holds (B, S) ``tokens`` and ``labels`` (numpy arrays or tensors) of
    this rank's share of the batch, moved to the model's device.  ``mesh``
    (the model's unless given) is a ``launch.mesh.Mesh``; a mesh-like
    object that is not one is taken only when each of its axes has one
    rank.

    The step is functional by default: it returns a new state and leaves
    the one it was given as it was.  With ``inplace`` it writes the new
    state into the given one (each leaf keeps its storage) and returns that
    same :class:`TrainState`, bit for bit the functional step's.  A caller
    that passes a state to an in-place step must not read the old values
    afterwards, as the reference's donated buffers are invalid after the
    call.  Over a mesh it goes leaf by leaf: the rank's ZeRO-1 slice of
    the leaf is updated with its ``m`` and ``v``, gathered over the ZeRO
    axes into one temporary and copied into the leaf, so the step holds
    one leaf's gather beside the state, not a second parameter tree."""
    loss_fn = make_loss_fn(model)
    mesh = model.mesh if mesh is None else mesh
    if mesh is not None and not isinstance(mesh, Mesh):
        if any(int(n) > 1 for n in dict(mesh.shape).values()):
            raise TypeError("a train step over more than one rank needs a "
                            "repro_torch.launch.mesh.Mesh")
        mesh = None
    npods = mesh.shape.get("pod", 1) if mesh is not None else 1
    use_compress = tcfg.grad_compression == "int8" and npods > 1
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
                for (_, a), (_, b) in zip(sorted_leaves(g_acc),
                                          sorted_leaves(g)):
                    a += b.float()
                del g
                l_acc = l_acc + loss
            inv = 1.0 / tcfg.microbatch
            return tree_map(lambda x: x.mul_(inv), g_acc), l_acc * inv
        loss, g = value_and_grad(loss_fn, params, batch)
        return g, loss

    def plain_step(state: TrainState, batch):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        g, loss = grads_of(state.params, batch)
        if inplace:
            gnorm = global_norm(g)
            box = [g]  # the update frees each gradient leaf once used
            del g
            adamw_update(tcfg, state, box.pop(), gnorm=gnorm, inplace=True)
            return state, {"loss": loss, "gnorm": gnorm,
                           "step": state.step.clone()}
        new_state = adamw_update(tcfg, state, g)
        return new_state, {"loss": loss, "gnorm": global_norm(g),
                           "step": new_state.step}

    if mesh is None:
        return plain_step

    # ---- over a mesh: batch-axis sums, ZeRO-1 slices, the pod exchange ---
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    sum_axes = ("data",) if use_compress else batch_axes
    z_axes = zero_axes(mesh, use_compress)
    specs = dict(sorted_leaves(model.pspecs()))

    def model_split(path) -> bool:
        return any(e == "model" or (isinstance(e, tuple) and "model" in e)
                   for e in specs[path])

    def zdim(p, m):
        """The dimension on which the state slices the leaf, or None."""
        diff = [i for i, (a, b) in enumerate(zip(p.shape, m.shape)) if a != b]
        return diff[0] if diff else None

    def whole_norm(grads, owners):
        """The norm of the whole gradient: the squares of each leaf's part
        summed over the ranks that hold its parts (``owners``), once."""
        by_axes = {}
        for path, x in sorted_leaves(grads):
            acc = by_axes.get(owners(path), 0.0)
            by_axes[owners(path)] = acc + sum_squares(x)
        return torch.sqrt(sum(mesh.psum(v, axes) if axes else v
                              for axes, v in by_axes.items()))

    def update_in_place(state: TrainState, g_z, dims, gnorm) -> None:
        """Each leaf in turn (``leaf_order``'s): its ZeRO-1 slice updated
        with the rank's ``m`` and ``v``, then gathered into one temporary
        and copied into the state's leaf (a leaf that is not sliced is
        updated where it lies); each gradient leaf is freed once used."""
        state.step.add_(1)
        scalars = adamw_scalars(tcfg, state.step, gnorm)
        g_leaves = [x for _, x in sorted_leaves(g_z)]
        del g_z
        leaves = list(zip(*([t for _, t in sorted_leaves(tree)] for tree in (
            state.params, state.m, state.v))))
        for i in leaf_order(g_leaves):
            p, m, v = leaves[i]
            box, g_leaves[i] = [g_leaves[i]], None
            p_z = zero_slice(p, dims[i], mesh, z_axes)
            adamw_leaf(tcfg, scalars, p_z, box.pop(), m, v, inplace=True)
            if dims[i] is not None:
                p.copy_(mesh.all_gather(p_z, z_axes, dim=dims[i]))
            del p_z

    def mesh_step(state: TrainState, batch):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        g, loss = grads_of(state.params, batch)
        leaves = sorted_leaves(state.params)
        dims = [zdim(p, m) for (_, p), (_, m) in
                zip(leaves, sorted_leaves(state.m))]
        # leaf by leaf, each summed and sliced leaf replacing the whole one
        n = mesh.axis_size(sum_axes)
        xs = [x for _, x in sorted_leaves(g)]
        del g
        for i, d in enumerate(dims):
            if n > 1:
                xs[i] = mesh.psum(xs[i], sum_axes) / n
            xs[i] = zero_slice(xs[i], d, mesh, z_axes)
        g_z = tree_from_sorted_leaves(state.params, xs)
        del xs
        loss = mesh.pmean(loss, batch_axes)
        sliced = {path: d is not None for (path, _), d in zip(leaves, dims)}

        def owners(path) -> tuple:
            """The axes over which the ranks hold distinct parts of a
            leaf's (sliced) gradient."""
            return ((z_axes if sliced[path] else ())
                    + (("model",) if model_split(path) else ()))

        ef = state.ef
        if use_compress:
            g_z, ef = _int8_pod_exchange(g_z, state.ef, npods, mesh,
                                         max_axes=owners, inplace=inplace)
        gnorm = whole_norm(g_z, owners)
        if inplace:
            box = [g_z]  # freed leaf by leaf inside
            del g_z
            update_in_place(state, box.pop(), dims, gnorm)
            return state, {"loss": loss, "gnorm": gnorm,
                           "step": state.step.clone()}
        params_z = tree_from_sorted_leaves(state.params, [
            zero_slice(p, d, mesh, z_axes) for (_, p), d in zip(leaves, dims)])
        box = [g_z]  # the update frees each gradient leaf once used
        del g_z
        new = adamw_update(tcfg, dataclasses.replace(
            state, params=params_z, ef=ef), box.pop(), gnorm=gnorm)
        params = tree_from_sorted_leaves(state.params, [
            p if d is None else mesh.all_gather(p, z_axes, dim=d)
            for (_, p), d in zip(sorted_leaves(new.params), dims)])
        new = dataclasses.replace(new, params=params)
        return new, {"loss": loss, "gnorm": gnorm, "step": new.step}

    return mesh_step
