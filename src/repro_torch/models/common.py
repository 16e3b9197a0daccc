"""Shared model building blocks: the reference's ``models/common.py`` in
PyTorch.

Parameters are nested dicts (and lists) of tensors, with the reference's
names and its stacking of layers on axis 0.  Randomness comes from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def rms_norm(x, gamma, eps: float = 1e-6):
    xf = x.float()
    nrm = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (nrm * gamma.float()).to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


def xla_sigmoid(x):
    """The reference's sigmoid as XLA expands it: ``1 / (1 + exp(-x))``, op
    by op in ``x``'s dtype (``torch.sigmoid`` rounds bf16 differently)."""
    return 1 / (1 + torch.exp(-x))


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: down( silu(x@gate) * (x@up) )."""
    return (silu(x @ w_gate) * (x @ w_up)) @ w_down


# ------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float):
    """float64 numpy, as the reference computes them (callers cast)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, d). positions: broadcastable to (..., S).  The head
    splits in halves (not interleaved)."""
    freqs = _rope_table(x.shape[-1], float(theta), x.device)
    angles = positions[..., None].float() * freqs  # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_table(head_dim: int, theta: float, device: torch.device):
    """``rope_freqs`` as float32 on ``device``, copied there once: a copy
    from pageable host memory in every call would wait for the device's
    queue each time."""
    return torch.as_tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                           device=device)


# ------------------------------------------------------------------- init
# float32 elements of one draw (1 GiB): a larger leaf is drawn in slices
DRAW_ELEMS = 1 << 28


def normal_init(gen: torch.Generator, shape, scale: float, dtype):
    """``scale * N(0, 1)`` drawn in float32 on the generator's device, then
    cast to ``dtype``.  A leaf of more than ``DRAW_ELEMS`` elements is
    drawn in slices of whole rows of its last axis, each cast into place,
    so the float32 transient stays near ``DRAW_ELEMS`` elements
    (deepseek-v3's routed bank, 256 x 7168 x 2048, would take 15 GB
    whole)."""
    shape = tuple(shape)
    n = int(np.prod(shape))
    chunk = DRAW_ELEMS
    if n <= chunk or not shape:
        return (torch.randn(shape, generator=gen, device=gen.device,
                            dtype=torch.float32) * scale).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = out.view(-1, shape[-1])
    step = max(1, chunk // shape[-1])
    for i in range(0, rows.shape[0], step):
        part = rows[i:i + step]
        part.copy_(torch.randn(part.shape, generator=gen, device=gen.device,
                               dtype=torch.float32) * scale)
    return out


class Spec(tuple):
    """A sharding spec, the port's ``PartitionSpec``: one entry per leading
    dimension, each ``None`` (not split), a mesh axis name, or a tuple of
    axis names (split over their product, the first axis major); missing
    trailing entries are ``None``.  A tree of specs has the parameter
    tree's structure, and the tree functions here take a spec as a leaf."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def tree_leaves(tree):
    """The tensors of a nested dict/list/tuple tree, in order (None is an
    empty subtree)."""
    if isinstance(tree, Spec):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def sorted_leaves(tree, path=()):
    """``[(path, leaf)]`` in the order of the reference's
    ``jax.tree.flatten``: dict keys sorted, lists in order, None an empty
    subtree; ``path`` is the keys and indices down to the leaf."""
    if isinstance(tree, Spec):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in sorted_leaves(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in sorted_leaves(v, path + (i,))]
    return [] if tree is None else [(path, tree)]


def tree_from_sorted_leaves(tree, leaves):
    """``tree``'s structure (its dict keys in their order) with its leaves
    replaced by ``leaves``, given in :func:`sorted_leaves` order: the
    inverse of flattening, as the reference's ``tree_unflatten``."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            new = {k: walk(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return None if t is None else next(it)

    out = walk(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, which share its
    structure), keeping the structure; None stays None."""
    if isinstance(tree, Spec):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def count_params(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))
