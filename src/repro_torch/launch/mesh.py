"""Meshes of ranks and sharding specs: the reference's ``launch/mesh.py``
in PyTorch.

A mesh is a ``torch.distributed`` world laid out over up to three named
axes, ``("data", "model")`` or ``("pod", "data", "model")``, row-major
(the last axis fastest: rank ``r`` of a ``(D, M)`` mesh is ``(d, m) =
divmod(r, M)``, as ``core/sharded_kvs.py``'s ``RankMesh``).  Each rank runs
its own share of the program; where the reference's GSPMD inserts a
collective, the port calls one of :class:`Mesh`'s, over the process group
of the ranks that differ only along the named axes (a group's ranks in
ascending order, so a group over ``("pod", "data")`` is pod-major, as
``PartitionSpec(("pod", "data"))`` lays a dimension out).  Collectives
over axes of size 1 are skipped.  Every collective counts its calls, its
bytes (what this rank puts in) and its host seconds by dtype in
:attr:`Mesh.stats`, as ``ops.LAUNCHES`` counts kernel launches; the host
time of a collective on card tensors includes the wait for the device to
produce its input (gloo copies it to the host first).

Backends.  A mesh of card tensors needs NCCL, except that gloo is
accepted when the world has more ranks than the host has cards (NCCL
refuses two ranks on one device); a CPU mesh needs gloo.  Any other
pairing raises, and nothing switches backend on its own.  gloo serves
``all_reduce`` and ``all_gather`` of card tensors by staging them through
host memory, but not ``send``/``recv`` (its TCP pair writes from the
device pointer and aborts the process), so on such a mesh
:meth:`Mesh.ppermute` is an ``all_gather`` within the axis's group
(``p2p == "all_gather"``); elsewhere it is ``batch_isend_irecv``.

Specs are :class:`~repro_torch.models.common.Spec` tuples.
:func:`shard_params` is the port's ``device_put`` with a
``NamedSharding``: each rank keeps the contiguous slice its spec names;
:func:`gather_params` is its inverse.  ``copy_to`` and ``reduce_from``
are Megatron's pair of autograd functions: the identity with a ``psum``
in the backward where a replicated activation enters split weights, and
a ``psum`` with the identity backward after a split product.

:func:`make_meta_mesh` is the dry run's stand-in (``launch/dryrun.py``):
one rank of a production mesh with no process group, whose collectives
return ``meta`` tensors of the real shapes and record each call.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.outback import resolve_device
from repro_torch.core.sharded_kvs import _BACKEND_OF, _backends
from repro_torch.models.common import Spec, tree_map

AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")
BATCH_AXES = ("pod", "data")


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """This rank's view of a mesh of ranks.

    ``axis_names`` the axes in order, ``shape`` ``{axis: size}``,
    ``coords`` ``{axis: this rank's index}``, ``device`` its device,
    ``backend`` what serves its tensors, ``p2p`` how :meth:`ppermute`
    moves them, ``stats`` ``{(op, axes, dtype): [calls, bytes, host
    seconds]}``."""

    def __init__(self, axis_names, shape: dict, rank: int, device,
                 groups: dict, backend: str, p2p: str):
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(shape[a]) for a in self.axis_names}
        self.rank = int(rank)
        self.device = device
        self.groups = dict(groups)
        self.backend = backend
        self.p2p = p2p
        self.coords = {}
        rest = self.rank
        for a in reversed(self.axis_names):
            rest, self.coords[a] = divmod(rest, self.shape[a])
        self.stats = defaultdict(lambda: [0, 0, 0.0])

    # ---- layout
    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (one name or a tuple: the
        first axis major); an axis the mesh lacks has size 1."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.shape.get(a, 1) + self.coords.get(a, 0)
        return idx

    def axis_size(self, axes) -> int:
        return int(np.prod([self.shape.get(a, 1) for a in _axes(axes)]))

    def _group(self, axes):
        axes = tuple(a for a in self.axis_names if a in _axes(axes)
                     and self.shape[a] > 1)
        return axes, self.groups.get(axes)

    def _count(self, op: str, axes, x: torch.Tensor, t0: float) -> None:
        rec = self.stats[(op, "+".join(axes), str(x.dtype).split(".")[-1])]
        rec[0] += 1
        rec[1] += x.numel() * x.element_size()
        rec[2] += time.perf_counter() - t0

    def reset_stats(self) -> None:
        self.stats.clear()

    def stats_json(self) -> dict:
        """``{"op/axes/dtype": {"calls": n, "bytes": b, "s": host
        seconds}}``."""
        return {"/".join(k): dict(calls=v[0], bytes=v[1], s=v[2])
                for k, v in sorted(self.stats.items())}

    # ---- collectives (each a no-op over axes of size 1)
    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axes`` (a new tensor)."""
        axes, group = self._group(axes)
        if not axes:
            return x
        t0 = time.perf_counter()
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        self._count("psum", axes, x, t0)
        return y

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes, group = self._group(axes)
        if not axes:
            return x
        t0 = time.perf_counter()
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
        self._count("pmax", axes, x, t0)
        return y

    def pmean(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self.psum(x, axes) / self.axis_size(axes)

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` along ``axes``, concatenated on ``dim`` in
        axis order."""
        axes, group = self._group(axes)
        if not axes:
            return x
        t0 = time.perf_counter()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.axis_size(axes))]
        dist.all_gather(parts, x, group=group)
        self._count("all_gather", axes, x, t0)
        return torch.cat(parts, dim=dim)

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        """``jax.lax.ppermute`` over one axis: ``perm`` lists ``(source,
        destination)`` indices along ``axis``; the result is the ``x`` of
        the rank that sends here, or zeros where none does."""
        axes, group = self._group(axis)
        if not axes:
            return x if (0, 0) in perm else torch.zeros_like(x)
        t0 = time.perf_counter()
        me = self.coords[axis]
        src = [s for s, d in perm if d == me]
        dst = [d for s, d in perm if s == me]
        x = x.contiguous()
        if self.p2p == "all_gather":
            parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
            dist.all_gather(parts, x, group=group)
            out = parts[src[0]] if src else torch.zeros_like(x)
        else:
            out = torch.zeros_like(x)
            ranks = dist.get_process_group_ranks(group)
            ops_ = [dist.P2POp(dist.isend, x, ranks[d], group) for d in dst]
            ops_ += [dist.P2POp(dist.irecv, out, ranks[s], group)
                     for s in src]
            for w in dist.batch_isend_irecv(ops_):
                w.wait()
        self._count("ppermute", axes, x, t0)
        return out

    # ---- Megatron's pair (autograd)
    def copy_to(self, x: torch.Tensor, axes="model") -> torch.Tensor:
        """The identity; its backward sums the gradient over ``axes``."""
        if not self._group(axes)[0]:
            return x
        return _CopyTo.apply(x, self, axes)

    def reduce_from(self, x: torch.Tensor, axes="model") -> torch.Tensor:
        """``psum`` over ``axes``; its backward is the identity."""
        if not self._group(axes)[0]:
            return x
        return _ReduceFrom.apply(x, self, axes)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.psum(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


# ---------------------------------------------------------------------------
# building a mesh


def make_mesh(axis_shapes, axis_names=AXES_2D, *, device=None) -> Mesh:
    """A mesh over the initialized default process group, whose world size
    must be the product of ``axis_shapes``.  Every rank must call it with
    the same arguments: it creates one group for each set of ranks that
    differ only along a subset of the axes, in one order.

    ``device=None`` means CUDA (``cuda:<rank % cards>``, made current) and
    raises without a card; pass ``device="cpu"`` for CPU ranks.  The
    group's backend must serve the device's tensors: NCCL for CUDA (gloo
    only when the world has more ranks than there are cards), gloo for
    the CPU."""
    axis_names = tuple(axis_names)
    if axis_names not in (AXES_2D, AXES_3D):
        raise ValueError(f"mesh axes must be {AXES_2D} or {AXES_3D}, got "
                         f"{axis_names}")
    sizes = tuple(int(s) for s in axis_shapes)
    if len(sizes) != len(axis_names) or min(sizes) < 1:
        raise ValueError(f"mesh shape {sizes} does not fit axes {axis_names}")
    device = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != int(np.prod(sizes)):
        raise ValueError(f"mesh {sizes} needs {int(np.prod(sizes))} ranks, "
                         f"the process group has {world}")
    want = _BACKEND_OF.get(device.type)
    have = _backends().get(device.type)
    if device.type == "cuda" and have == "gloo" \
            and world > torch.cuda.device_count():
        want = "gloo"  # more ranks than cards: NCCL cannot serve them
    if want is None or have != want:
        raise RuntimeError(
            f"the process group serves {device.type} tensors with "
            f"{have or 'no backend'}; the mesh needs {want or 'cpu or cuda'}"
            f" (init_process_group('cpu:gloo,cuda:nccl') serves both; gloo "
            f"serves card tensors only for more ranks than cards)")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    shape = dict(zip(axis_names, sizes))
    coords = Mesh(axis_names, shape, rank, device, {}, have, "").coords
    groups = {}
    for n in range(1, len(axis_names) + 1):
        for sub in itertools.combinations(axis_names, n):
            if any(shape[a] == 1 for a in sub):
                continue
            fixed = [a for a in axis_names if a not in sub]
            for vals in itertools.product(*(range(shape[a]) for a in fixed)):
                at = dict(zip(fixed, vals))
                ranks = [r for r in range(world)
                         if all(_coords_of(r, axis_names, sizes)[a] == v
                                for a, v in at.items())]
                g = dist.new_group(ranks)
                if all(coords[a] == v for a, v in at.items()):
                    groups[sub] = g
    p2p = "all_gather" if (device.type == "cuda" and have == "gloo") \
        else "send_recv"
    return Mesh(axis_names, shape, rank, device, groups, have, p2p)


def _coords_of(rank: int, axis_names, sizes) -> dict:
    out = {}
    for a, s in zip(reversed(axis_names), reversed(sizes)):
        rank, out[a] = divmod(rank, s)
    return out


PRODUCTION_SHAPES = {False: ((16, 16), AXES_2D),
                     True: ((2, 16, 16), AXES_3D)}


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's ``(16, 16)`` mesh, or ``(2, 16, 16)`` over pods
    (``PRODUCTION_SHAPES``): a world of 256 or 512 ranks."""
    return make_mesh(*PRODUCTION_SHAPES[multi_pod], device=device)


def make_debug_mesh(data: int = 1, model: int = 1, *, device=None) -> Mesh:
    return make_mesh((data, model), AXES_2D, device=device)


# ---------------------------------------------------------------------------
# the dry run's stand-in


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective a :class:`MetaMesh` rank called: ``op`` (``psum``,
    ``pmax``, ``all_gather``, ``ppermute``), the axes of size above 1 it
    ran over (``+``-joined), the shape and dtype this rank put in, and the
    bytes in and out."""

    op: str
    axes: str
    shape: tuple
    dtype: str
    in_bytes: int
    out_bytes: int


class MetaMesh(Mesh):
    """One rank of a mesh, with no process group: the dry run's stand-in
    for a world of 256 or 512 ranks (``launch/dryrun.py``).  It has the
    rank's coordinates and runs the same torch ops around each collective
    as :class:`Mesh` does with ``p2p == "send_recv"`` (one rank a card over
    NCCL: the copy a ``psum`` reduces into, the parts an ``all_gather``
    concatenates, the zeros a ``ppermute`` receives into); only the
    transfer is missing, so a result has the real collective's shape and
    dtype and no values.  Each call is counted in :attr:`stats` as
    :meth:`Mesh._count` counts it, with 0 host seconds, and recorded in
    order in :attr:`records` (:class:`Collective`).  A tensor that is not
    on ``meta`` raises: a stand-in that returned values would return wrong
    ones."""

    def __init__(self, axis_names, shape: dict, rank: int):
        super().__init__(axis_names, shape, rank, torch.device("meta"), {},
                         "meta", "send_recv")
        self.records: list[Collective] = []

    def _meta(self, op: str, axes, x: torch.Tensor):
        if not (isinstance(x, torch.Tensor) and x.is_meta):
            raise ValueError(f"MetaMesh.{op} takes meta tensors, got "
                             f"{getattr(x, 'device', type(x).__name__)}")
        axes, _ = self._group(axes)
        return axes

    def _record(self, op: str, axes, x: torch.Tensor, out_bytes: int):
        n = x.numel() * x.element_size()
        dtype = str(x.dtype).split(".")[-1]
        self.records.append(Collective(op, "+".join(axes), tuple(x.shape),
                                       dtype, n, out_bytes))
        rec = self.stats[(op, "+".join(axes), dtype)]
        rec[0] += 1
        rec[1] += n

    def _reduce(self, op: str, x: torch.Tensor, axes) -> torch.Tensor:
        axes = self._meta(op, axes, x)
        if not axes:
            return x
        y = x.contiguous().clone()
        self._record(op, axes, x, y.numel() * y.element_size())
        return y

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._reduce("psum", x, axes)

    def pmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        return self._reduce("pmax", x, axes)

    def all_gather(self, x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
        axes = self._meta("all_gather", axes, x)
        if not axes:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.axis_size(axes))]
        y = torch.cat(parts, dim=dim)
        self._record("all_gather", axes, x, y.numel() * y.element_size())
        return y

    def ppermute(self, x: torch.Tensor, axis: str, perm) -> torch.Tensor:
        axes = self._meta("ppermute", axis, x)
        if not axes:
            return x if (0, 0) in perm else torch.zeros_like(x)
        x = x.contiguous()
        out = torch.zeros_like(x)
        self._record("ppermute", axes, x, out.numel() * out.element_size())
        return out


def make_meta_mesh(*, multi_pod: bool = False, rank: int = 0,
                   axis_shapes=None) -> MetaMesh:
    """Rank ``rank`` of the production mesh (``PRODUCTION_SHAPES``:
    ``(16, 16)``, or ``(2, 16, 16)`` over pods), as a :class:`MetaMesh`;
    ``axis_shapes`` gives another shape over the same axes (``(1, 1)``:
    the program of one rank alone)."""
    sizes, names = PRODUCTION_SHAPES[multi_pod]
    sizes = tuple(int(s) for s in (axis_shapes or sizes))
    if len(sizes) != len(names) or min(sizes) < 1:
        raise ValueError(f"mesh shape {sizes} does not fit axes {names}")
    if not 0 <= rank < int(np.prod(sizes)):
        raise ValueError(f"rank {rank} is not in a mesh of {sizes}")
    return MetaMesh(names, dict(zip(names, sizes)), rank)


def neighbour(mesh: Mesh, axis: str) -> int:
    """The rank one step along ``axis`` from ``mesh``'s rank (wrapping)."""
    coords = dict(mesh.coords)
    coords[axis] = (coords[axis] + 1) % mesh.shape[axis]
    rank = 0
    for a in mesh.axis_names:
        rank = rank * mesh.shape[a] + coords[a]
    return rank


# ---------------------------------------------------------------------------
# specs


def expand_pod(spec: Spec) -> Spec:
    """Rewrite a ('data','model') spec for a ('pod','data','model') mesh:
    every 'data' entry becomes ('pod','data') so the batch dims span both
    pods."""
    out = []
    for entry in spec:
        if entry == "data":
            out.append(("pod", "data"))
        elif isinstance(entry, tuple) and "data" in entry:
            flat = []
            for e in entry:
                flat.extend(["pod", "data"] if e == "data" else [e])
            out.append(tuple(flat))
        else:
            out.append(entry)
    return Spec(*out)


def tree_expand_pod(spec_tree):
    return tree_map(expand_pod, spec_tree)


def shardings_for(mesh, spec_tree):
    """The specs as ``mesh`` lays them out: expanded over pods on a mesh
    with a ``pod`` axis (what :func:`shard_params` reads)."""
    return tree_expand_pod(spec_tree) if "pod" in mesh.axis_names \
        else spec_tree


def local_index(shape, spec: Spec, mesh) -> tuple:
    """The slices of a ``shape`` array that this rank of ``mesh`` holds
    under ``spec``: each split dimension cut into equal contiguous parts,
    the part at the rank's index along the entry's axes."""
    idx = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            idx.append(slice(None))
            continue
        n = mesh.axis_size(entry)
        if dim % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not split "
                             f"over {entry} ({n} ranks)")
        k = mesh.axis_index(entry)
        idx.append(slice(k * (dim // n), (k + 1) * (dim // n)))
    return tuple(idx)


def local_shape(shape, spec: Spec, mesh) -> tuple:
    return tuple(len(range(*s.indices(d))) for s, d in
                 zip(local_index(shape, spec, mesh), shape))


def local_slice(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's slice of ``x``, as a contiguous tensor of its own."""
    return x[local_index(x.shape, spec, mesh)].clone(
        memory_format=torch.contiguous_format)


def shard_params(full_tree, spec_tree, mesh, device=None, *, dtype=None):
    """A tree of host arrays (numpy, the reference's layout; bf16 taken by
    its bits) to this rank's shards on ``device`` (the mesh's unless
    given): each leaf's slice under its spec, contiguous; ``dtype`` casts
    every leaf."""
    from repro_torch.models.lm import _tensor_from_numpy
    device = mesh.device if device is None else resolve_device(device)

    def put(a, spec):
        part = np.asarray(a)[local_index(np.shape(a), spec, mesh)]
        t = _tensor_from_numpy(np.ascontiguousarray(part))
        return t.to(device=device, dtype=dtype or t.dtype).contiguous()

    return tree_map(put, full_tree, spec_tree)


def gather_params(local_tree, spec_tree, mesh):
    """The inverse of :func:`shard_params`: every leaf whole, on every
    rank (gathered along each split dimension in turn)."""
    def whole(x, spec):
        for i, entry in enumerate(spec):
            if entry is not None:
                x = mesh.all_gather(x, entry, dim=i)
        return x

    return tree_map(whole, local_tree, spec_tree)
