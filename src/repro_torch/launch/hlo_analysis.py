"""Cost analysis of one rank's program: the reference's
``launch/hlo_analysis.py`` over the eager stream of aten ops.

The reference parses XLA's optimized HLO and multiplies each ``while``
body by its trip count, because XLA's ``cost_analysis`` counts a scanned
layer once.  The port has no HLO: :class:`CostMode` is a
``TorchDispatchMode`` that sees every aten op a program dispatches, on
any device (``meta`` for the dry run, ``cpu``, ``cuda``), after
autograd and the composite decompositions (``matmul``, ``einsum`` and
``linear`` arrive as ``mm`` / ``bmm``).  A Python layer loop dispatches
its ops once per trip, so there is no trip count to correct: a loop of
ten matmuls is counted ten times as it runs.  The rules are the
reference's (its lines 1-22, 47-66, 224-312), carried over to aten:

* FLOPs: a dot (``mm``, ``bmm``, ``addmm``, ``baddbmm``) is ``2 * output
  elements * contracted size`` (``addmm``'s and ``baddbmm``'s add one a
  output element on top, as the HLO's separate add); a convolution
  ``2 * output elements * kernel elements a output``; every pointwise op,
  reduction and dtype conversion one a output element; views, copies,
  gathers, scatters and allocations none.
* ``bytes_upper``: the operands plus the outputs of every op that is
  not a view or an allocation; a gather, index read or slice read
  counts 2x its output, an ``index_put`` / scatter / ``copy_`` 2x its
  update (the reference's gather, slice and dynamic-update-slice).
* ``bytes`` (the fused model, TPU-style fusion): the same, for the
  materializing ops only (the reference's ``_MATERIALIZING`` mapped to
  aten, :data:`MATERIALIZING`: dots, gathers, scatters, reductions,
  sorts, copies, concatenations, pads, random draws); chains of pointwise
  ops and dtype conversions between them are taken as fused, moving
  nothing.
* ``coll_bytes`` by the reference's kind names (``all-reduce``,
  ``all-gather``, ``collective-permute``): each collective's output
  bytes, from the records of the dry run's mesh stand-in
  (``launch/mesh.py::MetaMesh``); a collective also counts its operand
  and output bytes in ``bytes`` and ``bytes_upper``, as a materializing
  op of the reference's.
* A hand-written kernel is not an aten op: its wrapper
  (``kernels/ops.py``) reports its work to the active counter
  (:meth:`CostMode.kernel_call`), and the torch ops the wrapper runs
  itself (the plain version on the CPU, allocations on the card) are
  not counted, so a kernel's work counts the same on every device.
* Peak live bytes: each output's storage is added when it is created
  and freed by a finalizer on the storage; a storage counts once, since
  views share it, and a storage an op read or wrote in place (an
  argument's, ``mul_``'s, ``copy_``'s or an ``out=`` tensor's) is never
  new.  Tensors made before the counter started (the arguments) are not
  live bytes.

What differs from the reference: the fused model here assumes fusion of
pointwise chains that eager PyTorch does not fuse (``bytes_upper`` is
closer to what an eager step moves), and an op's FLOPs are its own, not
a fusion's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops

# the mesh's collectives (launch/mesh.py) by the reference's kind names
COLLECTIVE_KIND = {"psum": "all-reduce", "pmax": "all-reduce",
                   "all_gather": "all-gather",
                   "ppermute": "collective-permute"}

_DOT = {"mm", "bmm", "addmm", "baddbmm"}
# ops that only allocate, or alias what they take (views the ``is_view``
# flag does not mark): they count nothing
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "_reshape_alias", "as_strided",
         "lift_fresh", "detach", "alias", "set_", "resize_",
         "_local_scalar_dense", "arange", "scalar_tensor"}
# data movement: no FLOPs
_GATHER = {"index", "gather", "index_select", "embedding", "take",
           "_unsafe_index"}
_SCATTER = {"index_put", "index_put_", "_index_put_impl_", "scatter",
            "scatter_", "scatter_add", "scatter_add_", "index_add",
            "index_add_", "index_copy", "index_copy_", "slice_scatter",
            "select_scatter", "copy_"}
_MOVE = {"clone", "_to_copy", "cat", "stack", "constant_pad_nd", "repeat",
         "repeat_interleave", "flip", "roll", "sort", "topk", "nonzero",
         "nonzero_static", "select_backward", "slice_backward",
         "embedding_dense_backward", "one_hot", "tril", "triu", "contiguous",
         "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
         "full", "full_like", "new_full", "fill_", "zero_", "normal_",
         "uniform_", "randn", "rand", "randint", "randn_like", "rand_like",
         "bernoulli_"} | _GATHER | _SCATTER
# reductions (one FLOP a output element), named: torch's ``reduction``
# tag is not in every version, and does not mark the softmax family
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
           "var", "std", "var_mean", "std_mean", "norm",
           "linalg_vector_norm", "argmax", "argmin", "any", "all", "cumsum",
           "cumprod", "_softmax", "_log_softmax", "_softmax_backward_data",
           "_log_softmax_backward_data"}
_REDUCTION_TAG = getattr(torch.Tag, "reduction", None)
# the reference's _MATERIALIZING mapped to aten: dots, gathers, scatters,
# reductions, sorts, copies, concatenations, pads and random draws
MATERIALIZING = _DOT | {"convolution"} | _GATHER | _SCATTER | _REDUCE | {
    "sort", "topk", "clone", "_to_copy", "cat", "stack", "constant_pad_nd", "repeat",
    "repeat_interleave", "flip", "roll", "normal_", "uniform_", "randn",
    "rand", "randint", "bernoulli_", "nonzero", "nonzero_static",
    "embedding_dense_backward", "select_backward", "slice_backward"}


@dataclasses.dataclass
class HloCost:
    """The reference's cost record: FLOPs, the fused model's bytes, the
    op-materialized upper bound and the collectives' bytes by kind."""

    flops: float = 0.0
    bytes: float = 0.0
    bytes_upper: float = 0.0
    coll_bytes: dict = dataclasses.field(default_factory=dict)

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll_bytes.values()))


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _broadcast(shapes) -> tuple:
    out = []
    for dims in itertools.zip_longest(*(reversed(s) for s in shapes),
                                      fillvalue=1):
        big = {d for d in dims if d != 1}
        if len(big) > 1:
            raise ValueError(f"shapes {shapes} do not broadcast")
        out.append(big.pop() if big else 1)
    return tuple(reversed(out))


_MEMORY_FORMATS = (None, torch.contiguous_format, torch.preserve_format)


def meta_pointwise(func, args, kwargs):
    """The output of pointwise op ``func`` on meta tensors whose operands
    are all contiguous, without its meta kernel (torch's are Python and
    take about 200 us an op): the broadcast shape, contiguous, in the
    dtype the op gives one-element CPU stand-ins (an in-place op returns
    its first operand).  None where that rule does not cover the call
    (an operand not contiguous, a random op, a memory format): the caller
    runs the op itself."""
    if torch.Tag.pointwise not in func.tags \
            or torch.Tag.nondeterministic_seeded in func.tags \
            or kwargs.get("memory_format") not in _MEMORY_FORMATS \
            or "out" in kwargs:
        return None
    ts = _tensors((args, kwargs))
    if not ts or not all(t.is_meta and t.is_contiguous() for t in ts):
        return None
    small = lambda x: (torch.empty((1,) if x.dim() else (), dtype=x.dtype)
                       if isinstance(x, torch.Tensor) else x)
    try:
        shape = _broadcast([tuple(t.shape) for t in ts])
        probe = func(*[small(a) for a in args],
                     **{k: small(v) for k, v in kwargs.items()})
    except (RuntimeError, ValueError, TypeError):
        return None
    if func.overloadpacket.__name__.endswith("_"):  # in place
        return args[0] if tuple(args[0].shape) == shape else None
    return torch.empty(shape, dtype=probe.dtype, device="meta")


def dot_flops(name: str, args, out) -> float:
    """``2 * output elements * contracted size`` of a dot (the output's
    elements on top for ``addmm`` / ``baddbmm``'s add)."""
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    n = float(out.numel())
    f = 2.0 * n * a.shape[-1]
    return f + n if name in ("addmm", "baddbmm") else f


def _conv_flops(args, out) -> float:
    w = args[1]  # (out, in / groups, *kernel)
    return 2.0 * out.numel() * (w.numel() // w.shape[0])


class CostMode(TorchDispatchMode):
    """Counts the aten ops dispatched while it is active (``with
    CostMode(mesh=...) as c:``) under the module's rules: :attr:`cost`
    (an :class:`HloCost`), :attr:`dot_flops` (the dots alone, what
    ``FlopCounterMode`` counts), :attr:`kernels` (``{name: {"calls",
    "flops", "bytes"}}`` of the hand-written kernels' wrapper calls),
    :attr:`by_op` (``{aten name: [calls, flops, bytes, bytes_upper]}``)
    and :attr:`peak_live_bytes`.  ``mesh``: the ``MetaMesh`` whose
    collectives the program calls; its records from this run are counted
    on exit.  ``device``: the program's device type; an op that touches
    no tensor on it (the host's bookkeeping, such as a checkpoint's copy
    of the CPU random state in a program on the card) is not counted."""

    def __init__(self, mesh=None, device: str | None = None):
        super().__init__()
        self.device = device
        self.cost = HloCost()
        self.dot_flops = 0.0
        self.kernels: dict = {}
        self.by_op: dict = {}
        self.mesh = mesh
        self._rec0 = 0
        self._paused = 0
        self.live_bytes = 0.0
        self.peak_live_bytes = 0.0
        self._storages: dict = {}

    # ---- activation
    def __enter__(self):
        self._rec0 = len(getattr(self.mesh, "records", ()))
        ops.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        ops.COUNTERS.remove(self)
        for rec in getattr(self.mesh, "records", [])[self._rec0:]:
            self.collective(rec)
        self._rec0 = len(getattr(self.mesh, "records", ()))
        return out

    @contextlib.contextmanager
    def paused(self):
        """Nothing dispatched inside is counted."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # ---- what the wrappers and the mesh report
    def count_on_meta(self, fn, *args):
        """Count ``fn(*args)``'s aten ops as the program's, run on meta
        stand-ins of ``args`` (whatever the program's device): ops that a
        kernel's plain version computes inside its own call on the CPU,
        but the card's path dispatches as aten ops."""
        with self.paused():
            args = [a.to("meta") for a in args]
        device, self.device = self.device, None
        try:
            fn(*args)
        finally:
            self.device = device

    def kernel_call(self, name: str, flops: float, nbytes: float, fn, *args):
        """``fn(*args)``, a wrapper's call of hand-written kernel ``name``
        doing ``flops`` and moving ``nbytes``: counted as one call of that
        work (in ``bytes`` and ``bytes_upper``, as the reference counts a
        custom call), the torch ops inside not at all; its outputs are
        live bytes."""
        with self.paused():
            out = fn(*args)
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.cost.flops += flops
        self.cost.bytes += nbytes
        self.cost.bytes_upper += nbytes
        self._track(_tensors(out), ())
        return out

    def collective(self, rec) -> None:
        """A mesh record (``launch/mesh.py::Collective``): its output
        bytes under its kind, its operand and output bytes moved."""
        kind = COLLECTIVE_KIND[rec.op]
        self.cost.coll_bytes[kind] = self.cost.coll_bytes.get(kind, 0.0) \
            + rec.out_bytes
        moved = rec.in_bytes + rec.out_bytes
        self.cost.bytes += moved
        self.cost.bytes_upper += moved

    # ---- the dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = meta_pointwise(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        if func.is_view or name in _FREE:
            return
        ins = _tensors((args, {k: v for k, v in kwargs.items()
                               if k != "out"}))
        outs = _tensors(out)
        if self.device is not None and all(
                t.device.type != self.device for t in ins + outs):
            return
        out_b = sum(_nbytes(t) for t in outs)
        flops = 0.0
        if name in _DOT:
            flops = dot_flops(name, args, outs[0])
            self.dot_flops += flops - (outs[0].numel() if name in (
                "addmm", "baddbmm") else 0)
        elif name == "convolution":
            flops = _conv_flops(args, outs[0])
            self.dot_flops += flops
        elif name in ("_to_copy", "copy_"):
            src = args[1] if name == "copy_" else args[0]
            if src.dtype != outs[0].dtype:  # a convert: pointwise
                flops = float(outs[0].numel())
                name = "convert"
        elif name not in _MOVE and (
                torch.Tag.pointwise in func.tags or name in _REDUCE
                or _REDUCTION_TAG in func.tags):
            flops = float(sum(t.numel() for t in outs))
        if name in _GATHER:
            b = 2.0 * out_b
        elif name in _SCATTER:
            rest = _tensors(args[2:])
            upd = args[1] if name in ("copy_", "slice_scatter",
                                      "select_scatter") else (
                rest[-1] if rest else outs[0])
            b = 2.0 * _nbytes(upd)
        else:
            b = out_b + sum(_nbytes(t) for t in ins)
        self.cost.flops += flops
        self.cost.bytes_upper += b
        if name in MATERIALIZING:
            self.cost.bytes += b
        rec = self.by_op.setdefault(name, [0, 0.0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += b if name in MATERIALIZING else 0.0
        rec[3] += b
        # an ``out=`` tensor is written where it lies: no new storage
        self._track(outs, ins + _tensors(kwargs.get("out")))

    # ---- live bytes
    def _track(self, outs, ins) -> None:
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._storages:
                continue
            seen.add(key)
            n = float(st.nbytes())
            self._storages[key] = n
            self.live_bytes += n
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        n = self._storages.pop(key, None)
        if n is not None:
            self.live_bytes -= n

    def summary(self) -> dict:
        """The counts as plain numbers (JSON)."""
        return dict(flops=self.cost.flops, bytes=self.cost.bytes,
                    bytes_upper=self.cost.bytes_upper,
                    coll_bytes=dict(self.cost.coll_bytes),
                    dot_flops=self.dot_flops,
                    kernels={k: dict(v) for k, v in sorted(
                        self.kernels.items())},
                    peak_live_bytes=self.peak_live_bytes)

