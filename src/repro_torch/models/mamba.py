"""Mamba (selective SSM) block, jamba's attention-free mixer: the
reference's ``models/mamba.py`` in PyTorch.

Train and prefill run the linear recurrence ``h_t = exp(dt_t A) h_{t-1} +
dt_t B_t x_t`` as the reference's ``jax.lax.associative_scan`` does: pair
up neighbours, recurse on the pairs, then fill in the rest (:func:`_scan`),
so the products are formed in the reference's order, in log2(S) rounds
and not a Python loop over S.  Decode carries the (B, d_inner, d_state)
float32 SSM state and a (B, d_conv-1, d_inner) conv tail, constant memory
a sequence.

The types are the reference's, by its promotion rules: ``dt`` is float32
(a bf16 product plus the float32 ``dt_bias``), ``A = -exp(A_log)`` is
float32, the scan and the decode state are float32, and ``y`` is cast to
the model's dtype before ``silu(z) * y``.  The depthwise conv sums its
``d_conv`` products in the model's dtype, op by op, and the sigmoid is
``1 / (1 + exp(-x))`` op by op: both are how XLA compiles the reference.
Where the compiled reference promotes a bf16 result to float32 straight
away, it reads the result before rounding (XLA's excess precision), and
so does the port: the conv's silu into the scan (train, prefill) and into
``D * x`` (decode), and decode's ``w_dt`` product into ``+ dt_bias``.
With these a bf16 step equals the jitted reference's bit for bit on its
output (``tests/test_torch_mamba.py``).  The RMSNorm -> ``w_in`` pair is
one ``ops.fused_norm_matmul`` launch of (d, 2 d_inner); ``w_bcdt``,
``w_dt`` and ``w_out`` are plain products, as they are outside Pallas in
the reference.

On a mesh (``mesh``, whose ``model`` axis splits ``d_inner``), the rank
runs its block of channels with the reference's specs unchanged.  Those
specs split ``w_in``'s 2 ``d_inner`` columns as one axis, so at tp = 2
rank 0's shard is all of ``x`` and rank 1's all of ``z``: no rank holds
both halves for its channels.  Gathering ``w_in`` would move 134 MB a
layer at jamba's width; the rank instead runs row 5 on its own shard and
the ranks exchange the (B, S, 2 d_inner / tp) outputs
(:class:`_ExchangeHalves`: an ``all_gather`` over ``model``, each rank
keeping its channels of ``x`` and of ``z``; the backward gathers the
halves' gradients and each rank keeps its shard's, a permutation with no
sum).  The conv, ``w_dt``, ``dt_bias``, ``A_log``, ``D``, the scan and
the cache are the rank's channels; ``xc @ w_bcdt`` is row-parallel, and
its psum makes B, C and the dt input replicated (they enter the rank's
channels through ``copy_to``); ``w_out`` is row-parallel too, its psum
the caller's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.common import xla_sigmoid


def mamba_params_shape(cfg):
    mc = cfg.mamba
    d = cfg.d_model
    di = mc.expand * d
    return {
        "w_in": (d, 2 * di),          # -> (x, z)
        "conv_w": (mc.d_conv, di),
        "conv_b": (di,),
        "w_bcdt": (di, 2 * mc.d_state + mc.dt_rank),
        "w_dt": (mc.dt_rank, di),
        "dt_bias": (di,),
        "A_log": (di, mc.d_state),
        "D": (di,),
        "w_out": (di, d),
    }


def silu(x):
    """``x * sigmoid(x)`` with the sigmoid as XLA expands the
    reference's."""
    return x * xla_sigmoid(x)


def _silu_f32(x):
    """:func:`silu` with its last product left in float32: rounded to
    ``x``'s dtype it is ``silu(x)``."""
    return x.float() * xla_sigmoid(x).float()


def softplus(x):
    """``jnp.logaddexp(x, 0)`` as the reference's ``jax.nn.softplus``
    computes it: ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _combine(left, right):
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along axis 1 (``even`` holds as many
    entries as ``odd`` or one more)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], dim=1) if even.shape[1] > n else out


def _scan(a, b):
    """Inclusive scan of ``(a, b)`` under :func:`_combine` along axis 1, in
    the recursion of ``jax.lax.associative_scan``."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                   (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        ev_a, ev_b = _combine((odd_a[:, :-1], odd_b[:, :-1]),
                              (a[:, 2::2], b[:, 2::2]))
    else:
        ev_a, ev_b = _combine((odd_a, odd_b), (a[:, 2::2], b[:, 2::2]))
    ev_a = torch.cat([a[:, :1], ev_a], dim=1)
    ev_b = torch.cat([b[:, :1], ev_b], dim=1)
    return _interleave(ev_a, odd_a), _interleave(ev_b, odd_b)


def _ssm_scan(x, dt, A, B, C, D):
    """Selective scan. x, dt (B,S,di); A (di,N); B, C (B,S,N).  Returns y
    and the last hidden state (B,di,N)."""
    Ab = torch.exp(dt[..., None] * A[None, None])            # (B,S,di,N)
    Bx = dt[..., None] * B[:, :, None, :] * x[..., None]     # (B,S,di,N)
    _, b_c = _scan(Ab, Bx)
    y = torch.einsum("bsdn,bsn->bsd", b_c, C) + D[None, None] * x
    return y, b_c[:, -1]


def _conv(rows, conv_w, conv_b, d_conv: int):
    """The causal depthwise conv: ``rows(i)`` is the input under tap i; the
    products summed in the reference's order, in their dtype."""
    acc = rows(0) * conv_w[0]
    for i in range(1, d_conv):
        acc = acc + rows(i) * conv_w[i]
    return acc + conv_b


class _ExchangeHalves(torch.autograd.Function):
    """The rank's columns of ``w_in``'s output (..., 2 di / tp) -> its
    channels' ``x`` and ``z`` (..., di / tp each), by an ``all_gather``
    over ``model``; the backward gathers every rank's (dx, dz) and keeps
    the gradient of this rank's columns."""

    @staticmethod
    def forward(ctx, xz, mesh):
        ctx.mesh = mesh
        tp, r = mesh.shape["model"], mesh.axis_index("model")
        full = mesh.all_gather(xz, "model", dim=-1)
        di = full.shape[-1] // 2
        w = di // tp
        return (full[..., r * w:(r + 1) * w].contiguous(),
                full[..., di + r * w:di + (r + 1) * w].contiguous())

    @staticmethod
    def backward(ctx, dx, dz):
        mesh = ctx.mesh
        tp, r = mesh.shape["model"], mesh.axis_index("model")
        dx = torch.zeros_like(dz) if dx is None else dx
        dz = torch.zeros_like(dx) if dz is None else dz
        g = mesh.all_gather(torch.cat([dx, dz], dim=-1), "model", dim=-1)
        w = dx.shape[-1]
        parts = g.split(w, dim=-1)  # dx_0, dz_0, dx_1, dz_1, ...
        full = torch.cat(parts[0::2] + parts[1::2], dim=-1)
        return full[..., 2 * r * w:2 * (r + 1) * w], None


def _bcdt(p, xc, N: int, *, dt_unrounded: bool, mesh=None):
    """B, C and the float32 ``dt`` from the conv's output; with
    ``dt_unrounded`` the ``w_dt`` product reaches ``+ dt_bias`` in
    float32.  On a mesh the product with ``w_bcdt``'s rows is summed over
    ``model``, and the replicated sum enters the rank's channels through
    ``copy_to``."""
    bcdt = xc @ p["w_bcdt"]
    if mesh is not None:
        bcdt = mesh.copy_to(mesh.reduce_from(bcdt))
    r = bcdt[..., 2 * N:]
    pre = (r.float() @ p["w_dt"].float() if dt_unrounded
           else r @ p["w_dt"])
    return bcdt[..., :N], bcdt[..., N:2 * N], softplus(pre + p["dt_bias"])


def mamba_apply(p, x, cfg, *, gamma, mode: str, cache=None, mesh=None):
    """mode 'train' -> y; 'prefill' -> (y, state); 'decode' -> (y, state).

    ``x`` (B,S,d) is the un-normalized residual stream and ``gamma`` the
    mixer's RMSNorm weight: the norm and ``w_in`` are one
    ``ops.fused_norm_matmul`` launch.  With ``mesh`` the leaves are the
    rank's channels (see the module docstring) and ``y`` its partial
    sum."""
    B, S, d = x.shape
    mc = cfg.mamba
    di = p["D"].shape[0]  # the rank's channels on a mesh
    N = mc.d_state
    if mesh is not None:  # the fused norm's dx and dgamma are partial
        x, gamma = mesh.copy_to(x), mesh.copy_to(gamma)
    xz = ops.fused_norm_matmul(x.reshape(B * S, d), gamma, p["w_in"])
    if mesh is not None:
        xi, z = _ExchangeHalves.apply(xz.view(B, S, -1), mesh)
    else:
        xz = xz.view(B, S, 2 * di)
        xi, z = xz[..., :di], xz[..., di:]
    A = -torch.exp(p["A_log"].float())

    if mode in ("train", "prefill"):
        pad = torch.nn.functional.pad(xi, (0, 0, mc.d_conv - 1, 0))
        xc32 = _silu_f32(_conv(lambda i: pad[:, i:i + S], p["conv_w"],
                               p["conv_b"], mc.d_conv))
        Bm, Cm, dt = _bcdt(p, xc32.to(x.dtype), N, dt_unrounded=False,
                           mesh=mesh)
        y, last_h = _ssm_scan(xc32, dt, A, Bm.float(), Cm.float(),
                              p["D"].float())
        out = (silu(z) * y.to(x.dtype)) @ p["w_out"]
        if mode == "prefill":
            tail = (pad[:, -(mc.d_conv - 1):] if mc.d_conv > 1
                    else torch.zeros((B, 0, di), dtype=x.dtype,
                                     device=x.device))
            return out, (last_h.float(), tail)
        return out

    # ---- decode: one token, constant state --------------------------------
    h_prev, tail = cache  # (B,di,N) float32, (B,d_conv-1,di)
    window = torch.cat([tail, xi], dim=1)  # (B,d_conv,di)
    xc32 = _silu_f32(_conv(lambda i: window[:, i], p["conv_w"], p["conv_b"],
                           mc.d_conv))  # (B,di)
    xc = xc32.to(x.dtype)
    Bm, Cm, dt = _bcdt(p, xc, N, dt_unrounded=True, mesh=mesh)
    Ab = torch.exp(dt[..., None] * A[None])                  # (B,di,N)
    h = Ab * h_prev + dt[..., None] * Bm[:, None, :] * xc[..., None]
    y = torch.einsum("bdn,bn->bd", h, Cm.float()) + p["D"][None] * xc32
    out = (silu(z[:, 0]) * y.to(x.dtype)) @ p["w_out"]
    new_tail = window[:, 1:] if mc.d_conv > 1 else tail
    return out[:, None], (h, new_tail)


def mamba_init_cache(cfg, batch, dtype=torch.float32, device=None):
    mc = cfg.mamba
    di = mc.expand * cfg.d_model
    return (torch.zeros((batch, di, mc.d_state), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, max(mc.d_conv - 1, 0), di), dtype=dtype,
                        device=device))


def default_dt_rank(d_model: int) -> int:
    return max(1, int(np.ceil(d_model / 16)))
