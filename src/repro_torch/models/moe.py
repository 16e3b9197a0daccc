"""MoE block with the Outback decoupling pattern: the reference's
``models/moe.py`` in PyTorch, without the mesh.

Placement mirrors the paper: the **router** (compute-heavy, memory-light —
one (d, E) matmul + top-k) runs where the tokens live, like the CN locator;
the **expert weights** (memory-heavy) are the MN pool.  Under tensor
parallelism the experts shard over the ``model`` axis and one collective
recombines the weighted outputs, a single round trip a layer
(:func:`moe_spmd`, over a ``launch/mesh.py`` mesh; at decode with
``moe_gather_decode``, :func:`moe_gather_spmd`).
The dispatch/combine arithmetic is the sharded KVS router's binning trick
(``core/sharded_kvs.py``).

The functions take ``x`` already normalized (the reference's ``h``).  The
expert products are plain ``torch.matmul`` / ``torch.bmm``, as the
reference computes its einsums outside any Pallas kernel.  Given
``norm_in = (rows, gamma)``, the un-normalized rows and the ffn's RMSNorm
weight, the shared expert's gate and up, an RMSNorm -> projection pair
with a continuous output, are ``ops.fused_norm_matmul`` launches.

Nothing adds with atomics: the binned combine sums each token's lanes in
lane (expert) order from zero, by a gather and a sum along k, and the
dispatch gather's backward sums the same way, so a step on the card
replays bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.common import silu


def moe_params_shape(cfg):
    m = cfg.moe
    d = cfg.d_model
    shapes = {
        "router": (d, m.num_experts),
        "w_gate": (m.num_experts, d, m.d_ff_expert),
        "w_up": (m.num_experts, d, m.d_ff_expert),
        "w_down": (m.num_experts, m.d_ff_expert, d),
    }
    if m.num_shared:
        f = m.d_ff_expert * m.num_shared
        shapes.update({"s_gate": (d, f), "s_up": (d, f), "s_down": (f, d)})
    return shapes


def top_k(scores, k: int):
    """The k largest scores along the last axis and their indices, largest
    first and, among equal scores, the lower index first (as
    ``jax.lax.top_k``): a stable descending sort."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_probs(p, x, cfg):
    """Top-k routing with normalized weights (mixtral/deepseek style), in
    float32 from ``x`` as given -> (w, idx, scores)."""
    m = cfg.moe
    logits = x.float() @ p["router"].float()
    if m.score_func == "sigmoid":  # deepseek-v3
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    w, idx = top_k(scores, m.top_k)  # (..., k)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    return w, idx, scores


def load_balance_loss(scores, idx, num_experts: int):
    """Switch-style aux loss: E * sum(frac_tokens * frac_prob)."""
    probs_mean = scores.mean(dim=tuple(range(scores.dim() - 1)))
    onehot = F.one_hot(idx, num_experts).float()
    tokens_mean = onehot.sum(dim=-2).mean(dim=tuple(range(onehot.dim() - 2)))
    return num_experts * (probs_mean * tokens_mean).sum()


def shared_expert(p, xf, norm_in=None):
    """The always-on expert (deepseek): ``xf`` (T, d) -> (T, d).  With
    ``norm_in`` its gate and up run through the fused kernel on the
    un-normalized rows."""
    if norm_in is None:
        g, u = xf @ p["s_gate"], xf @ p["s_up"]
    else:
        rows, gamma = norm_in
        g = ops.fused_norm_matmul(rows, gamma, p["s_gate"])
        u = ops.fused_norm_matmul(rows, gamma, p["s_up"])
    return torch.matmul(silu(g) * u, p["s_down"])


def _with_zero_row(t):
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def _sum_lanes(rows, lanes):
    """``rows`` (N, d) gathered at ``lanes`` (T, k) (N: a zero row) and
    summed along k in order, from zero: (T, d)."""
    g = _with_zero_row(rows)[lanes]
    out = torch.zeros_like(g[:, 0])
    for j in range(lanes.shape[1]):
        out = out + g[:, j]
    return out


class _Dispatch(torch.autograd.Function):
    """Token rows into expert bins: ``xf`` (T, d) -> (E*C, d), lane l
    holding row ``lane_tok[l]`` (T: an empty lane, zeros).  The backward
    gathers each token's lanes (``lanes`` (T, k), ascending, E*C for a
    dropped pick) and sums them in order: no atomics."""

    @staticmethod
    def forward(ctx, xf, lane_tok, lanes):
        ctx.save_for_backward(lanes)
        return _with_zero_row(xf)[lane_tok]

    @staticmethod
    def backward(ctx, g):
        (lanes,) = ctx.saved_tensors
        return _sum_lanes(g, lanes), None, None


class _Combine(torch.autograd.Function):
    """Weighted lane outputs back to tokens: ``yw`` (E*C, d) -> (T, d),
    each token's lanes summed in lane order from zero.  The backward is
    the gather of each lane's token row."""

    @staticmethod
    def forward(ctx, yw, lanes, lane_tok):
        ctx.save_for_backward(lane_tok)
        return _sum_lanes(yw, lanes)

    @staticmethod
    def backward(ctx, g):
        (lane_tok,) = ctx.saved_tensors
        return _with_zero_row(g)[lane_tok], None, None


def moe_apply(p, x, cfg, *, norm_in=None):
    """x (B,S,d) -> (out (B,S,d), aux_loss).  Dense-dispatch formulation:
    every expert over every token, combined by the routing weights."""
    B, S, d = x.shape
    m = cfg.moe
    w, idx, scores = router_probs(p, x, cfg)  # (B,S,k)
    T = B * S
    xf = x.reshape(T, d)
    # the (tokens x experts) combine matrix; a token's k experts differ
    comb = torch.zeros((T, m.num_experts), dtype=x.dtype, device=x.device)
    comb = comb.scatter(1, idx.reshape(T, -1), w.reshape(T, -1).to(x.dtype))
    h_g = torch.einsum("td,edf->tef", xf, p["w_gate"])
    h_u = torch.einsum("td,edf->tef", xf, p["w_up"])
    h = silu(h_g) * h_u
    y = torch.einsum("tef,efd->ted", h, p["w_down"])
    out = torch.einsum("ted,te->td", y, comb)
    if m.num_shared:
        out = out + shared_expert(p, xf, norm_in)
    aux = load_balance_loss(scores, idx, m.num_experts)
    return out.reshape(B, S, d), aux


def bins(idx, E: int, C: int):
    """The reference's capacity binning of ``idx`` (T, k) -> (lane_tok
    (E*C,): each lane's token, T when empty; dest (T*k,): each pick's lane
    in (token, choice) order, E*C when dropped).  The flat picks are
    sorted by expert, stably, and those past C in an expert's bin drop:
    the last in token order, then choice order."""
    T, k = idx.shape
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    start = torch.searchsorted(
        sorted_e, torch.arange(E, device=idx.device, dtype=sorted_e.dtype))
    n = torch.arange(T * k, device=idx.device)
    pos = n - start[sorted_e]
    dest_sorted = torch.where(pos < C, sorted_e * C + pos, E * C)
    dest = torch.empty_like(dest_sorted)
    dest[order] = dest_sorted  # a permutation: unique indices
    # an extra lane E*C takes the dropped picks and is cut off
    lane_tok = torch.full((E * C + 1,), T, dtype=torch.long,
                          device=idx.device)
    lane_tok[dest] = n // k
    return lane_tok[:E * C], dest


def moe_apply_binned(p, x, cfg, *, capacity_factor: float = 1.25,
                     norm_in=None):
    """Capacity-binned dispatch (the production/serving form): tokens are
    binned per expert with fixed capacity C, experts run (E, C, d) batches,
    overflow picks fall back to zero contribution (standard drop policy)."""
    B, S, d = x.shape
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    T = B * S
    C = max(8, int(T * k / E * capacity_factor))
    w, idx, scores = router_probs(p, x, cfg)
    xf = x.reshape(T, d)
    idx = idx.reshape(T, k)
    lane_tok, dest = bins(idx, E, C)
    # each pick's routing weight, rounded to the activation dtype, on its
    # lane (an empty lane's weight is 0)
    lane_w = torch.zeros(E * C + 1, dtype=x.dtype, device=x.device)
    lane_w[dest] = w.reshape(-1).to(x.dtype)
    lane_w = lane_w[:E * C]
    lanes = dest.view(T, k).sort(dim=1).values  # a token's lanes, in order
    xin = _Dispatch.apply(xf, lane_tok, lanes).view(E, C, d)
    h = silu(torch.bmm(xin, p["w_gate"])) * torch.bmm(xin, p["w_up"])
    y = torch.bmm(h, p["w_down"]).reshape(E * C, d)
    out = _Combine.apply(y * lane_w[:, None], lanes, lane_tok)
    if m.num_shared:
        out = out + shared_expert(p, xf, norm_in)
    aux = load_balance_loss(scores, idx.reshape(B, S, k), E)
    return out.reshape(B, S, d), aux


def moe_gather_apply(p, x, cfg, stacks=None, layer_idx=None, *,
                     norm_in=None):
    """Tiny-token MoE (decode): gather ONLY the routed experts' weights,
    (T*k) expert slices instead of all E experts.  ``stacks``: the
    layer-stacked expert banks, gathered at (``layer_idx``, expert)."""
    B, S, d = x.shape
    m = cfg.moe
    T = B * S
    w, idx, scores = router_probs(p, x, cfg)  # (B,S,k)
    xf = x.reshape(T, d)
    idx_f = idx.reshape(T * m.top_k)
    w_f = w.reshape(T * m.top_k).to(x.dtype)
    if stacks is not None:
        wg = stacks["w_gate"][layer_idx, idx_f]
        wu = stacks["w_up"][layer_idx, idx_f]
        wd = stacks["w_down"][layer_idx, idx_f]
    else:
        wg = p["w_gate"][idx_f]  # (T*k, d, f)
        wu = p["w_up"][idx_f]
        wd = p["w_down"][idx_f]
    xe = xf.repeat_interleave(m.top_k, dim=0)[:, None]  # (T*k, 1, d)
    h = silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    y = torch.bmm(h, wd)[:, 0] * w_f[:, None]
    out = y.reshape(T, m.top_k, d).sum(dim=1)
    if m.num_shared:
        out = out + shared_expert(p, xf, norm_in)
    aux = load_balance_loss(scores, idx, m.num_experts)
    return out.reshape(B, S, d), aux


def _shared_spmd(p, out, xf, cfg, mesh, split: bool, norm_in):
    """``out``, this rank's routed sum, completed over ``mesh``'s ``model``
    axis with the shared expert, as the reference's ``moe_spmd`` does: the
    shared expert's partial sum folded into the one psum when its weights
    are row-split (added after it otherwise); ``split``: the banks are
    split, so ``out`` is partial."""
    m = cfg.moe
    tp = mesh.shape["model"]
    if m.num_shared:
        fs = m.d_ff_expert * m.num_shared
        if fs % tp == 0:  # row-split: its partial sum joins the psum
            part = shared_expert(
                p, mesh.copy_to(xf), None if norm_in is None else
                tuple(mesh.copy_to(t) for t in norm_in))
            return mesh.reduce_from(out + part, "model") if split else \
                out + mesh.reduce_from(part, "model")
        return (mesh.reduce_from(out, "model") if split else out) + \
            shared_expert(p, xf, norm_in)
    return mesh.reduce_from(out, "model") if split else out


def moe_gather_spmd(p, x, cfg, mesh, *, norm_in=None):
    """:func:`moe_gather_apply` as one ``model`` rank's program (decode,
    a few tokens): ``p``'s banks are the rank's ``E / tp`` experts, so the
    rank runs only the routed picks that fall in them, reading only those
    experts' slices, and one psum over ``model`` completes the sum (with
    the shared expert as in :func:`moe_spmd`).  Each pick's output lands
    on its (token, choice) row, zeros for the other ranks' picks, and a
    token's k rows are summed in order: no atomics.  The local picks are
    found on the host (one sync a layer).  With ``E % tp != 0`` the banks
    are whole and the rank runs every pick."""
    B, S, d = x.shape
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    tp = mesh.shape["model"]
    split = E % tp == 0
    E_loc = E // tp if split else E
    T = B * S
    w, idx, scores = router_probs(p, x, cfg)  # (B,S,k)
    f = mesh.copy_to if split else (lambda t: t)
    xf = x.reshape(T, d)
    rel = idx.reshape(T * k) - (mesh.axis_index("model") * E_loc
                                if split else 0)
    sel = torch.nonzero((rel >= 0) & (rel < E_loc))[:, 0]
    e = rel[sel]
    xe = f(xf).repeat_interleave(k, dim=0)[sel][:, None]  # (n, 1, d)
    h = silu(torch.bmm(xe, p["w_gate"][e])) * torch.bmm(xe, p["w_up"][e])
    w_f = f(w).reshape(T * k).to(x.dtype)[sel]
    y = torch.bmm(h, p["w_down"][e])[:, 0] * w_f[:, None]
    rows = y.new_zeros((T * k, d)).index_put((sel,), y)
    out = rows.view(T, k, d).sum(dim=1)
    out = _shared_spmd(p, out, xf, cfg, mesh, split, norm_in)
    aux = load_balance_loss(scores, idx, E)
    return out.reshape(B, S, d), aux


def spmd_bins(idx, E: int, E_loc: int, m_idx: int, C: int):
    """:func:`bins` of one ``model`` rank of :func:`moe_spmd`: the picks
    of experts ``m_idx * E_loc ..`` go to local bins, every other pick to
    one extra bin that is cut off, by the same stable sort; so the local
    bins hold exactly the lanes that the whole binning gives those
    experts.  -> (lane_tok (E_loc*C,), dest (T*k,): E_loc*C for a pick
    dropped or not local)."""
    rel = idx - m_idx * E_loc
    tgt = torch.where((rel >= 0) & (rel < E_loc), rel, E_loc)
    lane_tok, dest = bins(tgt, E_loc + 1, C)
    return lane_tok[:E_loc * C], torch.clamp(dest, max=E_loc * C)


def moe_spmd(p, x, cfg, mesh, *, norm_in=None):
    """Replicated-EP dispatch over ``mesh``'s ``model`` axis: the
    reference's ``moe_spmd`` as this rank's program.  The tokens are
    replicated across ``model``; the rank bins only the picks routed to
    its ``E / tp`` local experts (``p``'s banks are its shards; C from the
    rank's T), runs them, and one psum over ``model`` recombines, with the
    shared expert's partial sum folded into it when its weights are
    row-split (added after it otherwise).  The activation and the routing
    weights enter the local experts through ``copy_to``, so the router's
    gradient sums over ranks.  With ``E % tp != 0`` the banks are whole
    and nothing is reduced.  Nothing adds with atomics."""
    B, S, d = x.shape
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    tp = mesh.shape["model"]
    split = E % tp == 0
    E_loc = E // tp if split else E
    T = B * S
    C = max(8, int(T * k / E * m.capacity_factor))
    w, idx, scores = router_probs(p, x, cfg)
    xf = x.reshape(T, d)
    idx = idx.reshape(T, k)
    lane_tok, dest = spmd_bins(idx, E, E_loc,
                               mesh.axis_index("model") if split else 0, C)
    f = mesh.copy_to if split else (lambda t: t)
    lane_w = torch.zeros(E_loc * C + 1, dtype=x.dtype, device=x.device)
    lane_w = lane_w.index_put((dest,), f(w).reshape(-1).to(x.dtype))
    lane_w = lane_w[:E_loc * C]
    lanes = dest.view(T, k).sort(dim=1).values
    xin = _Dispatch.apply(f(xf), lane_tok, lanes).view(E_loc, C, d)
    h = silu(torch.bmm(xin, p["w_gate"])) * torch.bmm(xin, p["w_up"])
    y = torch.bmm(h, p["w_down"]).reshape(E_loc * C, d)
    out = _Combine.apply(y * lane_w[:, None], lanes, lane_tok)
    out = _shared_spmd(p, out, xf, cfg, mesh, split, norm_in)
    aux = load_balance_loss(scores, idx.reshape(B, S, k), E)
    return out.reshape(B, S, d), aux
