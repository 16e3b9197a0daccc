"""Attention, GQA (full / sliding-window) and MLA: the reference's
``models/attention.py`` in PyTorch, full-sequence and decode paths.

The q, k and v projections enter through ``ops.fused_norm_matmul``: the
caller passes the un-normalized activation and the mixer's RMSNorm gamma,
and each projection is one kernel launch on a view of the head-major
weight, with no copy.  MLA has three such entries (the mixer's norm into
``wq_a`` and into ``wkv_a``, ``q_a_norm`` into ``wq_b``).
``flash_attention``, ``decode_attention`` and MLA's absorbed decode are
plain PyTorch, as the reference computes them outside any Pallas kernel.

A decode cache whose sequence splits over mesh axes (:class:`SeqSplit`:
the batch-1 long-context cache over ``data``, or ``cache_seq_shard`` over
``model``) holds global positions ``[r * S_loc, (r + 1) * S_loc)`` on the
rank at index ``r`` of those axes.  Only the owner of the new token's
position writes it; each rank computes the float32 flash partials ``(o, m,
l)`` of its range (:func:`decode_partials`, the masks of
:func:`decode_attention`), and one ``all_gather`` over the axes and
``ops.flash_combine`` in rank order give every rank the same softmax
(:meth:`SeqSplit.combine`).  A range with no live position weighs
``exp(NEG_INF - m_max) = 0``.  What GSPMD partitions in the reference, the
rank's program does by hand.

A gqa decode cache whose ``head_dim`` splits over ``model``
(:class:`HeadDimSplit`, the reference's ``hd_axis``) holds columns ``[r *
hd / tp, (r + 1) * hd / tp)`` of every kv head on the rank at index ``r``.
The rank writes its columns of the new token, takes its columns of every
q head's query, and computes float32 partial scores over them; one
``psum`` over ``model`` completes the scores, which are masked and
softmaxed as :func:`decode_attention` does it (with a batch-1 sequence
split over ``data`` too, they become the chunk's flash partials, combined
over ``data``).  ``p @ v`` over the rank's columns, then one ``all_gather``
over ``model``, gives the rank its own heads' whole output.

``inplace``: the decode writes the new token into the cache's tensors
(:func:`_write_into`) and hands them back, the counterpart of the
reference's donated cache; else it returns new tensors (:func:`_write_at`).
"""

from __future__ import annotations

import dataclasses
import itertools

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rms_norm

NEG_INF = -1e30


def repeat_kv(k, n_heads: int):
    """GQA repeat: (B,S,Hkv,d) -> (B,S,H,d); head h reads kv head h // g.
    An expand, whose backward sums each group in a fixed order (the
    backward of ``index_select`` on the card adds with atomics)."""
    B, S, Hkv, d = k.shape
    if Hkv == n_heads:
        return k
    return k[:, :, :, None].expand(B, S, Hkv, n_heads // Hkv, d) \
        .reshape(B, S, n_heads, d)


# ---------------------------------------------------------------- flash core
def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    q_chunk: int = 512, kv_chunk: int = 512, scale=None):
    """Double-blocked causal attention with an online softmax in float32
    (plain MHA: repeat GQA KV first with ``repeat_kv``).  q (B,Sq,H,d),
    k/v (B,Sk,H,d|dv).  ``window`` enables sliding-window masking.  Returns
    (B,Sq,H,dv) float32, as the reference does."""
    B, Sq, H, d = q.shape
    Sk = k.shape[1]
    dv = v.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    q_off = Sk - Sq  # q positions relative to k positions
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qc = qf[:, q0:q0 + q_chunk]
        nq = qc.shape[1]
        qpos = q_off + q0 + torch.arange(nq, device=q.device)
        m = torch.full((B, H, nq), NEG_INF, device=q.device)
        l = torch.zeros((B, H, nq), device=q.device)
        acc = torch.zeros((B, H, nq, dv), device=q.device)
        for k0 in range(0, Sk, kv_chunk):
            kc, vc = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
            kpos = k0 + torch.arange(kc.shape[1], device=q.device)
            s = torch.einsum("bqhd,bkhd->bhqk", qc, kc)
            mask = torch.ones((nq, kc.shape[1]), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                mask &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                        vc)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,H,qc,dv)
        outs.append(o.transpose(1, 2))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, length, *, window: int | None = None,
                     kv_idx=None):
    """Single-token decode vs a (B, Smax, Hkv, d) cache; q (B,1,H,d).
    Positions >= length are masked; sliding window additionally masks
    positions <= length-1-window."""
    B, _, H, d = q.shape
    if kv_idx is not None:
        kf = k_cache.index_select(2, kv_idx).float()
        vf = v_cache.index_select(2, kv_idx).float()
    else:
        kf = repeat_kv(k_cache, H).float()
        vf = repeat_kv(v_cache, H).float()
    qf = q.reshape(B, H, d).float() * (d ** -0.5)
    s = torch.einsum("bhd,bshd->bhs", qf, kf)
    s = torch.where(_decode_mask(s, length, 0, window), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bshd->bhd", p, vf)
    return o.reshape(B, 1, H, d).to(q.dtype)


def _kv_group(heads, H: int, Hkv: int):
    """The q heads' group size when ``heads`` (q head -> kv head, None:
    the plain GQA pattern) is the plain pattern over all ``Hkv`` kv heads,
    else None."""
    if heads is None:
        return H // Hkv
    runs = [(h, len(list(grp))) for h, grp in itertools.groupby(heads)]
    if [h for h, _ in runs] == list(range(Hkv)) \
            and len({n for _, n in runs}) == 1:
        return runs[0][1]
    return None


def decode_partials(q, k_cache, v_cache, length, *, window=None, heads=None,
                    pos0=0):
    """The float32 flash partials of a single-token decode against a chunk
    (B, S_loc, Hkv, d) of the cache that holds global positions ``pos0 ..
    pos0 + S_loc``, with :func:`decode_attention`'s masks at those global
    positions (``length`` valid positions, ``window``) and its ``NEG_INF``;
    q (B,1,H,d); ``heads`` maps each q head to its kv head (None: the plain
    GQA pattern).  -> (o (B,H,d) normalized by its own l, m (B,H), l
    (B,H)).  A chunk with no live position gives m = NEG_INF, which
    ``ops.flash_combine`` weighs 0.  The plain pattern reads each kv head
    once for its group of q heads (no repeat of the chunk)."""
    B, _, H, d = q.shape
    qf = q.reshape(B, H, d).float() * (d ** -0.5)
    s = _scores(qf, k_cache.float(), heads)
    p, m, l = _masked_exp(s, length, pos0, window)
    return _weighted(p, v_cache.float(), heads) / l[..., None], m, l


def _scores(qf, kf, heads):
    """Float32 scores (B, H, S) of the scaled queries ``qf`` (B, H, e)
    against a float32 cache chunk ``kf`` (B, S, Hkv, e); ``heads`` maps
    each q head to its kv head (None: the plain GQA pattern), which reads
    each kv head once for its group of q heads (no repeat of the
    chunk)."""
    B, H, e = qf.shape
    S, Hkv = kf.shape[1], kf.shape[2]
    g = _kv_group(heads, H, Hkv)
    if g is not None:
        return torch.einsum("bkgd,bskd->bkgs", qf.view(B, Hkv, g, e),
                            kf).reshape(B, H, S)
    kf = kf.index_select(2, torch.tensor(heads, device=qf.device))
    return torch.einsum("bhd,bshd->bhs", qf, kf)


def _weighted(p, vf, heads):
    """The weights ``p`` (B, H, S) over a float32 cache chunk ``vf`` (B,
    S, Hkv, e) -> (B, H, e), q heads mapped as in :func:`_scores`."""
    B, H, S = p.shape
    g = _kv_group(heads, H, vf.shape[2])
    if g is not None:
        return torch.einsum("bkgs,bskd->bkgd", p.view(B, -1, g, S),
                            vf).reshape(B, H, -1)
    vf = vf.index_select(2, torch.tensor(heads, device=p.device))
    return torch.einsum("bhs,bshd->bhd", p, vf)


def _decode_mask(s, length, pos0: int, window=None):
    """Which of the scores (B, H, S) of positions ``pos0 ..`` a decode
    reads: those below the row's ``length``, and with ``window`` only the
    last ``window`` of them."""
    pos = pos0 + torch.arange(s.shape[-1], device=s.device)[None, None, :]
    mask = pos < length[:, None, None]
    if window is not None:
        mask &= pos > (length[:, None, None] - 1 - window)
    return mask


def _masked_exp(s, length, pos0: int, window=None):
    """Scores (B, H, S) of positions ``pos0 ..``, masked as
    :func:`decode_attention` masks them -> (exp(s - m), m, l)."""
    s = torch.where(_decode_mask(s, length, pos0, window), s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    return p, m, p.sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """The decode cache's sequence split over ``axes`` of ``mesh`` (one
    name or a tuple, the first major, as ``Mesh.axis_index``): the rank
    holds ``S_loc`` positions from ``index * S_loc``.  ``gather_heads``:
    the mixer's heads split over ``model``, one of ``axes``, so the rank
    gathers the new token's q (and its k, v when the kv heads split) over
    ``model``, computes every head's partials on its chunk, and keeps its
    own heads of the combine."""
    mesh: object
    axes: tuple
    gather_heads: bool = False

    def pos0(self, s_loc: int) -> int:
        return self.mesh.axis_index(self.axes) * s_loc

    def size(self) -> int:
        return self.mesh.axis_size(self.axes)

    def combine(self, o, m, l) -> torch.Tensor:
        """The whole softmax from this rank's partials: one ``all_gather``
        of ``(o, m, l)`` packed on the last axis over :attr:`axes`, then
        ``ops.flash_combine`` in rank order, so every rank holds the same
        bits."""
        d = o.shape[-1]
        packed = torch.cat([o, m[..., None], l[..., None]], dim=-1)
        parts = self.mesh.all_gather(packed[None], self.axes, dim=0)
        return ops.flash_combine(list(parts[..., :d]), list(parts[..., d]),
                                 list(parts[..., d + 1]))


def gather_heads(mesh, *xs) -> list:
    """Each (B, 1, n_i, e_i) of ``xs`` (one dtype) with the heads of every
    ``model`` rank of ``mesh``, in rank order: one ``all_gather`` of the
    rank's heads, packed flat."""
    B = xs[0].shape[0]
    flat = torch.cat([x.reshape(B, 1, -1) for x in xs], dim=-1)
    parts = mesh.all_gather(flat[None], "model", dim=0)
    out, at = [], 0
    for x in xs:
        n, e = x.shape[2], x.shape[3]
        h = parts[..., at:at + n * e]  # (tp, B, 1, n * e)
        out.append(h.reshape(-1, B, 1, n, e).permute(1, 2, 0, 3, 4)
                   .reshape(B, 1, -1, e))
        at += n * e
    return out


@dataclasses.dataclass(frozen=True)
class HeadDimSplit:
    """The gqa decode cache's ``head_dim`` split over ``model`` of
    ``mesh`` (see the module docstring): the rank holds ``head_dim / tp``
    columns of every kv head.  ``gather_q``: the q heads split over
    ``model`` too, so the rank gathers every rank's query first (else it
    holds every q head already, attention being replicated)."""
    mesh: object
    gather_q: bool = False

    def columns(self, hd: int) -> slice:
        n = hd // self.mesh.axis_size("model")
        r = self.mesh.axis_index("model")
        return slice(r * n, (r + 1) * n)

    def own_heads(self, o, q0: int, H: int) -> torch.Tensor:
        """The rank's ``H`` heads from ``q0`` of the whole output, from
        every rank's columns ``o`` (B, heads, hd / tp) of every head: one
        ``all_gather`` over ``model``."""
        B, heads, n = o.shape
        parts = self.mesh.all_gather(o[None], "model", dim=0)
        return parts.permute(1, 2, 0, 3).reshape(B, heads, -1)[:, q0:q0 + H]


# ------------------------------------------------------------------- GQA box
def gqa_params_shape(cfg):
    """Head-major 3-D projections: (d, H, hd) / (H, hd, d)."""
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {
        "wq": (d, H, hd), "wk": (d, Hkv, hd), "wv": (d, Hkv, hd),
        "wo": (H, hd, d),
    }
    if cfg.qkv_bias:
        shapes.update({"bq": (H, hd), "bk": (Hkv, hd), "bv": (Hkv, hd)})
    if cfg.qk_norm:
        shapes.update({"q_norm": (hd,), "k_norm": (hd,)})
    return shapes


def gqa_kv_heads(cfg, n_heads: int, q0: int = 0, kv0: int = 0) -> list:
    """Static q-head -> kv-head mapping of the heads ``q0 .. q0 + n_heads``
    (head h reads kv head h // g; pad heads beyond cfg.num_heads map as
    the last real head does), as indices into kv heads held from ``kv0``
    on."""
    g = max(1, cfg.num_heads // cfg.num_kv_heads)
    return [min(q0 + j, cfg.num_heads - 1) // g - kv0
            for j in range(n_heads)]


def expand_kv(k, heads: list):
    """(B,S,Hkv,d) -> (B,S,len(heads),d), q head j reading kv head
    ``heads[j]`` (a nondecreasing list): each run of one kv head an
    expand, so the backward sums each group in a fixed order; the plain
    GQA pattern is :func:`repeat_kv`."""
    B, S, Hkv, d = k.shape
    if _kv_group(heads, len(heads), Hkv) is not None:
        return repeat_kv(k, len(heads))
    runs = [(h, len(list(grp))) for h, grp in itertools.groupby(heads)]
    return torch.cat([k[:, :, h:h + 1].expand(B, S, n, d) for h, n in runs],
                     dim=2)


def gqa_apply(p, x, cfg, *, gamma, positions, mode: str, cache=None,
              q0: int = 0, kv0: int = 0, seq: SeqSplit | None = None,
              hd_split: HeadDimSplit | None = None, inplace: bool = False):
    """mode: 'train' (the full sequence, no cache) | 'decode' (one token
    against ``cache``, returns the new cache).

    ``x`` (B,S,d) is the un-normalized residual stream and ``gamma`` the
    mixer's RMSNorm weight: each of q, k and v is one
    ``ops.fused_norm_matmul`` launch.  ``H`` is read from the weights, so
    ``pad_attn_heads``'s padded q heads flow through: heads at or past
    ``cfg.num_heads`` read the last real head's kv and contribute zero.
    On a mesh the weights are one rank's heads, the first of them global
    q head ``q0`` and kv head ``kv0``; ``seq``: the cache's sequence split,
    ``hd_split`` its ``head_dim`` split, or None each (see the module
    docstring, also for ``inplace``)."""
    B, S, d = x.shape
    H, hd = p["wq"].shape[1], cfg.head_dim
    Hkv = p["wk"].shape[1]
    x2d = x.reshape(B * S, d)
    heads = gqa_kv_heads(cfg, H, q0, kv0)
    pad_mask = None
    if q0 + H > cfg.num_heads:  # padded heads contribute zero
        pad_mask = (torch.arange(q0, q0 + H, device=x.device)
                    < cfg.num_heads).float()

    def proj(w, heads):
        return ops.fused_norm_matmul(x2d, gamma, w.reshape(d, heads * hd)) \
            .view(B, S, heads, hd)

    q, k, v = proj(p["wq"], H), proj(p["wk"], Hkv), proj(p["wv"], Hkv)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    window = cfg.window if cfg.attn_kind == "swa" else None
    if mode == "train":
        o = flash_attention(q, expand_kv(k, heads), expand_kv(v, heads),
                            causal=True, window=window)
        if pad_mask is not None:
            o = o * pad_mask[None, None, :, None]
        return torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])
    kv_idx = torch.tensor(heads, device=x.device)
    # decode: cache = (k_cache, v_cache, length); the new token is written at
    # per-row `length` (positions = length for RoPE). SWA uses a rolling
    # cache: slot = length % window_size, all-written-slots valid.
    # Over a split sequence the global cache is the ranks' chunks end to
    # end: the rolling slot's owner is slot // S_loc.
    write = _write_into if inplace else _write_at
    _, _, length = cache
    S_loc = cache[0].shape[1]
    W = S_loc * (seq.size() if seq is not None else 1)
    rolling = window is not None and W <= window
    slot = length % W if rolling else length
    valid, win = ((torch.clamp(length + 1, max=W), None) if rolling
                  else (length + 1, window))
    if hd_split is not None:  # the rank's columns of every head
        cols = hd_split.columns(hd)
        qa = gather_heads(hd_split.mesh, q)[0] if hd_split.gather_q else q
        heads_a = gqa_kv_heads(cfg, qa.shape[2])
        pos0 = seq.pos0(S_loc) if seq is not None else 0
        k_cache = write(cache[0], k[..., cols], slot - pos0)
        v_cache = write(cache[1], v[..., cols], slot - pos0)
        qf = qa[:, 0, :, cols].float() * (hd ** -0.5)
        s = hd_split.mesh.psum(_scores(qf, k_cache.float(), heads_a),
                               "model")
        vf = v_cache.float()
        if seq is None:
            s = torch.where(_decode_mask(s, valid, 0, win), s, NEG_INF)
            o = _weighted(torch.softmax(s, dim=-1), vf, heads_a)
        else:
            e, m, l = _masked_exp(s, valid, pos0, win)
            o = seq.combine(_weighted(e, vf, heads_a) / l[..., None], m, l)
        o = hd_split.own_heads(o, q0, H).reshape(B, 1, H, hd).to(q.dtype)
    elif seq is None:
        k_cache = write(cache[0], k, slot)
        v_cache = write(cache[1], v, slot)
        o = decode_attention(q, k_cache, v_cache, valid, window=win,
                             kv_idx=kv_idx)
    else:
        qa, ka, va, heads_a = q, k, v, heads
        if seq.gather_heads:  # the chunk holds every kv head
            if Hkv < cfg.num_kv_heads:
                qa, ka, va = gather_heads(seq.mesh, q, k, v)
            else:
                qa, = gather_heads(seq.mesh, q)
            heads_a = gqa_kv_heads(cfg, qa.shape[2])
        pos0 = seq.pos0(S_loc)
        k_cache = write(cache[0], ka, slot - pos0)
        v_cache = write(cache[1], va, slot - pos0)
        o = seq.combine(*decode_partials(qa, k_cache, v_cache, valid,
                                         window=win, heads=heads_a,
                                         pos0=pos0))
        if seq.gather_heads:
            o = o[:, q0:q0 + H]
        o = o.reshape(B, 1, H, hd).to(q.dtype)
    if pad_mask is not None:
        o = o * pad_mask[None, None, :, None].to(o.dtype)
    out = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])
    return out, (k_cache, v_cache)


def _write_at(cache, kv, length):
    """Write one token (B,1,Hkv,d) into (B,Smax,Hkv,d) at per-row length.

    A select by position, which gives the reference's one-hot blend bit for
    bit for finite values; a row whose length lies outside [0, Smax) is
    left as it was, as there."""
    pos = torch.arange(cache.shape[1], device=cache.device)
    hit = (pos[None, :] == length[:, None])[:, :, None, None]
    return torch.where(hit, kv.to(cache.dtype), cache)


def _write_into(cache, row, length):
    """Write one token ``row`` (B, 1, ...) into ``cache`` (B, Smax, ...)
    at per-row ``length``, in place, and return ``cache``: the values of
    :func:`_write_at` (and :func:`_write_at2`), a row whose length lies
    outside [0, Smax) left as it was.  One ``index_put_`` of B rows: such a
    row writes back the value it reads."""
    B, S = cache.shape[:2]
    rows = torch.arange(B, device=cache.device)
    at = length.clamp(0, S - 1).long()
    ok = ((length >= 0) & (length < S)).view(B, *[1] * (row.dim() - 2))
    cache[rows, at] = torch.where(ok, row[:, 0].to(cache.dtype),
                                  cache[rows, at])
    return cache


# ------------------------------------------------------------------- MLA box
def mla_params_shape(cfg):
    d = cfg.d_model
    m = cfg.mla
    H = cfg.num_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": (d, m.q_lora_rank),
        "q_a_norm": (m.q_lora_rank,),
        "wq_b": (m.q_lora_rank, H * qk_dim),
        "wkv_a": (d, m.kv_lora_rank + m.qk_rope_head_dim),
        "kv_a_norm": (m.kv_lora_rank,),
        "wk_b": (m.kv_lora_rank, H * m.qk_nope_head_dim),
        "wv_b": (m.kv_lora_rank, H * m.v_head_dim),
        "wo": (H * m.v_head_dim, d),
    }


def mla_apply(p, x, cfg, *, gamma, positions, mode: str, cache=None,
              copy=None, seq: SeqSplit | None = None, inplace: bool = False):
    """Multi-head latent attention (deepseek-v3).  mode: 'train' | 'prefill'
    (returns the latent cache rows) | 'decode' (uses ``cache``).

    ``x`` is the un-normalized residual stream and ``gamma`` the mixer's
    RMSNorm weight.  The cache stores only the compressed latent
    (kv_lora_rank + rope dims a token); decode uses the absorbed-matmul
    form, in float32, so K/V are never expanded.  ``c_kv`` is explicit
    (the cache stores it), so ``wk_b`` and ``wv_b`` are plain products.

    The heads are read from ``wq_b``: on a mesh ``wq_b``, ``wk_b``,
    ``wv_b`` and ``wo`` are one rank's whole heads (their column and row
    shards; the projections are head-major), and ``out`` is the rank's
    partial sum.  ``copy`` (``Mesh.copy_to``) then takes the replicated
    values where they enter the rank's heads: ``q_a`` and ``q_a_norm`` (the
    ``wq_b`` entry), the latent ``c_kv`` and the rope key.  The ``wq_a``
    and ``wkv_a`` entries and the latent run whole on every rank, and every
    rank writes the same latent to the cache.

    ``seq``: the cache's sequence split, or None.  The scores go over the
    rank's chunk of the latent and rope key; their partials in latent
    space (``o_lat``, m, l) are combined across the split, and with
    ``seq.gather_heads`` the absorbed q of every ``model`` rank's heads is
    gathered first and the rank keeps its own heads of the combine.
    ``inplace``: the decode writes the new latent row into the cache's
    tensors (see the module docstring)."""
    B, S, d = x.shape
    m = cfg.mla
    r = m.kv_lora_rank
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    H = p["wq_b"].shape[1] // (dn + dr)
    scale = (dn + dr) ** -0.5
    x2d = x.reshape(B * S, d)
    f = copy if copy is not None else (lambda t: t)

    q_a = ops.fused_norm_matmul(x2d, gamma, p["wq_a"])
    q = ops.fused_norm_matmul(f(q_a), f(p["q_a_norm"]), p["wq_b"]).view(
        B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    kv_a = ops.fused_norm_matmul(x2d, gamma, p["wkv_a"]).view(B, S, r + dr)
    c_kv = rms_norm(kv_a[..., :r], p["kv_a_norm"])
    k_rope = apply_rope(kv_a[..., r:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]

    if mode in ("train", "prefill"):
        c_in = f(c_kv)
        k_nope = torch.matmul(c_in, p["wk_b"]).view(B, S, H, dn)
        v = torch.matmul(c_in, p["wv_b"]).view(B, S, H, dv)
        k = torch.cat([k_nope, f(k_rope)[:, :, None, :].expand(B, S, H, dr)],
                      dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        o = flash_attention(qq, k, v, causal=True, scale=scale)
        out = o.reshape(B, S, H * dv).to(x.dtype) @ p["wo"]
        if mode == "prefill":
            return out, (c_kv, k_rope)
        return out

    # ---- decode (absorbed): scores over the latent cache directly --------
    c_cache, r_cache, length = cache
    write = _write_into if inplace else _write_at2
    wk_b = p["wk_b"].reshape(r, H, dn).float()
    q_abs = torch.einsum("bshd,rhd->bshr", q_nope.float(), wk_b)  # (B,1,H,r)
    if seq is None:
        c_cache = write(c_cache, c_kv, length)
        r_cache = write(r_cache, k_rope, length)
        c_f = c_cache.float()
        s = torch.einsum("bshr,btr->bhst", q_abs, c_f)
        s = s + torch.einsum("bshd,btd->bhst", q_rope.float(),
                             r_cache.float())
        s = s * scale
        pos = torch.arange(c_cache.shape[1],
                           device=x.device)[None, None, None, :]
        s = torch.where(pos < (length + 1)[:, None, None, None], s, NEG_INF)
        attn = torch.softmax(s, dim=-1)  # (B,H,1,T)
        o_lat = torch.einsum("bhst,btr->bshr", attn, c_f)
    else:
        qa, qr = q_abs, q_rope.float()
        if seq.gather_heads:
            qa, qr = gather_heads(seq.mesh, qa, qr)
        pos0 = seq.pos0(c_cache.shape[1])
        c_cache = write(c_cache, c_kv, length - pos0)
        r_cache = write(r_cache, k_rope, length - pos0)
        c_f = c_cache.float()
        s = torch.einsum("bshr,btr->bhst", qa, c_f)
        s = (s + torch.einsum("bshd,btd->bhst", qr, r_cache.float())) * scale
        e, m, l = _masked_exp(s[:, :, 0], length + 1, pos0)
        o_lat = seq.combine(torch.einsum("bht,btr->bhr", e, c_f)
                            / l[..., None], m, l)  # (B, heads, r)
        if seq.gather_heads:
            h0 = seq.mesh.axis_index("model") * H
            o_lat = o_lat[:, h0:h0 + H]
        o_lat = o_lat[:, None]
    o = torch.einsum("bshr,rhd->bshd", o_lat,
                     p["wv_b"].reshape(r, H, dv).float())
    out = o.reshape(B, 1, H * dv).to(x.dtype) @ p["wo"]
    return out, (c_cache, r_cache)


def _write_at2(cache, row, length):
    """Write (B,1,D) rows into (B,T,D) at per-row length: a select by
    position, the reference's one-hot blend for finite values."""
    pos = torch.arange(cache.shape[1], device=cache.device)
    hit = (pos[None, :] == length[:, None])[:, :, None]
    return torch.where(hit, row.to(cache.dtype), cache)
