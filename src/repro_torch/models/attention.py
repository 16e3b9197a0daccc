"""Attention, GQA (full / sliding-window): the reference's
``models/attention.py`` in PyTorch, full-sequence and decode paths.

The q, k and v projections enter through ``ops.fused_norm_matmul``: the
caller passes the un-normalized activation and the mixer's RMSNorm gamma,
and each projection is one kernel launch on a view of the head-major
weight, with no copy.  ``flash_attention`` and ``decode_attention`` are
plain PyTorch, as the reference computes them outside any Pallas kernel.
MLA waits for the family that needs it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rms_norm

NEG_INF = -1e30


def repeat_kv(k, n_heads: int):
    """GQA repeat: (B,S,Hkv,d) -> (B,S,H,d); head h reads kv head h // g."""
    Hkv = k.shape[2]
    if Hkv == n_heads:
        return k
    idx = torch.arange(n_heads, device=k.device) // (n_heads // Hkv)
    return k.index_select(2, idx)


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
    pos = torch.arange(k_cache.shape[1], device=q.device)[None, None, :]
    mask = pos < length[:, None, None]
    if window is not None:
        mask &= pos > (length[:, None, None] - 1 - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bshd->bhd", p, vf)
    return o.reshape(B, 1, H, d).to(q.dtype)


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


def gqa_kv_map(cfg, H_eff: int, device=None):
    """Static q-head -> kv-head mapping (head h reads kv head h // g); pad
    heads beyond cfg.num_heads map as the last real head does."""
    g = max(1, cfg.num_heads // cfg.num_kv_heads)
    idx = torch.clamp(torch.arange(H_eff, device=device),
                      max=cfg.num_heads - 1)
    return idx // g


def gqa_apply(p, x, cfg, *, gamma, positions, mode: str, cache=None):
    """mode: 'train' (the full sequence, no cache) | 'decode' (one token
    against ``cache``, returns the new cache).

    ``x`` (B,S,d) is the un-normalized residual stream and ``gamma`` the
    mixer's RMSNorm weight: each of q, k and v is one
    ``ops.fused_norm_matmul`` launch.  ``H`` is read from the weights."""
    B, S, d = x.shape
    H, hd = p["wq"].shape[1], cfg.head_dim
    Hkv = p["wk"].shape[1]
    x2d = x.reshape(B * S, d)

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
    kv_idx = gqa_kv_map(cfg, H, device=x.device)
    if mode == "train":
        o = flash_attention(q, k.index_select(2, kv_idx),
                            v.index_select(2, kv_idx), causal=True,
                            window=window)
        return torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["wo"])
    # decode: cache = (k_cache, v_cache, length); the new token is written at
    # per-row `length` (positions = length for RoPE). SWA uses a rolling
    # cache: slot = length % window_size, all-written-slots valid.
    _, _, length = cache
    W = cache[0].shape[1]
    rolling = window is not None and W <= window
    slot = length % W if rolling else length
    k_cache = _write_at(cache[0], k, slot)
    v_cache = _write_at(cache[1], v, slot)
    if rolling:
        valid = torch.clamp(length + 1, max=W)
        o = decode_attention(q, k_cache, v_cache, valid, window=None,
                             kv_idx=kv_idx)
    else:
        o = decode_attention(q, k_cache, v_cache, length + 1, window=window,
                             kv_idx=kv_idx)
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
