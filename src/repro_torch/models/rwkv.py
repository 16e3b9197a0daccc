"""RWKV6 ("Finch") block — the reference's ``models/rwkv.py`` in PyTorch.

Time-mix recurrence per head (K = V = head_size):

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,     w_t = exp(-exp(w0 + lora(x_t)))

Train/prefill use the **chunked** form: intra-chunk is a C x C masked
matmul with cumulative-decay weighting, inter-chunk applies the carried
state (the reference's ``lax.scan`` over chunks is a Python loop here).
Decode is a constant-size state update.

The float expressions are the reference's, in its order, and so are the
types: the projections and ``_decay``'s LoRA run in the activation dtype,
``w0 + lora`` promotes to float32 (``w0`` is a float32 leaf), and the state
and the recurrence are float32.  Token shift is a static learned lerp and
the norms are RMSNorm, as in the reference.  There is no norm -> projection
entry here (the mixer norms, then shifts, then projects), so nothing goes
through ``ops.fused_norm_matmul``.

On a mesh (``mesh``: a ``launch/mesh.py`` mesh whose ``model`` axis
splits the heads), the time mix runs the rank's heads: ``w_r``, ``w_k``,
``w_v`` and ``w_g`` are its column shards, ``w0``, ``u`` and the state its
heads, ``w_o`` its row shard, and it returns its partial sum (the caller
adds the psum).  The decay LoRA is replicated: the rank takes its heads'
columns of ``wl_b``.  The channel mix splits ``c_k`` by columns and ``c_v``
by rows, with one psum before the replicated ``c_r`` gate.  Every
replicated value that only the rank's share reads enters through
``Mesh.copy_to``, so its gradient sums over ``model``; the token-shift
caches stay replicated.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import xla_sigmoid

_CLIP = 80.0  # exponent safety net; inactive for w_log in [-WLOG_FLOOR, 0]
_LORA = 32  # decay LoRA rank
WLOG_FLOOR = 4.0  # per-step decay floor e^-4: with chunk 16 the cumulative
# exponent stays within +-64, exactly representable in f32, so the chunked
# factorization is exact.


def rwkv_params_shape(cfg):
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    H = d // hs
    return {
        "mu_r": (d,), "mu_k": (d,), "mu_v": (d,), "mu_w": (d,), "mu_g": (d,),
        "w_r": (d, d), "w_k": (d, d), "w_v": (d, d), "w_g": (d, d),
        "w_o": (d, d),
        "w0": (H, hs), "wl_a": (d, _LORA), "wl_b": (_LORA, d),
        "u": (H, hs),
        "ln_x": (d,),
        # channel mix
        "mu_ck": (d,), "mu_cr": (d,),
        "c_k": (d, cfg.d_ff), "c_v": (cfg.d_ff, d), "c_r": (d, d),
    }


def _decay(p, xw):
    """Data-dependent per-channel decay logits (B,S,H,hs), log-space <= 0."""
    H, hs = p["w0"].shape
    lora = torch.tanh(xw @ p["wl_a"]) @ p["wl_b"]
    w_log = -torch.exp(torch.clamp(p["w0"].reshape(-1) + lora, -8.0, 4.0))
    w_log = torch.clamp_min(w_log, -WLOG_FLOOR)
    return w_log.reshape(*xw.shape[:-1], H, hs)  # negative log-decay


def _shift(x, x_prev):
    """Token shift: x_{t-1} sequence (B,S,d) given previous-token carry."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def time_mix(p, x, cfg, *, mode, cache=None, chunk: int = 16, mesh=None):
    B, S, d_all = x.shape
    hs = cfg.rwkv_head_size
    H = p["w0"].shape[0]  # the rank's heads on a mesh
    d = H * hs
    if mesh is not None:  # replicated values that only our heads read
        f = mesh.copy_to
        c0 = mesh.axis_index("model") * d
        p = dict(p, **{k: f(p[k]) for k in ("mu_r", "mu_k", "mu_v", "mu_w",
                                            "mu_g", "wl_a")},
                 wl_b=f(p["wl_b"])[:, c0:c0 + d])
        x = f(x)

    if mode == "decode":
        x_prev, state = cache  # (B,d), (B,H,hs,hs)
        xs = x_prev[:, None]
    else:
        x_prev = torch.zeros((B, d_all), dtype=x.dtype, device=x.device)
        state = torch.zeros((B, H, hs, hs), dtype=torch.float32,
                            device=x.device)
        xs = _shift(x, x_prev)

    def mix(mu):
        return x + (xs - x) * mu

    r = (mix(p["mu_r"]) @ p["w_r"]).reshape(B, S, H, hs)
    k = (mix(p["mu_k"]) @ p["w_k"]).reshape(B, S, H, hs)
    v = (mix(p["mu_v"]) @ p["w_v"]).reshape(B, S, H, hs)
    gp = mix(p["mu_g"]) @ p["w_g"]
    g = gp * xla_sigmoid(gp)  # silu
    w_log = _decay(p, mix(p["mu_w"]))  # (B,S,H,hs), <= 0

    rf, kf, vf = r.float(), k.float(), v.float()
    u = p["u"].float()

    if mode == "decode":
        # y = r (S + diag(u) k v^T); S' = diag(w) S + k v^T
        kv = torch.einsum("bshk,bshv->bhkv", kf, vf)
        y = torch.einsum("bshk,bhkv->bshv", rf,
                         state + u[None, :, :, None] * kv)
        new_state = torch.exp(w_log[:, 0])[..., None] * state + kv
        out = (y.reshape(B, S, d).to(x.dtype) * g) @ p["w_o"]
        return out, (x[:, -1], new_state)

    # ---- chunked parallel form -------------------------------------------
    C = min(chunk, S)
    if S % C:
        raise ValueError(f"sequence length {S} is not a whole number of "
                         f"{C}-token chunks")
    n = S // C

    def chunks(a):  # (B,S,H,hs) -> (n,B,H,C,hs)
        return a.reshape(B, n, C, H, hs).permute(1, 0, 3, 2, 4)

    rc, kc, vc = chunks(rf), chunks(kf), chunks(vf)
    wc = chunks(w_log.float())
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device),
                     diagonal=-1)
    eye = torch.eye(C, dtype=torch.float32, device=x.device)
    ys = []
    for i in range(n):
        r_, k_, v_, w_ = rc[i], kc[i], vc[i], wc[i]  # (B,H,C,hs)
        cw = torch.cumsum(w_, dim=2)  # inclusive cumulative log-decay
        cw_excl = cw - w_  # exclusive
        # intra-chunk: A[i,l] = sum_k r_i k_l exp(cw_excl_i - cw_l), l < i
        r_t = r_ * torch.exp(torch.clamp(cw_excl, -_CLIP, _CLIP))
        k_t = k_ * torch.exp(torch.clamp(-cw, -_CLIP, _CLIP))
        A = torch.einsum("bhik,bhlk->bhil", r_t, k_t)
        A = torch.where(tri[None, None], A, 0.0)
        # diagonal: the current token's own (u-boosted) contribution
        diag = torch.einsum("bhik,bhik->bhi", r_ * u[None, :, None, :], k_)
        A = A + diag[..., None] * eye[None, None]
        y_intra = torch.einsum("bhil,bhlv->bhiv", A, v_)
        y_inter = torch.einsum("bhik,bhkv->bhiv", r_t, state)
        # state update: S' = diag(exp(cw_C)) S0 + sum_l exp(cw_C - cw_l) k_l v_l
        wC = cw[:, :, -1:, :]  # (B,H,1,hs)
        k_dec = k_ * torch.exp(torch.clamp(wC - cw, -_CLIP, _CLIP))
        state = torch.exp(torch.clamp(wC[:, :, 0, :], -_CLIP, _CLIP)
                          )[..., None] * state \
            + torch.einsum("bhlk,bhlv->bhkv", k_dec, v_)
        ys.append(y_intra + y_inter)
    # (n,B,H,C,hs) -> (B,n*C,H*hs)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, S, d)
    out = (y.to(x.dtype) * g) @ p["w_o"]
    if mode == "prefill":
        return out, (x[:, -1], state)
    return out


def channel_mix(p, x, *, mode, cache=None, mesh=None):
    B, S, d = x.shape

    def shifted(x):
        if mode == "decode":
            return cache[:, None]
        return _shift(x, torch.zeros((B, d), dtype=x.dtype, device=x.device))

    xs = shifted(x)
    xr = x + (xs - x) * p["mu_cr"]
    mu_ck = p["mu_ck"]
    if mesh is not None:  # c_k's columns and c_v's rows are the rank's
        xk_in, mu_ck = mesh.copy_to(x), mesh.copy_to(mu_ck)
        xk = xk_in + (shifted(xk_in) - xk_in) * mu_ck
    else:
        xk = x + (xs - x) * mu_ck
    h = torch.square(torch.relu(xk @ p["c_k"])) @ p["c_v"]
    if mesh is not None:
        h = mesh.reduce_from(h)
    out = xla_sigmoid(xr @ p["c_r"]) * h
    if mode == "train":
        return out
    return out, x[:, -1]


def rwkv_init_cache(cfg, batch, dtype, device=None):
    d = cfg.d_model
    hs = cfg.rwkv_head_size
    H = d // hs
    return {
        "att_x": torch.zeros((batch, d), dtype=dtype, device=device),
        "att_s": torch.zeros((batch, H, hs, hs), dtype=torch.float32,
                             device=device),
        "ffn_x": torch.zeros((batch, d), dtype=dtype, device=device),
    }
