"""LM assembly: the reference's ``models/lm.py`` in PyTorch, all six
families: ``dense``, ``vlm``, ``moe`` (GQA or MLA), ``ssm`` (rwkv6),
``hybrid`` (jamba: mamba and attention) and ``encdec`` (whisper).

An architecture compiles to a list of **stages**; each stage runs
``repeat`` structurally-identical **groups** of layers, with the
parameters stacked on axis 0 as in the reference (whose ``lax.scan`` over
that axis becomes a Python loop over per-layer views).  A group is a list
of layer descriptors ``(mixer, ffn)``; ``make_program`` keeps every
family's program as data:

  dense (llama/qwen/llava):  1 stage x L  [(gqa, mlp)]
  mixtral:                   1 stage x L  [(gqa, moe)]
  deepseek-v3:               (mla, mlp) x3 dense head, then (mla, moe) x58
  jamba:                     4 periods of "mmmammmm" with MoE on odd slots
  rwkv6:                     1 stage x L  [(rwkv, rwkv_cm)]
  whisper:                   encoder (bidirectional gqa + mlp, its own
                             stack) + decoder stage (causal gqa + cross-attn)

``tp > 1`` raises ``NotImplementedError``.  Every RMSNorm -> projection
pair with a continuous output runs through ``ops.fused_norm_matmul``:
GQA's q, k and v (the encoder's too), MLA's three entries
(``models/attention.py``), mamba's ``w_in`` (``models/mamba.py``), the
cross-attention's ``cq``, the SwiGLU gate and up, and the shared expert's
gate and up (``models/moe.py``).  The MoE router is not such a pair (see
``_apply_ffn``); the rwkv mixer norms, then shifts, then projects, so it
has none (``models/rwkv.py``); the cross-attention's ``ck`` and ``cv``
read the encoder output, normalized already by ``enc_final_norm``, and
are plain products, as in the reference.  The parameter tree has the
reference's names and nesting, so ``params_from_reference`` carries the
reference's weights across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.outback import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as att
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import normal_init, rms_norm, silu, tree_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int32": torch.int32}


# --------------------------------------------------------------- templates
@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: tuple
    dtype: str = "bfloat16"
    scale: float | None = None  # None => 1/sqrt(fan_in)


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


_PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
# each mixer's cache leaves, in the order of its tuple form (whisper's
# cross-attention K/V are recomputed from the encoder output each step,
# so only the self-attention cache is stored)
_MIXER_CACHE = {"gqa": ("k", "v"), "gqa_cross": ("k", "v"),
                "mla": ("c", "r"), "mamba": ("h", "tail"),
                "rwkv": ("x", "s")}


def _require_ported(cfg: ModelConfig, tp: int) -> None:
    if cfg.family not in _PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is "
                                  f"not yet ported")
    if tp != 1:
        raise NotImplementedError(f"tensor parallelism (tp={tp}) is not yet "
                                  f"ported")


# ------------------------------------------------------------ layer descs
def make_program(cfg: ModelConfig):
    """-> list of stages; stage = (repeat, [ (mixer, ffn) ... ])."""
    if cfg.family in ("dense", "vlm"):
        return [(cfg.num_layers, [("gqa", "mlp")])]
    if cfg.family == "ssm":
        return [(cfg.num_layers, [("rwkv", "rwkv_cm")])]
    if cfg.family == "moe" and cfg.attn_kind == "mla":
        k = cfg.moe.first_k_dense
        prog = []
        if k:
            prog.append((k, [("mla", "mlp")]))
        prog.append((cfg.num_layers - k, [("mla", "moe")]))
        return prog
    if cfg.family == "moe":
        return [(cfg.num_layers, [("gqa", "moe")])]
    if cfg.family == "hybrid":
        pat = cfg.layer_pattern
        period = len(pat)
        if cfg.num_layers % period:
            raise ValueError(f"{cfg.num_layers} layers is not a whole number "
                             f"of {period}-layer periods")
        group = []
        for i, ch in enumerate(pat):
            mixer = "gqa" if ch == "a" else "mamba"
            ffn = "moe" if (cfg.moe and i % cfg.moe.every_k == 1) else "mlp"
            group.append((mixer, ffn))
        return [(cfg.num_layers // period, group)]
    if cfg.family == "encdec":
        return [(cfg.num_layers, [("gqa_cross", "mlp")])]
    raise ValueError(cfg.family)


# ------------------------------------------------------- param templates
def _mixer_template(kind: str, cfg: ModelConfig):
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    t = {}
    if kind in ("gqa", "gqa_cross"):
        sq = 1.0 / float(np.sqrt(d))
        so = 1.0 / float(np.sqrt(H * hd))
        for k, s in att.gqa_params_shape(cfg).items():
            if k in ("wq", "wk", "wv"):
                t[k] = Leaf(s, scale=sq)
            elif k == "wo":
                t[k] = Leaf(s, scale=so)
            else:
                t[k] = Leaf(s)
        if kind == "gqa_cross":  # the cross-attention's projections
            Hkv = cfg.num_kv_heads
            t["cq"] = Leaf((d, H, hd), scale=sq)
            t["ck"] = Leaf((d, Hkv, hd), scale=sq)
            t["cv"] = Leaf((d, Hkv, hd), scale=sq)
            t["co"] = Leaf((H, hd, d), scale=so)
            t["norm_cross"] = Leaf((d,))
    elif kind == "mla":
        t = {k: Leaf(s) for k, s in att.mla_params_shape(cfg).items()}
    elif kind == "mamba":  # in the model's dtype, as in the reference
        t = {k: Leaf(s, dtype="float32" if k in ("A_log", "D", "dt_bias")
                     else cfg.dtype)
             for k, s in mam.mamba_params_shape(cfg).items()}
    elif kind == "rwkv":
        for k, s in rwkv_mod.rwkv_params_shape(cfg).items():
            t[k] = Leaf(s, dtype="float32" if k in ("w0", "u")
                        else "bfloat16")
    else:
        raise ValueError(kind)
    t["norm"] = Leaf((d,))
    return t


def _ffn_template(kind: str, cfg: ModelConfig):
    if kind == "rwkv_cm":
        return {}  # rwkv channel-mix params live in the mixer's dict
    d, f = cfg.d_model, cfg.d_ff
    if kind == "mlp":
        t = {"w_gate": Leaf((d, f)), "w_up": Leaf((d, f)),
             "w_down": Leaf((f, d))}
    elif kind == "moe":  # router, the (E, d, f) banks, the shared s_*
        t = {k: Leaf(s) for k, s in moe_mod.moe_params_shape(cfg).items()}
    else:
        raise ValueError(kind)
    t["norm"] = Leaf((d,))
    return t


def param_template(cfg: ModelConfig, tp: int = 1):
    """Full parameter template tree: {embed, stages[...], final_norm, ...}."""
    _require_ported(cfg, tp)
    d, V = cfg.d_model, cfg.vocab_size
    t = {"embed": Leaf((V, d), scale=0.02), "final_norm": Leaf((d,))}
    if not cfg.tie_embeddings:
        t["lm_head"] = Leaf((V, d), scale=0.02)
    stages = []
    for repeat, group in make_program(cfg):
        gt = [{"mixer": _mixer_template(mixer, cfg),
               "ffn": _ffn_template(ffn, cfg)} for mixer, ffn in group]
        # prepend the layer-stack axis to every leaf
        stages.append(tree_map(
            lambda lf: Leaf((repeat, *lf.shape), lf.dtype, lf.scale), gt))
    t["stages"] = stages
    if cfg.is_encdec:  # the encoder: bidirectional gqa + mlp, stacked
        enc = {"mixer": _mixer_template("gqa", cfg),
               "ffn": _ffn_template("mlp", cfg)}
        t["encoder"] = tree_map(
            lambda lf: Leaf((cfg.encoder_layers, *lf.shape), lf.dtype,
                            lf.scale), enc)
        t["enc_final_norm"] = Leaf((d,))
    if cfg.mtp:
        t["mtp"] = {"mixer": _mixer_template(
            "mla" if cfg.attn_kind == "mla" else "gqa", cfg),
            "ffn": _ffn_template("mlp", cfg),
            "proj": Leaf((2 * d, d))}
    if cfg.vision_tokens:
        t["vision_proj"] = Leaf((d, d))  # stub anyres projector
    if cfg.is_encdec:
        t["frame_proj"] = Leaf((d, d))  # stub conv-frontend projector
    return t


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                dtype: torch.dtype | None = None, tp: int = 1):
    """Random weights from ``seed`` on ``device`` (CUDA unless given), with
    the reference's name-dispatched rules; ``dtype`` overrides every leaf's
    (bfloat16 by default, as in the reference)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tmpl = param_template(cfg, tp)

    def mk(name: str, lf: Leaf):
        dt = dtype or _DTYPES[lf.dtype]
        if any(s == 0 for s in lf.shape):
            return torch.zeros(lf.shape, dtype=dt, device=device)
        # name-dispatched special leaves (independent of the stack axis)
        if "norm" in name or name == "ln_x":
            return torch.ones(lf.shape, dtype=dt, device=device)
        if name.startswith("b") or name in ("dt_bias", "conv_b"):
            return torch.zeros(lf.shape, dtype=dt, device=device)
        if name.startswith("mu_"):
            return torch.full(lf.shape, 0.5, dtype=dt, device=device)
        if name == "w0":  # rwkv decay base: mild decay
            return torch.full(lf.shape, -1.0, dtype=dt, device=device)
        if name == "u":
            return normal_init(gen, lf.shape, 0.1, dt)
        if name == "A_log":  # mamba: A = -(1..N) on every channel
            n = torch.arange(1, lf.shape[-1] + 1, dtype=torch.float32,
                             device=device)
            return torch.log(n).expand(lf.shape).to(dt).contiguous()
        if name == "D":
            return torch.ones(lf.shape, dtype=dt, device=device)
        if len(lf.shape) >= 2:
            fan_in = lf.shape[-2]
            scale = lf.scale if lf.scale is not None else 1.0 / np.sqrt(fan_in)
            return normal_init(gen, lf.shape, float(scale), dt)
        return normal_init(gen, lf.shape, 0.1, dt)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return mk(name, tree)

    return walk(tmpl)


def _tensor_from_numpy(a) -> torch.Tensor:
    """A host array as a tensor; a bf16 array (``ml_dtypes``, as
    ``jax.device_get`` gives it) is taken by its bits, told by its dtype's
    name."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_reference(tree, *, device, dtype: torch.dtype | None = None):
    """The reference's parameter tree (host arrays) as the port's, with the
    same names and layer stacking, on ``device``; ``dtype`` casts every
    leaf (``torch.float32`` takes bf16 weights exactly)."""
    device = resolve_device(device)

    def conv(a):
        t = _tensor_from_numpy(a)
        return t.to(device=device, dtype=dtype or t.dtype)

    return tree_map(conv, tree)


# ------------------------------------------------------------- layer apply
def _apply_mixer(kind, p, x, cfg, *, positions, mode, cache, enc_out=None):
    """-> (x + mixer(x), new mixer cache, the sum unrounded or None).

    rwkv's residual sum also comes back in float32: the reference's
    compiled layer fuses that add into the channel mix's RMSNorm, which
    reads the sum before it is rounded to bf16.  ``gqa_cross`` adds the
    cross-attention to ``enc_out`` after the self-attention."""
    if kind == "rwkv":
        h = rms_norm(x, p["norm"])
        new_cache = None
        if mode == "train":
            out = rwkv_mod.time_mix(p, h, cfg, mode="train")
        else:
            out, new_cache = rwkv_mod.time_mix(p, h, cfg, mode=mode,
                                               cache=cache)
        return x + out, new_cache, x.float() + out.float()
    if kind == "mamba":
        if mode == "train":
            return (x + mam.mamba_apply(p, x, cfg, gamma=p["norm"],
                                        mode="train"), None, None)
        out, new_cache = mam.mamba_apply(p, x, cfg, gamma=p["norm"],
                                         mode=mode, cache=cache)
        return x + out, new_cache, None
    if kind not in ("gqa", "gqa_cross", "mla"):
        raise ValueError(kind)
    apply = att.mla_apply if kind == "mla" else att.gqa_apply
    new_cache = None
    if mode == "train":
        out = apply(p, x, cfg, gamma=p["norm"], positions=positions,
                    mode="train")
    else:
        out, new_cache = apply(p, x, cfg, gamma=p["norm"],
                               positions=positions, mode=mode, cache=cache)
    x = x + out
    if kind == "gqa_cross":
        x = x + _cross_attn(p, x, enc_out, cfg)
    return x, new_cache, None


def _cross_attn(p, x, enc_out, cfg):
    """Decoder cross-attention (whisper) of the un-normalized ``x`` to the
    (B, Se, d) encoder output: ``norm_cross`` -> ``cq`` is one fused
    launch; ``ck`` and ``cv`` project the encoder output, which
    ``enc_final_norm`` has normalized, as plain products."""
    B, S, d = x.shape
    H, hd = p["cq"].shape[1], p["cq"].shape[2]
    q = ops.fused_norm_matmul(x.reshape(B * S, d), p["norm_cross"],
                              p["cq"].reshape(d, H * hd)).view(B, S, H, hd)
    e = enc_out.to(x.dtype)
    k = torch.einsum("bsd,dhk->bshk", e, p["ck"])
    v = torch.einsum("bsd,dhk->bshk", e, p["cv"])
    o = att.flash_attention(q, att.repeat_kv(k, H), att.repeat_kv(v, H),
                            causal=False)
    return torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["co"])


def _apply_ffn(kind, p, x, cfg, mixer_p, *, mode, cache, x_sum=None):
    """-> (x, new ffn cache, the MoE aux loss or None).  SwiGLU with both
    entries through the fused norm -> matmul kernel; rwkv's channel mix
    normalises the unrounded residual sum ``x_sum`` with the mixer's
    ``ln_x`` and carries its token-shift input in the ffn cache.

    MoE, as the reference: ``h = rms_norm(x)`` once, in the model's dtype,
    feeds the router (in float32) and the expert bins.  The router does not
    go through the fused kernel: that kernel never rounds the normalized
    rows to bf16, so near-tied scores would pick other experts than the
    reference does, a different answer and not a rounding difference.  The
    shared expert's gate and up do (``norm_in``)."""
    if kind == "rwkv_cm":
        h = rms_norm(x_sum, mixer_p["ln_x"]).to(x.dtype)
        if mode == "train":
            return (x + rwkv_mod.channel_mix(mixer_p, h, mode="train"), None,
                    None)
        out, new_c = rwkv_mod.channel_mix(mixer_p, h, mode=mode, cache=cache)
        return x + out, new_c, None
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    if kind == "moe":
        h = rms_norm(x, p["norm"])
        norm_in = (x2d, p["norm"])
        if cfg.moe_gather_decode and B * S <= 64 and mode == "decode":
            out, aux = moe_mod.moe_gather_apply(p, h, cfg, norm_in=norm_in)
        else:
            out, aux = moe_mod.moe_apply_binned(
                p, h, cfg, capacity_factor=cfg.moe.capacity_factor,
                norm_in=norm_in)
        return x + out, cache, aux
    if kind != "mlp":
        raise ValueError(kind)
    g = ops.fused_norm_matmul(x2d, p["norm"], p["w_gate"])
    u = ops.fused_norm_matmul(x2d, p["norm"], p["w_up"])
    return (x + torch.matmul(silu(g) * u, p["w_down"]).view(B, S, d), cache,
            None)


def _group_body(group, lp, x, cfg, positions, mode, cache_g, enc_out=None):
    """One group of layers (``lp``: their parameters; ``cache_g``: each
    layer's ``(c_m, c_f)``, or None in train mode; ``enc_out``: the
    encoder output a ``gqa_cross`` layer reads) -> (x, the group's MoE
    aux loss (None without a MoE layer), each layer's ``(nc_m, nc_f)``):
    the body that remat wraps, so the recompute gives the same aux."""
    new_cache_g = []
    aux_g = None
    for li, (mixer, ffn) in enumerate(group):
        mp, fp = lp[li]["mixer"], lp[li]["ffn"]
        c_m, c_f = (None, None) if cache_g is None else cache_g[li]
        x, nc_m, x_sum = _apply_mixer(mixer, mp, x, cfg, positions=positions,
                                      mode=mode, cache=c_m, enc_out=enc_out)
        x, nc_f, aux = _apply_ffn(ffn, fp, x, cfg, mp, mode=mode, cache=c_f,
                                  x_sum=x_sum)
        if aux is not None:
            aux_g = aux if aux_g is None else aux_g + aux
        new_cache_g.append((nc_m, nc_f))
    return x, aux_g, new_cache_g


def _ce_chunk(hs, ls, emb):
    """Summed cross entropy of one chunk of positions: logits in the
    activation dtype, then float32, as the reference takes them."""
    logits = (hs @ emb.T.to(hs.dtype)).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, ls.long()[..., None])[..., 0]
    return (lse - gold).sum()


# --------------------------------------------------------------- the model
class LM:
    """A model bound to a config and a device (CUDA unless given): pure
    functions of the parameters and the cache, as in the reference."""

    def __init__(self, cfg: ModelConfig, tp: int = 1, *, device=None):
        _require_ported(cfg, tp)
        self.cfg = cfg
        self.tp = tp
        self.device = resolve_device(device)
        self.program = make_program(cfg)

    def init(self, seed: int = 0):
        return init_params(self.cfg, seed, device=self.device)

    # ---- embedding / unembedding
    def _embed(self, params, tokens):
        return params["embed"][tokens.long()].to(_dtype(self.cfg))

    def _unembed_logits(self, params, h):
        emb = params.get("lm_head", params["embed"])
        return h @ emb.T.to(h.dtype)

    # ---- encoder (whisper)
    def _encode(self, params, frames):
        """The encoder over (B, Se, d) frame embeddings: ``frame_proj``,
        then each layer's bidirectional attention without RoPE (whisper
        learns its positions; the stub frontend carries them) and its MLP,
        then ``enc_final_norm``.  q, k and v, and the gate and up, are
        fused launches."""
        cfg = self.cfg
        x = torch.matmul(frames.to(_dtype(cfg)), params["frame_proj"])
        B, S, d = x.shape
        H, hd = cfg.num_heads, cfg.head_dim
        enc = params["encoder"]
        views = {part: {k: v.unbind(0) for k, v in enc[part].items()}
                 for part in ("mixer", "ffn")}
        for i in range(cfg.encoder_layers):
            mp = {k: v[i] for k, v in views["mixer"].items()}
            fp = {k: v[i] for k, v in views["ffn"].items()}
            x2d = x.reshape(B * S, d)

            def proj(w):
                heads = w.shape[1]
                return ops.fused_norm_matmul(
                    x2d, mp["norm"], w.reshape(d, heads * hd)).view(
                        B, S, heads, hd)

            q, k, v = proj(mp["wq"]), proj(mp["wk"]), proj(mp["wv"])
            o = att.flash_attention(q, att.repeat_kv(k, H),
                                    att.repeat_kv(v, H), causal=False)
            x = x + torch.einsum("bshk,hkd->bsd", o.to(x.dtype), mp["wo"])
            x, _, _ = _apply_ffn("mlp", fp, x, cfg, mp, mode="train",
                                 cache=None)
        return rms_norm(x, params["enc_final_norm"])

    # ---- the layer stack
    def _stack(self, params, x, *, positions, mode, caches=None, length=None,
               remat=False, enc_out=None):
        """Run all stages.  ``caches``: the cache's per-stage trees, stacked
        on the layer axis (None in train mode); ``length`` is the shared
        per-row cache write position (decode); ``enc_out`` the encoder
        output (encdec).  With ``remat``, in train
        mode and with a gradient asked for, each group of layers runs under
        ``torch.utils.checkpoint`` (non-reentrant): its activations are
        recomputed in the backward, as the reference's
        ``jax.checkpoint(nothing_saveable)`` does.  Returns (x, the MoE
        layers' aux losses summed in layer order (None without a MoE
        layer), new_caches)."""
        cfg = self.cfg
        ckpt = remat and mode == "train" and torch.is_grad_enabled()
        new_caches = []
        aux_total = None
        for s_idx, ((repeat, group), sp) in enumerate(
                zip(self.program, params["stages"])):
            # every leaf's per-layer views at once: one backward node a leaf
            views = [{part: {k: v.unbind(0) for k, v in layer[part].items()}
                      for part in ("mixer", "ffn")} for layer in sp]
            new_layers = [[] for _ in group]
            for i in range(repeat):
                lp = [{part: {k: v[i] for k, v in lv[part].items()}
                       for part in ("mixer", "ffn")} for lv in views]
                cache_g = None
                if caches is not None:
                    cache_g = []
                    for li, (mixer, _) in enumerate(group):
                        c = caches[s_idx][li]
                        # the reference's tuple form of the layer's cache
                        c_m = tuple(c["mixer"][n][i]
                                    for n in _MIXER_CACHE[mixer])
                        if mixer in ("gqa", "gqa_cross", "mla"):
                            c_m = (*c_m, length)  # per-row write position
                        cache_g.append(
                            (c_m, None if c["ffn"] is None else c["ffn"][i]))
                args = (group, lp, x, cfg, positions, mode, cache_g, enc_out)
                x, aux_g, new_cache_g = (checkpoint(_group_body, *args,
                                                    use_reentrant=False)
                                         if ckpt else _group_body(*args))
                if aux_g is not None:
                    aux_total = aux_g if aux_total is None \
                        else aux_total + aux_g
                if caches is not None:
                    for li, nc in enumerate(new_cache_g):
                        new_layers[li].append(nc)
            if caches is not None:
                new_caches.append([
                    {"mixer": {n: torch.stack([m[j] for m, _ in layers])
                               for j, n in enumerate(_MIXER_CACHE[mixer])},
                     "ffn": (None if layers[0][1] is None else
                             torch.stack([f for _, f in layers]))}
                    for (mixer, _), layers in zip(group, new_layers)])
        return x, aux_total, (new_caches if caches is not None else None)

    # ---- training ----------------------------------------------------------
    def _inputs_embed(self, params, batch):
        """Token embeddings, behind the projected patch embeddings (vlm's
        stub anyres frontend: ``patches`` (B, P, d), a plain product)."""
        x = self._embed(params, batch["tokens"])
        if self.cfg.vision_tokens:
            vis = torch.matmul(batch["patches"].to(x.dtype),
                               params["vision_proj"])
            x = torch.cat([vis, x], dim=1)
        return x

    def _enc_out(self, params, batch):
        """The encoder's output of ``batch["frames"]`` (encdec), or None."""
        if not self.cfg.is_encdec:
            return None
        return self._encode(params, batch["frames"])

    def train_loss(self, params, batch, *, remat=True):
        """-> (loss, metrics).  ``batch``: tensors ``tokens`` and ``labels``
        (B, S) on the model's device, vlm's ``patches`` and encdec's
        ``frames`` (B, Se, d); only the text positions carry loss.  The MTP
        term (deepseek) and the MoE aux loss (``aux_loss_coef * aux /
        num_layers``) are added as in the reference, whose ``ce`` metric
        is the whole loss."""
        cfg = self.cfg
        x = self._inputs_embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        x, aux, _ = self._stack(params, x, positions=positions, mode="train",
                                remat=remat,
                                enc_out=self._enc_out(params, batch))
        x = rms_norm(x, params["final_norm"])
        if cfg.vision_tokens:
            x = x[:, cfg.vision_tokens:]
        labels = batch["labels"]
        loss = self._ce(params, x, labels)
        if cfg.mtp:
            loss = loss + 0.1 * self._mtp_loss(params, x, labels)
        if aux is None:  # no MoE layer
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.moe:
            loss = loss + cfg.moe.aux_loss_coef * aux / max(cfg.num_layers, 1)
        return loss, {"ce": loss, "aux": aux}

    def _ce(self, params, h, labels):
        """Cross entropy chunked over S by up to 512 positions, as the
        reference's non-vocab-parallel branch; with a gradient asked for,
        each chunk runs under ``torch.utils.checkpoint``, so its (B, chunk,
        V) float32 logits are recomputed in the backward rather than
        kept."""
        emb = params.get("lm_head", params["embed"])
        B, S, _ = h.shape
        chunk = max(1, min(512, S))
        n = S // chunk if S % chunk == 0 else 1
        chunk = S // n if n else S
        ckpt = torch.is_grad_enabled()
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(n):
            hs = h[:, i * chunk:(i + 1) * chunk]
            ls = labels[:, i * chunk:(i + 1) * chunk]
            part = (checkpoint(_ce_chunk, hs, ls, emb, use_reentrant=False)
                    if ckpt else _ce_chunk(hs, ls, emb))
            tot = tot + part
        return tot / (B * S)

    def _mtp_loss(self, params, h, labels):
        """Deepseek MTP: one extra block predicts token t+2 from [h_t;
        e_{t+1}]."""
        cfg = self.cfg
        S = h.shape[1]
        mp = params["mtp"]
        e_next = self._embed(params, labels)  # embedding of token t+1
        z = torch.cat([h[:, :-1], e_next[:, :-1]], dim=-1) @ \
            mp["proj"].to(h.dtype)
        pos = torch.arange(S - 1, device=h.device)[None]
        z, _, _ = _apply_mixer("mla" if cfg.attn_kind == "mla" else "gqa",
                               mp["mixer"], z, cfg, positions=pos,
                               mode="train", cache=None)
        z, _, _ = _apply_ffn("mlp", mp["ffn"], z, cfg, mp["mixer"],
                             mode="train", cache=None)
        return self._ce(params, z, labels[:, 1:])

    # ---- serving -----------------------------------------------------------
    def cache_template(self, batch: int, max_seq: int):
        """Tree of (shape, dtype) Leafs describing the decode cache."""
        cfg = self.cfg

        def mixer_cache(kind, repeat):
            if kind in ("gqa", "gqa_cross"):
                kv = Leaf((repeat, batch, max_seq, cfg.num_kv_heads,
                           cfg.head_dim), dtype=cfg.dtype)
                return {"k": kv, "v": kv}
            if kind == "mamba":  # the float32 SSM state and the conv tail
                mc = cfg.mamba
                di = mc.expand * cfg.d_model
                return {"h": Leaf((repeat, batch, di, mc.d_state),
                                  dtype="float32"),
                        "tail": Leaf((repeat, batch, mc.d_conv - 1, di),
                                     dtype=cfg.dtype)}
            if kind == "mla":  # the compressed latent and the rope key
                m = cfg.mla
                return {"c": Leaf((repeat, batch, max_seq, m.kv_lora_rank),
                                  dtype=cfg.dtype),
                        "r": Leaf((repeat, batch, max_seq,
                                   m.qk_rope_head_dim), dtype=cfg.dtype)}
            hs = cfg.rwkv_head_size
            H = cfg.d_model // hs
            return {"x": Leaf((repeat, batch, cfg.d_model), dtype=cfg.dtype),
                    "s": Leaf((repeat, batch, H, hs, hs), dtype="float32")}

        stages = []
        for repeat, group in self.program:
            stages.append([
                {"mixer": mixer_cache(mixer, repeat),
                 "ffn": (Leaf((repeat, batch, cfg.d_model), dtype=cfg.dtype)
                         if ffn == "rwkv_cm" else None)}
                for mixer, ffn in group])
        return {"stages": stages, "length": Leaf((batch,), dtype="int32")}

    def init_cache(self, batch: int, max_seq: int):
        return tree_map(
            lambda lf: torch.zeros(lf.shape, dtype=_DTYPES[lf.dtype],
                                   device=self.device),
            self.cache_template(batch, max_seq))

    def decode_step(self, params, tokens, cache, *, enc_out=None):
        """One token for every sequence. tokens (B,1) -> (logits (B,V),
        cache).  The cache is not changed: the step returns a new one.
        encdec reads ``enc_out`` (B, Se, d); without it, a zero encoder
        stub of (B, encoder_seq, d), made anew each step, as in the
        reference (whose ``Engine`` passes none either)."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        length = cache["length"]
        if cfg.is_encdec and enc_out is None:
            enc_out = torch.zeros((tokens.shape[0], cfg.encoder_seq,
                                   cfg.d_model), dtype=_dtype(cfg),
                                  device=x.device)
        x, _, new_stages = self._stack(params, x, positions=length[:, None],
                                       mode="decode", caches=cache["stages"],
                                       length=length, enc_out=enc_out)
        x = rms_norm(x, params["final_norm"])
        logits = self._unembed_logits(params, x[:, 0])
        return logits, {"stages": new_stages, "length": length + 1}

    def prefill(self, params, batch):
        """Full-sequence forward: logits at the last position (``batch``:
        ``tokens``, vlm's ``patches`` and encdec's ``frames``)."""
        x = self._inputs_embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        x, _, _ = self._stack(params, x, positions=positions, mode="train",
                              enc_out=self._enc_out(params, batch))
        x = rms_norm(x, params["final_norm"])
        return self._unembed_logits(params, x[:, -1])
