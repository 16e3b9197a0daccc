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

Tensor parallelism (``tp > 1``) runs over a ``launch/mesh.py`` mesh for
every mixer (gqa and whisper's encoder and cross-attention by heads, mla
by heads, mamba by channels, rwkv by heads), the MLP and the MoE
(``moe_spmd``; ``moe_gather_spmd`` at decode with ``moe_gather_decode``),
with the reference's specs (``param_pspecs``; ``pad_attn_heads`` pads the
q heads to a multiple of tp) and a vocab-parallel embedding, logits and
cross entropy: each rank runs its share with the collectives where the
reference's GSPMD puts them (``LM``).  In serving, the batch and the cache
split over a data axis, and the cache's sequence splits where the
reference's specs split it (``cache_template``): over ``data`` (``("pod",
"data")`` on a pod mesh) for a batch-1 cache, the ``long_500k`` shape,
and over ``model`` under ``cache_seq_shard``; attention then combines the
ranks' flash partials (``attention.SeqSplit``).  Every RMSNorm ->
projection pair with a continuous output runs through
``ops.fused_norm_matmul``:
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
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import BATCH_AXES
from repro_torch.models import attention as att
from repro_torch.models import mamba as mam
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import (Spec, normal_init, rms_norm, silu,
                                       tree_map)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int32": torch.int32}


# --------------------------------------------------------------- templates
@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: tuple
    dtype: str = "bfloat16"
    scale: float | None = None  # None => 1/sqrt(fan_in)
    spec: Spec = Spec()  # the reference's PartitionSpec, as a Spec


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _tp(dim: int, tp: int) -> bool:
    return tp > 1 and dim % tp == 0


_PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
# each mixer's cache leaves, in the order of its tuple form (whisper's
# cross-attention K/V are recomputed from the encoder output each step,
# so only the self-attention cache is stored)
_MIXER_CACHE = {"gqa": ("k", "v"), "gqa_cross": ("k", "v"),
                "mla": ("c", "r"), "mamba": ("h", "tail"),
                "rwkv": ("x", "s")}


def _require_family(cfg: ModelConfig) -> None:
    if cfg.family not in _PORTED_FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} ({cfg.name}) is "
                                  f"not yet ported")


def _require_ported(cfg: ModelConfig, tp: int) -> None:
    """The family is ported, and at ``tp > 1`` every mixer's specs split
    whole heads (or channels)."""
    _require_family(cfg)
    if tp == 1:
        return
    for _, group in make_program(cfg):
        for mixer, _ in group:
            _splits(mixer, cfg, tp)


def _splits(kind: str, cfg: ModelConfig, tp: int) -> bool:
    """Whether the reference's specs split mixer ``kind`` over ``model`` at
    ``tp``; ``ValueError`` where they would cut a head (or mamba's ``x``
    and ``z`` unevenly), which no rank's program can run."""
    if tp == 1:
        return False
    if kind in ("gqa", "gqa_cross"):
        return _tp(q_heads(cfg, tp), tp)
    if kind == "mla":
        m = cfg.mla
        cuts = {_tp(cfg.num_heads * n, tp) for n in (
            m.qk_nope_head_dim + m.qk_rope_head_dim, m.qk_nope_head_dim,
            m.v_head_dim)}
        split, heads = cuts == {True}, _tp(cfg.num_heads, tp)
    elif kind == "mamba":
        di = cfg.mamba.expand * cfg.d_model
        split = heads = _tp(di, tp)
        cuts = {_tp(2 * di, tp), split}
    elif kind == "rwkv":
        heads = _tp(cfg.d_model // cfg.rwkv_head_size, tp)
        split, cuts = heads, {_tp(cfg.d_model, tp), heads}
    else:
        raise ValueError(kind)
    if len(cuts) > 1 or split != heads:
        raise ValueError(f"the {kind!r} mixer of {cfg.name} does not split "
                         f"into whole heads (or channels) over {tp} ranks")
    return split


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
_COL, _ROW, _REP = Spec(None, "model"), Spec("model", None), Spec()


def q_heads(cfg: ModelConfig, tp: int) -> int:
    """The q heads of the parameters: ``num_heads``, padded up to a
    multiple of ``tp`` under ``pad_attn_heads``."""
    if cfg.pad_attn_heads and tp > 1:
        return -(-cfg.num_heads // tp) * tp
    return cfg.num_heads


def _mixer_template(kind: str, cfg: ModelConfig, tp: int = 1):
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    col = lambda s: _COL if _tp(s[-1], tp) else _REP
    row = lambda s: _ROW if _tp(s[0], tp) else _REP
    t = {}
    if kind in ("gqa", "gqa_cross"):
        # head-major projections: the head axis is split, never a head;
        # attention is replicated when the q heads do not divide tp
        H_eff = q_heads(cfg, tp)
        qspec = Spec(None, "model", None) if _tp(H_eff, tp) else _REP
        kvspec = Spec(None, "model", None) if _tp(Hkv, tp) else _REP
        ospec = Spec("model", None, None) if _tp(H_eff, tp) else _REP
        sq = 1.0 / float(np.sqrt(d))
        so = 1.0 / float(np.sqrt(H * hd))
        for k, s in att.gqa_params_shape(cfg).items():
            s = tuple(H_eff if x == H else x for x in s)
            if k == "wq":
                t[k] = Leaf(s, scale=sq, spec=qspec)
            elif k in ("wk", "wv"):
                t[k] = Leaf(s, scale=sq, spec=kvspec)
            elif k == "wo":
                t[k] = Leaf(s, scale=so, spec=ospec)
            elif k == "bq":
                t[k] = Leaf(s, spec=_ROW if _tp(H, tp) else _REP)
            elif k in ("bk", "bv"):
                t[k] = Leaf(s, spec=_ROW if _tp(Hkv, tp) else _REP)
            else:
                t[k] = Leaf(s)
        if kind == "gqa_cross":  # the cross-attention's projections
            t["cq"] = Leaf((d, H, hd), scale=sq, spec=qspec)
            t["ck"] = Leaf((d, Hkv, hd), scale=sq, spec=kvspec)
            t["cv"] = Leaf((d, Hkv, hd), scale=sq, spec=kvspec)
            t["co"] = Leaf((H, hd, d), scale=so, spec=ospec)
            t["norm_cross"] = Leaf((d,))
    elif kind == "mla":
        for k, s in att.mla_params_shape(cfg).items():
            spec = (col(s) if k in ("wq_b", "wk_b", "wv_b")
                    else row(s) if k == "wo" else _REP)
            t[k] = Leaf(s, spec=spec)
    elif kind == "mamba":  # in the model's dtype, as in the reference
        di = cfg.mamba.expand * d
        spec = {"w_in": _COL if _tp(2 * di, tp) else _REP,
                "conv_w": _COL if _tp(di, tp) else _REP,
                "conv_b": Spec("model") if _tp(di, tp) else _REP,
                "w_bcdt": _ROW if _tp(di, tp) else _REP,
                "w_dt": _COL if _tp(di, tp) else _REP,
                "dt_bias": Spec("model") if _tp(di, tp) else _REP,
                "A_log": _ROW if _tp(di, tp) else _REP,
                "D": Spec("model") if _tp(di, tp) else _REP,
                "w_out": _ROW if _tp(di, tp) else _REP}
        t = {k: Leaf(s, dtype="float32" if k in ("A_log", "D", "dt_bias")
                     else cfg.dtype, spec=spec[k])
             for k, s in mam.mamba_params_shape(cfg).items()}
    elif kind == "rwkv":
        for k, s in rwkv_mod.rwkv_params_shape(cfg).items():
            if k in ("w_r", "w_k", "w_v", "w_g", "c_k"):
                t[k] = Leaf(s, spec=col(s))
            elif k in ("w_o", "c_v"):
                t[k] = Leaf(s, spec=row(s))
            elif k in ("w0", "u"):
                t[k] = Leaf(s, dtype="float32", spec=row(s))
            else:
                t[k] = Leaf(s)
    else:
        raise ValueError(kind)
    t["norm"] = Leaf((d,))
    return t


def _ffn_template(kind: str, cfg: ModelConfig, tp: int = 1):
    if kind == "rwkv_cm":
        return {}  # rwkv channel-mix params live in the mixer's dict
    d, f = cfg.d_model, cfg.d_ff
    if kind == "mlp":
        sc, sr = (_COL, _ROW) if _tp(f, tp) else (_REP, _REP)
        t = {"w_gate": Leaf((d, f), spec=sc), "w_up": Leaf((d, f), spec=sc),
             "w_down": Leaf((f, d), spec=sr)}
    elif kind == "moe":  # router, the (E, d, f) banks, the shared s_*
        m = cfg.moe
        ep = Spec("model", None, None) if _tp(m.num_experts, tp) else _REP
        fs = m.d_ff_expert * m.num_shared
        sc, sr = (_COL, _ROW) if _tp(fs, tp) else (_REP, _REP)
        spec = {"router": _REP, "w_gate": ep, "w_up": ep, "w_down": ep,
                "s_gate": sc, "s_up": sc, "s_down": sr}
        t = {k: Leaf(s, spec=spec[k])
             for k, s in moe_mod.moe_params_shape(cfg).items()}
    else:
        raise ValueError(kind)
    t["norm"] = Leaf((d,))
    return t


def _stacked(tree, repeat: int):
    """Every leaf with the layer-stack axis prepended (spec ``None``)."""
    return tree_map(lambda lf: Leaf((repeat, *lf.shape), lf.dtype, lf.scale,
                                    Spec(None, *lf.spec)), tree)


def param_template(cfg: ModelConfig, tp: int = 1):
    """Full parameter template tree: {embed, stages[...], final_norm, ...};
    each leaf's shape is the whole array's (with ``pad_attn_heads``'s q
    heads at ``tp``) and its spec the reference's at ``tp``.  The specs
    cover every family, also where its sharded program is not ported."""
    _require_family(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    vspec = _ROW if _tp(V, tp) else _REP
    t = {"embed": Leaf((V, d), scale=0.02, spec=vspec),
         "final_norm": Leaf((d,))}
    if not cfg.tie_embeddings:
        t["lm_head"] = Leaf((V, d), scale=0.02, spec=vspec)
    t["stages"] = [_stacked([{"mixer": _mixer_template(mixer, cfg, tp),
                              "ffn": _ffn_template(ffn, cfg, tp)}
                             for mixer, ffn in group], repeat)
                   for repeat, group in make_program(cfg)]
    if cfg.is_encdec:  # the encoder: bidirectional gqa + mlp, stacked
        t["encoder"] = _stacked({"mixer": _mixer_template("gqa", cfg, tp),
                                 "ffn": _ffn_template("mlp", cfg, tp)},
                                cfg.encoder_layers)
        t["enc_final_norm"] = Leaf((d,))
    if cfg.mtp:
        t["mtp"] = {"mixer": _mixer_template(
            "mla" if cfg.attn_kind == "mla" else "gqa", cfg, tp),
            "ffn": _ffn_template("mlp", cfg, tp),
            "proj": Leaf((2 * d, d))}
    if cfg.vision_tokens:
        t["vision_proj"] = Leaf((d, d))  # stub anyres projector
    if cfg.is_encdec:
        t["frame_proj"] = Leaf((d, d))  # stub conv-frontend projector
    return t


def param_pspecs(cfg: ModelConfig, tp: int = 1):
    """The template's specs, a tree of :class:`Spec`."""
    return tree_map(lambda lf: lf.spec, param_template(cfg, tp))


def abstract_params(cfg: ModelConfig, tp: int = 1):
    """The whole parameters as tensors on the ``meta`` device (shape and
    dtype, no storage): the reference's ``ShapeDtypeStruct`` tree."""
    return tree_map(lambda lf: torch.empty(lf.shape, dtype=_DTYPES[lf.dtype],
                                           device="meta"),
                    param_template(cfg, tp))


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None,
                dtype: torch.dtype | None = None, tp: int = 1, mesh=None):
    """Random weights from ``seed`` on ``device`` (CUDA unless given), with
    the reference's name-dispatched rules; ``dtype`` overrides every leaf's
    (bfloat16 by default, as in the reference).  The leaves are drawn
    whole, in one order, so every rank draws the same model; with
    ``mesh`` (whose ``model`` size is ``tp``) each rank keeps only its
    slice of each leaf, a contiguous tensor of its own, and the whole leaf
    is freed before the next is drawn."""
    if mesh is not None:
        tp = mesh.shape.get("model", 1)
        device = mesh.device if device is None else device
    _require_ported(cfg, tp)
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

    def mk_local(name: str, lf: Leaf):
        full = mk(name, lf)
        if mesh is None:
            return full
        return mesh_mod.local_slice(full, lf.spec, mesh)

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return mk_local(name, tree)

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
def _gqa_shard(p, x, cfg, par):
    """This rank's share of a gqa mixer whose q heads split over ``par``'s
    ``model`` axis -> (leaves, x, gamma, q0, kv0).  The rank holds heads
    ``q0..`` (and kv heads ``kv0..`` when they split, else all): the
    activation and gamma enter through ``copy_to`` (the fused norm's dx
    and dgamma are partial sums), as does every replicated leaf that only
    the local heads read (kv weights, ``bq`` of padded heads, which the
    rank slices, the q/k norms).  Where the q heads do not split,
    attention runs replicated, with no collective (``_splits``)."""
    tp = par.shape["model"]
    f = par.copy_to
    r = par.axis_index("model")
    h_loc = p["wq"].shape[1]
    q0 = r * h_loc
    kv_split = _tp(cfg.num_kv_heads, tp)
    kv0 = r * p["wk"].shape[1] if kv_split else 0
    lp = dict(p)
    for k in ("q_norm", "k_norm") + (() if kv_split else
                                     ("wk", "wv", "bk", "bv")):
        if k in lp:
            lp[k] = f(lp[k])
    if "bq" in lp and not _tp(cfg.num_heads, tp):  # replicated, padded
        lp["bq"] = f(lp["bq"])[q0:q0 + h_loc]
    return lp, f(x), f(p["norm"]), q0, kv0


def _apply_mixer(kind, p, x, cfg, *, positions, mode, cache, enc_out=None,
                 par=None, seq=None):
    """-> (x + mixer(x), new mixer cache, the sum unrounded or None).

    rwkv's residual sum also comes back in float32: the reference's
    compiled layer fuses that add into the channel mix's RMSNorm, which
    reads the sum before it is rounded to bf16 (over a mesh, the sum after
    the psum).  ``gqa_cross`` adds the cross-attention to ``enc_out`` after
    the self-attention.  ``par``: the mesh whose ``model`` axis splits the
    layers, or None; a split mixer returns its partial sum, which one psum
    completes (``wo``, ``co``, rwkv's ``w_o`` and mamba's ``w_out`` are
    row-split).  ``seq``: the decode cache's sequence split
    (``attention.SeqSplit``), or None; it reaches the mixers that keep a
    sequence cache (gqa and mla), which gather their heads over ``model``
    when the sequence splits over it too."""
    split = par is not None and _splits(kind, cfg, par.shape["model"])
    f = par.copy_to if split else None
    if seq is not None:
        seq = dataclasses.replace(seq, gather_heads=split
                                  and "model" in seq.axes)

    def run(fn, *args, **kw):
        if mode == "train":
            return fn(*args, mode="train", **kw), None
        return fn(*args, mode=mode, cache=cache, **kw)

    def reduced(out):
        return par.reduce_from(out) if split else out

    if kind in ("gqa", "gqa_cross"):
        lp, xin, gamma, q0, kv0 = p, x, p["norm"], 0, 0
        if split:
            lp, xin, gamma, q0, kv0 = _gqa_shard(p, x, cfg, par)
        out, new_cache = run(att.gqa_apply, lp, xin, cfg, gamma=gamma,
                             positions=positions, q0=q0, kv0=kv0, seq=seq)
        x = x + reduced(out)
        if kind == "gqa_cross":
            x = x + reduced(_cross_attn(p, x, enc_out, cfg,
                                        par if split else None))
        return x, new_cache, None
    if kind == "mla":
        out, new_cache = run(att.mla_apply, p, x, cfg, gamma=p["norm"],
                             positions=positions, copy=f, seq=seq)
        return x + reduced(out), new_cache, None
    if kind == "rwkv":
        h = rms_norm(x, p["norm"])
        out, new_cache = run(rwkv_mod.time_mix, p, h, cfg,
                             mesh=par if split else None)
        out = reduced(out)
        return x + out, new_cache, x.float() + out.float()
    if kind == "mamba":
        out, new_cache = run(mam.mamba_apply, p, x, cfg, gamma=p["norm"],
                             mesh=par if split else None)
        return x + reduced(out), new_cache, None
    raise ValueError(kind)


def _cross_attn(p, x, enc_out, cfg, par=None):
    """Decoder cross-attention (whisper) of the un-normalized ``x`` to the
    (B, Se, d) encoder output: ``norm_cross`` -> ``cq`` is one fused
    launch; ``ck`` and ``cv`` project the encoder output, which
    ``enc_final_norm`` has normalized, as plain products.  With ``par``
    (the heads split over its ``model`` axis) the rank runs its heads of
    ``cq``, ``ck``, ``cv`` and ``co`` and returns its partial sum; ``x``,
    ``norm_cross`` and replicated kv weights enter through ``copy_to``
    (``enc_out`` has entered already, once for the whole stack)."""
    B, S, d = x.shape
    gamma, ck, cv = p["norm_cross"], p["ck"], p["cv"]
    H, hd = p["cq"].shape[1], p["cq"].shape[2]
    q0 = kv0 = 0
    if par is not None:
        f = par.copy_to
        x, gamma = f(x), f(gamma)
        q0 = par.axis_index("model") * H
        if _tp(cfg.num_kv_heads, par.shape["model"]):
            kv0 = par.axis_index("model") * ck.shape[1]
        else:
            ck, cv = f(ck), f(cv)
    q = ops.fused_norm_matmul(x.reshape(B * S, d), gamma,
                              p["cq"].reshape(d, H * hd)).view(B, S, H, hd)
    e = enc_out.to(x.dtype)
    k = torch.einsum("bsd,dhk->bshk", e, ck)
    v = torch.einsum("bsd,dhk->bshk", e, cv)
    heads = att.gqa_kv_heads(cfg, H, q0, kv0)
    o = att.flash_attention(q, att.expand_kv(k, heads),
                            att.expand_kv(v, heads), causal=False)
    return torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["co"])


def _apply_ffn(kind, p, x, cfg, mixer_p, *, mode, cache, x_sum=None,
               par=None):
    """-> (x, new ffn cache, the MoE aux loss or None).  SwiGLU with both
    entries through the fused norm -> matmul kernel; rwkv's channel mix
    normalises the unrounded residual sum ``x_sum`` with the mixer's
    ``ln_x`` and carries its token-shift input in the ffn cache.

    MoE, as the reference: ``h = rms_norm(x)`` once, in the model's dtype,
    feeds the router (in float32) and the expert bins.  The router does not
    go through the fused kernel: that kernel never rounds the normalized
    rows to bf16, so near-tied scores would pick other experts than the
    reference does, a different answer and not a rounding difference.  The
    shared expert's gate and up do (``norm_in``).

    ``par``: the mesh whose ``model`` axis splits the ffn, or None.  The
    MLP splits gate and up by columns and ``w_down`` by rows (one psum)
    when ``d_ff`` divides, and so does rwkv's channel mix (``c_k``,
    ``c_v``); the MoE runs ``moe_spmd`` (``moe_gather_spmd`` at decode
    with ``moe_gather_decode``)."""
    if kind == "rwkv_cm":
        h = rms_norm(x_sum, mixer_p["ln_x"]).to(x.dtype)
        mesh = par if par is not None and _tp(cfg.d_ff, par.shape["model"]) \
            else None
        if mode == "train":
            return (x + rwkv_mod.channel_mix(mixer_p, h, mode="train",
                                             mesh=mesh), None, None)
        out, new_c = rwkv_mod.channel_mix(mixer_p, h, mode=mode, cache=cache,
                                          mesh=mesh)
        return x + out, new_c, None
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    if kind == "moe":
        h = rms_norm(x, p["norm"])
        norm_in = (x2d, p["norm"])
        if cfg.moe_gather_decode and B * S <= 64 and mode == "decode":
            out, aux = (moe_mod.moe_gather_spmd(p, h, cfg, par,
                                                norm_in=norm_in)
                        if par is not None else
                        moe_mod.moe_gather_apply(p, h, cfg, norm_in=norm_in))
        elif par is not None:
            out, aux = moe_mod.moe_spmd(p, h, cfg, par, norm_in=norm_in)
        else:
            out, aux = moe_mod.moe_apply_binned(
                p, h, cfg, capacity_factor=cfg.moe.capacity_factor,
                norm_in=norm_in)
        return x + out, cache, aux
    if kind != "mlp":
        raise ValueError(kind)
    split = par is not None and _tp(cfg.d_ff, par.shape["model"])
    xin, gamma = x2d, p["norm"]
    if split:  # the fused norm's dx and dgamma are partial sums
        xin, gamma = par.copy_to(xin), par.copy_to(gamma)
    g = ops.fused_norm_matmul(xin, gamma, p["w_gate"])
    u = ops.fused_norm_matmul(xin, gamma, p["w_up"])
    out = torch.matmul(silu(g) * u, p["w_down"])
    if split:
        out = par.reduce_from(out)
    return x + out.view(B, S, d), cache, None


def _group_body(group, lp, x, cfg, positions, mode, cache_g, enc_out=None,
                par=None, seq=None):
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
                                      mode=mode, cache=c_m, enc_out=enc_out,
                                      par=par, seq=seq)
        x, nc_f, aux = _apply_ffn(ffn, fp, x, cfg, mp, mode=mode, cache=c_f,
                                  x_sum=x_sum, par=par)
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


def _ce_chunk_vp(hs, ls, emb, mesh):
    """The same over this rank's rows of the vocabulary (Megatron's
    vocab-parallel CE): the max is taken without a gradient before its
    ``pmax``, and the logsumexp's sum and the gold logit each reduce with
    one psum (identity backward)."""
    vloc = emb.shape[0]
    logits = (hs @ emb.T.to(hs.dtype)).float()
    with torch.no_grad():
        lmax = mesh.pmax(logits.amax(dim=-1), "model")
    z = torch.exp(logits - lmax[..., None]).sum(dim=-1)
    lse = torch.log(mesh.reduce_from(z, "model")) + lmax
    rel = ls.long() - mesh.axis_index("model") * vloc
    ok = (rel >= 0) & (rel < vloc)
    g = logits.gather(-1, rel.clamp(0, vloc - 1)[..., None])[..., 0]
    gold = mesh.reduce_from(torch.where(ok, g, 0.0), "model")
    return (lse - gold).sum()


# --------------------------------------------------------------- the model
class LM:
    """A model bound to a config and a device (CUDA unless given): pure
    functions of the parameters and the cache, as in the reference.

    With ``mesh`` (``launch/mesh.py``), ``tp`` is its ``model`` size and
    the model is this rank's program, for every family: its parameters are
    the rank's shards (``init`` draws them, ``launch.mesh.shard_params``
    carries the reference's across), its inputs the rank's share of the
    batch (the whole batch on every ``model`` rank; its lanes of the cache
    over a data axis, ``init_cache`` taking the whole mesh's batch), and it
    calls the collectives where the reference's GSPMD puts them.  A batch
    that does not split over the data axis, one sequence (the reference's
    ``_batch_shardable`` false), is the whole batch on every data rank:
    each computes the same token with the same bits, and the cache's
    sequence splits over the data axis instead (``cache_template``).
    Without a mesh, ``tp > 1`` only shapes the parameters
    (``pad_attn_heads``) and the program runs whole, as the reference's
    does without one."""

    def __init__(self, cfg: ModelConfig, tp: int = 1, mesh=None, *,
                 device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.tp = mesh.shape.get("model", 1) if mesh is not None else tp
        _require_ported(cfg, self.tp)
        self.device = resolve_device(
            mesh.device if device is None and mesh is not None else device)
        # the batch axes: ('pod', 'data') on a multi-pod mesh
        self.batch_axes = (("pod", "data") if mesh is not None
                           and "pod" in mesh.axis_names else ("data",))
        self.program = make_program(cfg)
        # the mesh the layers split over (None: every layer whole)
        self._par = mesh if mesh is not None and self.tp > 1 else None
        # the whole mesh's batch of the last cache ``init_cache`` made: a
        # rank's one lane is then either one of D lanes or the one lane of
        # a batch-1 cache, which its shapes do not tell apart
        self.cache_batch: int | None = None

    @property
    def _vocab_parallel(self) -> bool:
        """Embedding, logits and CE over this rank's rows of the
        vocabulary.  The reference also asks that the batch divide the
        data size (``_batch_shardable``); the port's batch is already the
        rank's share, or, for one sequence, the whole batch on every data
        rank, where the embedding's psum adds only zeros to the owning
        rank's row: the bits of the reference's plain gather."""
        return self._par is not None and self.cfg.vocab_size % self.tp == 0

    @property
    def _data_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.axis_size(BATCH_AXES)

    def init(self, seed: int = 0):
        return init_params(self.cfg, seed, device=self.device, tp=self.tp,
                           mesh=self.mesh)

    def abstract(self):
        return abstract_params(self.cfg, self.tp)

    def pspecs(self):
        return param_pspecs(self.cfg, self.tp)

    # ---- embedding / unembedding (vocab-parallel over a mesh)
    def _embed(self, params, tokens):
        emb = params["embed"]
        if not self._vocab_parallel:
            return emb[tokens.long()].to(_dtype(self.cfg))
        vloc = emb.shape[0]
        rel = tokens.long() - self.mesh.axis_index("model") * vloc
        ok = (rel >= 0) & (rel < vloc)
        e = torch.where(ok[..., None], emb[rel.clamp(0, vloc - 1)], 0)
        return self.mesh.reduce_from(e, "model").to(_dtype(self.cfg))

    def _unembed_logits(self, params, h):
        """Logits over the whole vocabulary; vocab-parallel, each rank's
        columns are gathered in rank order, so every rank holds (and
        samples from) the same logits."""
        emb = params.get("lm_head", params["embed"])
        logits = h @ emb.T.to(h.dtype)
        if self._vocab_parallel:
            logits = self.mesh.all_gather(logits, "model", dim=-1)
        return logits

    # ---- encoder (whisper)
    def _encode(self, params, frames):
        """The encoder over (B, Se, d) frame embeddings: ``frame_proj``,
        then each layer's bidirectional attention without RoPE (whisper
        learns its positions; the stub frontend carries them) and its MLP,
        then ``enc_final_norm``.  q, k and v, and the gate and up, are
        fused launches.  Over a mesh the attention and the MLP split as
        the decoder's do (``_gqa_shard``, one psum each)."""
        cfg = self.cfg
        par = self._par
        x = torch.matmul(frames.to(_dtype(cfg)), params["frame_proj"])
        B, S, d = x.shape
        hd = cfg.head_dim
        split = par is not None and _splits("gqa", cfg, self.tp)
        enc = params["encoder"]
        views = {part: {k: v.unbind(0) for k, v in enc[part].items()}
                 for part in ("mixer", "ffn")}
        for i in range(cfg.encoder_layers):
            mp = {k: v[i] for k, v in views["mixer"].items()}
            fp = {k: v[i] for k, v in views["ffn"].items()}
            lp, xin, gamma, q0, kv0 = mp, x, mp["norm"], 0, 0
            if split:
                lp, xin, gamma, q0, kv0 = _gqa_shard(mp, x, cfg, par)
            x2d = xin.reshape(B * S, d)

            def proj(w):
                heads = w.shape[1]
                return ops.fused_norm_matmul(
                    x2d, gamma, w.reshape(d, heads * hd)).view(
                        B, S, heads, hd)

            q, k, v = proj(lp["wq"]), proj(lp["wk"]), proj(lp["wv"])
            heads = att.gqa_kv_heads(cfg, q.shape[2], q0, kv0)
            o = att.flash_attention(q, att.expand_kv(k, heads),
                                    att.expand_kv(v, heads), causal=False)
            out = torch.einsum("bshk,hkd->bsd", o.to(x.dtype), lp["wo"])
            x = x + (par.reduce_from(out) if split else out)
            x, _, _ = _apply_ffn("mlp", fp, x, cfg, mp, mode="train",
                                 cache=None, par=par)
        return rms_norm(x, params["enc_final_norm"])

    # ---- the layer stack
    def _stack(self, params, x, *, positions, mode, caches=None, length=None,
               remat=False, enc_out=None, seq=None):
        """Run all stages.  ``caches``: the cache's per-stage trees, stacked
        on the layer axis (None in train mode); ``length`` is the shared
        per-row cache write position (decode); ``enc_out`` the encoder
        output (encdec); ``seq`` the cache's sequence split (decode).
        With ``remat``, in train mode and with a gradient asked for, each
        group of layers runs under
        ``torch.utils.checkpoint`` (non-reentrant): its activations are
        recomputed in the backward, as the reference's
        ``jax.checkpoint(nothing_saveable)`` does.  Returns (x, the MoE
        layers' aux losses summed in layer order (None without a MoE
        layer), new_caches)."""
        cfg = self.cfg
        ckpt = remat and mode == "train" and torch.is_grad_enabled()
        if enc_out is not None and self._par is not None \
                and _splits("gqa_cross", cfg, self.tp):
            # every layer's cross-attention reads only its heads: one psum
            # of the encoder output's gradient for the whole stack
            enc_out = self._par.copy_to(enc_out)
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
                args = (group, lp, x, cfg, positions, mode, cache_g, enc_out,
                        self._par, seq)
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
        reference's non-vocab-parallel branch (over a mesh, its
        vocab-parallel one, ``_ce_chunk_vp``); with a gradient asked for,
        each chunk runs under ``torch.utils.checkpoint``, so its (B, chunk,
        V) float32 logits are recomputed in the backward rather than
        kept.  The loss is the mean over the rank's batch."""
        emb = params.get("lm_head", params["embed"])
        B, S, _ = h.shape
        chunk = max(1, min(512, S))
        n = S // chunk if S % chunk == 0 else 1
        chunk = S // n if n else S
        ckpt = torch.is_grad_enabled()
        fn, extra = _ce_chunk, ()
        if self._vocab_parallel:
            fn, extra = _ce_chunk_vp, (self.mesh,)
            h = self.mesh.copy_to(h)  # enters this rank's vocabulary rows
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(n):
            hs = h[:, i * chunk:(i + 1) * chunk]
            ls = labels[:, i * chunk:(i + 1) * chunk]
            part = (checkpoint(fn, hs, ls, emb, *extra, use_reentrant=False)
                    if ckpt else fn(hs, ls, emb, *extra))
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
                               mode="train", cache=None, par=self._par)
        z, _, _ = _apply_ffn("mlp", mp["ffn"], z, cfg, mp["mixer"],
                             mode="train", cache=None, par=self._par)
        return self._ce(params, z, labels[:, 1:])

    # ---- serving -----------------------------------------------------------
    def cache_template(self, batch: int, max_seq: int):
        """Tree of (shape, dtype, spec) Leafs describing the decode cache
        of ``batch`` sequences in all (whole shapes).  Over a mesh the
        batch splits over ``data`` (``("pod", "data")`` on a pod mesh: the
        specs say ``data``, which ``shardings_for`` expands), as the
        reference's ``b_axis``: a rank holds its lanes' cache and
        ``length``.  Over ``model`` a rank holds its kv heads when they
        split with the q heads (else all of them), its mamba channels
        (``h``, ``tail``) and its rwkv heads (``s``); the mla latent and
        the token-shift caches are replicated.

        The sequence splits as the reference's ``seq_axis``: over ``data``
        at batch 1 (``long_500k``: every leaf without a sequence, and
        ``length``, replicated over ``data``), else over ``model`` under
        ``cache_seq_shard``, where the gqa ``k``/``v`` then hold every kv
        head (the reference's ``hd_axis`` drops off likewise).  The gqa
        layout otherwise differs from the reference's, whose cache splits
        ``head_dim`` over ``model`` where the port splits the kv heads:
        the decode function is the same, the spec trees are not, and the
        sequence and batch entries are the reference's.  A batch that does
        not divide over the data axis raises ``ValueError``."""
        cfg = self.cfg
        D = self._data_size
        if batch % D and batch != 1:
            raise ValueError(f"a batch of {batch} does not split over a data "
                             f"axis of {D}")
        long_ctx = batch == 1  # the sequence splits, not the batch
        b = None if long_ctx else "data"
        seq = "data" if long_ctx else (
            "model" if cfg.cache_seq_shard else None)
        tp, par = self.tp, self._par
        kv_split = par is not None and _tp(cfg.num_kv_heads, tp) \
            and _splits("gqa", cfg, tp) and seq != "model"

        def model_if(split):
            return "model" if par is not None and split else None

        def mixer_cache(kind, repeat):
            if kind in ("gqa", "gqa_cross"):
                kv = Leaf((repeat, batch, max_seq, cfg.num_kv_heads,
                           cfg.head_dim), dtype=cfg.dtype,
                          spec=Spec(None, b, seq, model_if(kv_split), None))
                return {"k": kv, "v": kv}
            if kind == "mamba":  # the float32 SSM state and the conv tail
                mc = cfg.mamba
                di = mc.expand * cfg.d_model
                ch = model_if(_splits("mamba", cfg, tp))
                return {"h": Leaf((repeat, batch, di, mc.d_state),
                                  dtype="float32", spec=Spec(None, b, ch,
                                                             None)),
                        "tail": Leaf((repeat, batch, mc.d_conv - 1, di),
                                     dtype=cfg.dtype,
                                     spec=Spec(None, b, None, ch))}
            if kind == "mla":  # the compressed latent and the rope key
                m = cfg.mla
                spec = Spec(None, b, seq, None)
                return {"c": Leaf((repeat, batch, max_seq, m.kv_lora_rank),
                                  dtype=cfg.dtype, spec=spec),
                        "r": Leaf((repeat, batch, max_seq,
                                   m.qk_rope_head_dim), dtype=cfg.dtype,
                                  spec=spec)}
            hs = cfg.rwkv_head_size
            H = cfg.d_model // hs
            return {"x": Leaf((repeat, batch, cfg.d_model), dtype=cfg.dtype,
                              spec=Spec(None, b, None)),
                    "s": Leaf((repeat, batch, H, hs, hs), dtype="float32",
                              spec=Spec(None, b, model_if(
                                  _splits("rwkv", cfg, tp)), None, None))}

        stages = []
        for repeat, group in self.program:
            stages.append([
                {"mixer": mixer_cache(mixer, repeat),
                 "ffn": (Leaf((repeat, batch, cfg.d_model), dtype=cfg.dtype,
                              spec=Spec(None, b, None))
                         if ffn == "rwkv_cm" else None)}
                for mixer, ffn in group])
        return {"stages": stages,
                "length": Leaf((batch,), dtype="int32", spec=Spec(b))}

    def seq_split(self, batch: int):
        """The split of the decode cache's sequence for ``batch`` sequences
        of the whole mesh (:meth:`cache_template`'s ``seq``), as an
        ``attention.SeqSplit`` over the axes of size above 1, or None."""
        if self.mesh is None:
            return None
        axes = (self.batch_axes if batch == 1 else
                ("model",) if self.cfg.cache_seq_shard else ())
        if self.mesh.axis_size(axes) == 1:
            return None
        return att.SeqSplit(self.mesh, axes)

    def init_cache(self, batch: int, max_seq: int):
        """Zeros of the rank's share of :meth:`cache_template` (``batch``:
        the sequences of the whole mesh; each rank's chunk of a split
        sequence)."""
        self.cache_batch = batch

        def shape(lf):
            if self.mesh is None:
                return lf.shape
            spec = mesh_mod.shardings_for(self.mesh, lf.spec)
            return mesh_mod.local_shape(lf.shape, spec, self.mesh)

        return tree_map(
            lambda lf: torch.zeros(shape(lf), dtype=_DTYPES[lf.dtype],
                                   device=self.device),
            self.cache_template(batch, max_seq))

    def _global_batch(self, local: int) -> int:
        """The whole mesh's batch of a decode step whose rank holds
        ``local`` lanes: one lane of D is told from the one lane of a
        batch-1 cache by :attr:`cache_batch`."""
        D = self._data_size
        if local == 1 and (D == 1 or self.cache_batch == 1):
            return 1
        return local * D

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
        x, _, new_stages = self._stack(
            params, x, positions=length[:, None], mode="decode",
            caches=cache["stages"], length=length, enc_out=enc_out,
            seq=self.seq_split(self._global_batch(tokens.shape[0])))
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
