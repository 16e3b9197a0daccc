"""LM assembly: the reference's ``models/lm.py`` in PyTorch, families
``dense`` and ``ssm`` (rwkv6).

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
  whisper:                   decoder stage (causal gqa + cross-attn)

Only the dense and ssm families run here, at ``tp=1``: the others raise
``NotImplementedError``.  Every dense layer's RMSNorm -> projection pairs
(q, k, v and the SwiGLU gate and up) run through ``ops.fused_norm_matmul``;
the rwkv mixer norms, then shifts, then projects, so it has no such pair
(``models/rwkv.py``).  The parameter tree has the reference's names and
nesting, so ``params_from_reference`` carries the reference's weights
across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.outback import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import attention as att
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


_PORTED_FAMILIES = ("dense", "ssm")
# each mixer's cache leaves, in the order of its tuple form
_MIXER_CACHE = {"gqa": ("k", "v"), "rwkv": ("x", "s")}


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
    if kind == "gqa":
        sq = 1.0 / float(np.sqrt(d))
        so = 1.0 / float(np.sqrt(H * hd))
        for k, s in att.gqa_params_shape(cfg).items():
            if k in ("wq", "wk", "wv"):
                t[k] = Leaf(s, scale=sq)
            elif k == "wo":
                t[k] = Leaf(s, scale=so)
            else:
                t[k] = Leaf(s)
    elif kind == "rwkv":
        for k, s in rwkv_mod.rwkv_params_shape(cfg).items():
            t[k] = Leaf(s, dtype="float32" if k in ("w0", "u")
                        else "bfloat16")
    else:
        raise NotImplementedError(f"mixer {kind!r} is not yet ported")
    t["norm"] = Leaf((d,))
    return t


def _ffn_template(kind: str, cfg: ModelConfig):
    if kind == "rwkv_cm":
        return {}  # rwkv channel-mix params live in the mixer's dict
    if kind != "mlp":
        raise NotImplementedError(f"ffn {kind!r} is not yet ported")
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": Leaf((d, f)), "w_up": Leaf((d, f)),
            "w_down": Leaf((f, d)), "norm": Leaf((d,))}


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
        # name-dispatched special leaves (independent of the stack axis);
        # the rules of the other families' leaves come with those families
        if "norm" in name or name == "ln_x":
            return torch.ones(lf.shape, dtype=dt, device=device)
        if name.startswith("b"):
            return torch.zeros(lf.shape, dtype=dt, device=device)
        if name.startswith("mu_"):
            return torch.full(lf.shape, 0.5, dtype=dt, device=device)
        if name == "w0":  # rwkv decay base: mild decay
            return torch.full(lf.shape, -1.0, dtype=dt, device=device)
        if name == "u":
            return normal_init(gen, lf.shape, 0.1, dt)
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
def _apply_mixer(kind, p, x, cfg, *, positions, mode, cache):
    """-> (x + mixer(x), new mixer cache, the sum unrounded or None).

    rwkv's residual sum also comes back in float32: the reference's
    compiled layer fuses that add into the channel mix's RMSNorm, which
    reads the sum before it is rounded to bf16."""
    if kind == "rwkv":
        h = rms_norm(x, p["norm"])
        new_cache = None
        if mode == "train":
            out = rwkv_mod.time_mix(p, h, cfg, mode="train")
        else:
            out, new_cache = rwkv_mod.time_mix(p, h, cfg, mode=mode,
                                               cache=cache)
        return x + out, new_cache, x.float() + out.float()
    if kind != "gqa":
        raise NotImplementedError(f"mixer {kind!r} is not yet ported")
    if mode == "train":
        out = att.gqa_apply(p, x, cfg, gamma=p["norm"], positions=positions,
                            mode="train")
        return x + out, None, None
    out, new_cache = att.gqa_apply(p, x, cfg, gamma=p["norm"],
                                   positions=positions, mode=mode,
                                   cache=cache)
    return x + out, new_cache, None


def _apply_ffn(kind, p, x, mixer_p, *, mode, cache, x_sum=None):
    """-> (x, new ffn cache).  SwiGLU with both entries through the fused
    norm -> matmul kernel; rwkv's channel mix normalises the unrounded
    residual sum ``x_sum`` with the mixer's ``ln_x`` and carries its
    token-shift input in the ffn cache."""
    if kind == "rwkv_cm":
        h = rms_norm(x_sum, mixer_p["ln_x"]).to(x.dtype)
        if mode == "train":
            return x + rwkv_mod.channel_mix(mixer_p, h, mode="train"), None
        out, new_c = rwkv_mod.channel_mix(mixer_p, h, mode=mode, cache=cache)
        return x + out, new_c
    if kind != "mlp":
        raise NotImplementedError(f"ffn {kind!r} is not yet ported")
    B, S, d = x.shape
    x2d = x.reshape(B * S, d)
    g = ops.fused_norm_matmul(x2d, p["norm"], p["w_gate"])
    u = ops.fused_norm_matmul(x2d, p["norm"], p["w_up"])
    return x + torch.matmul(silu(g) * u, p["w_down"]).view(B, S, d), cache


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

    # ---- the layer stack
    def _stack(self, params, x, *, positions, mode, caches=None, length=None):
        """Run all stages.  ``caches``: the cache's per-stage trees, stacked
        on the layer axis (None in train mode); ``length`` is the shared
        per-row cache write position (decode).  Returns (x, new_caches)."""
        cfg = self.cfg
        new_caches = []
        for s_idx, ((repeat, group), sp) in enumerate(
                zip(self.program, params["stages"])):
            new_layers = [[] for _ in group]
            for i in range(repeat):
                for li, (mixer, ffn) in enumerate(group):
                    mp = {k: v[i] for k, v in sp[li]["mixer"].items()}
                    fp = {k: v[i] for k, v in sp[li]["ffn"].items()}
                    c_m = c_f = None
                    if caches is not None:
                        c = caches[s_idx][li]
                        # the reference's tuple form of the layer's cache
                        c_m = tuple(c["mixer"][n][i]
                                    for n in _MIXER_CACHE[mixer])
                        if mixer == "gqa":
                            c_m = (*c_m, length)  # per-row write position
                        c_f = None if c["ffn"] is None else c["ffn"][i]
                    x, nc_m, x_sum = _apply_mixer(mixer, mp, x, cfg,
                                                  positions=positions,
                                                  mode=mode, cache=c_m)
                    x, nc_f = _apply_ffn(ffn, fp, x, mp, mode=mode,
                                         cache=c_f, x_sum=x_sum)
                    new_layers[li].append((nc_m, nc_f))
            if caches is not None:
                new_caches.append([
                    {"mixer": {n: torch.stack([m[j] for m, _ in layers])
                               for j, n in enumerate(_MIXER_CACHE[mixer])},
                     "ffn": (None if layers[0][1] is None else
                             torch.stack([f for _, f in layers]))}
                    for (mixer, _), layers in zip(group, new_layers)])
        return x, (new_caches if caches is not None else None)

    # ---- serving -----------------------------------------------------------
    def cache_template(self, batch: int, max_seq: int):
        """Tree of (shape, dtype) Leafs describing the decode cache."""
        cfg = self.cfg

        def mixer_cache(kind, repeat):
            if kind == "gqa":
                kv = Leaf((repeat, batch, max_seq, cfg.num_kv_heads,
                           cfg.head_dim), dtype=cfg.dtype)
                return {"k": kv, "v": kv}
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

    def decode_step(self, params, tokens, cache):
        """One token for every sequence. tokens (B,1) -> (logits (B,V),
        cache).  The cache is not changed: the step returns a new one."""
        x = self._embed(params, tokens)
        length = cache["length"]
        x, new_stages = self._stack(params, x, positions=length[:, None],
                                    mode="decode", caches=cache["stages"],
                                    length=length)
        x = rms_norm(x, params["final_norm"])
        logits = self._unembed_logits(params, x[:, 0])
        return logits, {"stages": new_stages, "length": length + 1}

    def prefill(self, params, batch):
        """Full-sequence forward: logits at the last position."""
        x = self._embed(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None]
        x, _ = self._stack(params, x, positions=positions, mode="train")
        x = rms_norm(x, params["final_norm"])
        return self._unembed_logits(params, x[:, -1])
