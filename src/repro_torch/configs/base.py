"""Config system: architecture + shape + run configs (plain dataclasses).

A copy of the reference package's ``configs/base.py``: one ``ModelConfig``
per assigned architecture lives in ``repro_torch/configs/<id>.py`` and
registers itself; ``--arch <id>`` resolves through the registry.  Every
config has a reduced variant — the same family at smoke-test scale.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0
    first_k_dense: int = 0  # leading dense layers (deepseek)
    every_k: int = 1  # MoE every k-th layer (jamba: 2)
    score_func: str = "softmax"  # deepseek-v3: sigmoid
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // num_heads
    # attention flavour
    attn_kind: str = "full"  # full | swa | mla
    window: Optional[int] = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e4
    mla: Optional[MLAConfig] = None
    # mixture of experts
    moe: Optional[MoEConfig] = None
    # hybrid / ssm
    layer_pattern: Optional[str] = None  # per-period, e.g. "mmmammmm" (jamba)
    mamba: Optional[MambaConfig] = None
    rwkv_head_size: int = 64
    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 1500  # post-conv audio frames (stub frontend)
    # vlm stub frontend
    vision_tokens: int = 0  # patch embeddings prepended (stub frontend)
    # extras
    mtp: bool = False  # deepseek multi-token prediction head
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # --- beyond-paper perf variants (EXPERIMENTS.md §Perf) ---------------
    # pad attention heads up to the TP degree so H % tp != 0 archs still
    # shard (wasted pad-head compute << replicated-attention traffic)
    pad_attn_heads: bool = False
    # decode caches: shard the SEQUENCE dim over 'model' (flash-decode
    # combine psum of (o,m,l) instead of full score all-reduce)
    cache_seq_shard: bool = False
    # MoE decode at tiny token counts: gather only the routed experts'
    # weights instead of streaming every expert (serving-engine style)
    moe_gather_decode: bool = False
    # sub-quadratic decode? (drives long_500k applicability)
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.mamba is not None and self.mamba.dt_rank == 0:
            object.__setattr__(
                self, "mamba",
                dataclasses.replace(self.mamba,
                                    dt_rank=max(1, -(-self.d_model // 16))))

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode a 500k context without a full-attention KV
        cache? (ssm / hybrid / sliding-window)"""
        return (self.family in ("ssm", "hybrid")
                or self.attn_kind == "swa")

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# smoke-scale variants (same kind, tiny extents) used by per-arch smoke tests
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("train_smoke", 64, 2, "train"),
    "prefill_32k": ShapeConfig("prefill_smoke", 64, 2, "prefill"),
    "decode_32k": ShapeConfig("decode_smoke", 64, 2, "decode"),
    "long_500k": ShapeConfig("long_smoke", 128, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Run-level knobs consumed by the launcher / train loop."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    microbatch: int = 0  # 0 => no gradient accumulation
    remat: str = "block"  # none | block
    zero1: bool = True  # shard optimizer state over 'data'
    grad_compression: str = "none"  # none | int8
    checkpoint_every: int = 200
    checkpoint_dir: str = "checkpoints"
    seed: int = 0
