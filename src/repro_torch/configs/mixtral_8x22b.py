"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, SWA. [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.registry import register

FULL = ModelConfig(
    name="mixtral-8x22b", family="moe", num_layers=56, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=16384, vocab_size=32768,
    head_dim=128, attn_kind="swa", window=4096, rope_theta=1e6,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
    notes="SWA window 4096 => sub-quadratic decode cache; long_500k runs")

REDUCED = ModelConfig(
    name="mixtral-8x22b", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
    head_dim=16, attn_kind="swa", window=32, rope_theta=1e6,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128))

register(FULL, REDUCED)
