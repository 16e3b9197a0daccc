"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2; mamba+attn 1:7 interleave, MoE every 2nd layer.
[arXiv:2403.19887; hf]

Layer pattern per 8-layer period: attention at position 3, mamba elsewhere
(1 attn : 7 mamba); MoE replaces the MLP on odd positions (every 2nd layer).
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig
from repro_torch.configs.registry import register

FULL = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=65536,
    head_dim=128, rope_theta=1e4, layer_pattern="mmmammmm",
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336, every_k=2),
    notes="hybrid: mamba state + 4 attn-layer caches; long_500k runs")

REDUCED = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", num_layers=8, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
    head_dim=16, rope_theta=1e4, layer_pattern="mmmammmm",
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, every_k=2))

register(FULL, REDUCED)
