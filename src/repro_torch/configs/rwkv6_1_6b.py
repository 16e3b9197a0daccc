"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536.
Finch: data-dependent decay. [arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

FULL = ModelConfig(
    name="rwkv6-1.6b", family="ssm", num_layers=24, d_model=2048,
    num_heads=32, num_kv_heads=32, d_ff=7168, vocab_size=65536,
    rwkv_head_size=64,
    notes="attention-free; constant-size state => long_500k runs; paged-KV "
          "technique inapplicable (no KV cache) — see DESIGN §Arch-applicability")

REDUCED = ModelConfig(
    name="rwkv6-1.6b", family="ssm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=224, vocab_size=512,
    rwkv_head_size=16)

register(FULL, REDUCED)
