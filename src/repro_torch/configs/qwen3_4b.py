"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936.
qk_norm + GQA. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

FULL = ModelConfig(
    name="qwen3-4b", family="dense", num_layers=36, d_model=2560,
    num_heads=32, num_kv_heads=8, d_ff=9728, vocab_size=151936,
    head_dim=128, qk_norm=True, rope_theta=1e6,
    notes="qk_norm GQA; full attention => long_500k skipped")

REDUCED = ModelConfig(
    name="qwen3-4b", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=160, vocab_size=512,
    head_dim=16, qk_norm=True, rope_theta=1e6)

register(FULL, REDUCED)
