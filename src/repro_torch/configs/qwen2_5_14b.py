"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064. GQA + QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

FULL = ModelConfig(
    name="qwen2.5-14b", family="dense", num_layers=48, d_model=5120,
    num_heads=40, num_kv_heads=8, d_ff=13824, vocab_size=152064,
    head_dim=128, qkv_bias=True, rope_theta=1e6,
    notes="GQA + QKV bias; full attention => long_500k skipped")

REDUCED = ModelConfig(
    name="qwen2.5-14b", family="dense", num_layers=2, d_model=80,
    num_heads=5, num_kv_heads=1, d_ff=192, vocab_size=512,
    head_dim=16, qkv_bias=True, rope_theta=1e6)

register(FULL, REDUCED)
