"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

FULL = ModelConfig(
    name="llama3.2-1b", family="dense", num_layers=16, d_model=2048,
    num_heads=32, num_kv_heads=8, d_ff=8192, vocab_size=128256,
    head_dim=64, rope_theta=5e5, tie_embeddings=True,
    notes="small llama3; full attention => long_500k skipped")

REDUCED = ModelConfig(
    name="llama3.2-1b", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512,
    head_dim=16, rope_theta=5e5, tie_embeddings=True)

register(FULL, REDUCED)
