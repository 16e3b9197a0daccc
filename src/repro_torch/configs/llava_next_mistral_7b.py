"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000; anyres patch frontend STUBBED (input_specs provides precomputed
patch embeddings). [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

FULL = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, d_ff=14336, vocab_size=32000,
    head_dim=128, rope_theta=1e6, vision_tokens=576,
    notes="mistral backbone; vision frontend stub (576 patch embeds); "
          "full attention => long_500k skipped")

REDUCED = ModelConfig(
    name="llava-next-mistral-7b", family="vlm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, d_ff=160, vocab_size=512,
    head_dim=16, rope_theta=1e6, vision_tokens=16)

register(FULL, REDUCED)
