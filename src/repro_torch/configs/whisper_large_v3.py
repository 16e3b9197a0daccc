"""whisper-large-v3 [audio]: enc-dec, 32L(+32 enc) d_model=1280 20H d_ff=5120
vocab=51866; conv frontend STUB (input_specs provides 1500 frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register

FULL = ModelConfig(
    name="whisper-large-v3", family="encdec", num_layers=32, d_model=1280,
    num_heads=20, num_kv_heads=20, d_ff=5120, vocab_size=51866,
    head_dim=64, encoder_layers=32, encoder_seq=1500,
    notes="enc-dec; conv frontend stub; decoder full attention => "
          "long_500k skipped")

REDUCED = ModelConfig(
    name="whisper-large-v3", family="encdec", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=512,
    head_dim=16, encoder_layers=2, encoder_seq=32)

register(FULL, REDUCED)
