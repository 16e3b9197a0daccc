"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048(expert)
vocab=129280, MoE 1 shared + 256 routed top-8, MLA, MTP.
[arXiv:2412.19437; hf]. Dense first 3 layers use d_ff 18432 (paper)."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
from repro_torch.configs.registry import register

FULL = ModelConfig(
    name="deepseek-v3-671b", family="moe", num_layers=61, d_model=7168,
    num_heads=128, num_kv_heads=128, d_ff=18432, vocab_size=129280,
    head_dim=128, attn_kind="mla", rope_theta=1e4,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048, num_shared=1,
                  first_k_dense=3, score_func="sigmoid"),
    mtp=True,
    notes="MLA latent cache (512+64/token); full softmax over all positions "
          "=> long_500k skipped (not sub-quadratic)")

REDUCED = ModelConfig(
    name="deepseek-v3-671b", family="moe", num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=4, d_ff=160, vocab_size=512,
    head_dim=16, attn_kind="mla", rope_theta=1e4,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                  qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64, num_shared=1,
                  first_k_dense=1, score_func="sigmoid"),
    mtp=True)

register(FULL, REDUCED)
