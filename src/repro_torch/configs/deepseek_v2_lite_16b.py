"""DeepSeek-V2-Lite-16B [arXiv:2405.04434] — MLA (kv_lora=512) + MoE 64e
top-6 with 2 shared experts; the reference's config (16,210,324,992
parameters: 32.42 GB in bf16, so one 80 GB card holds all 27 layers)."""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400, rope_theta=1e4,
    mla=MLAConfig(kv_lora_rank=512, qk_rope_dim=64, qk_nope_dim=128,
                  v_head_dim=128),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared_experts=2),
    source="arXiv:2405.04434",
)
