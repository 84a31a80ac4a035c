"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family] — 128 experts top-8;
the reference's config (235.1 B parameters: in bf16 far more than one
80 GB card holds, so the card runs it cut in depth)."""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128, rope_theta=1e6,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    source="hf:Qwen/Qwen3-30B-A3B",
)
