"""Qwen2-72B [arXiv:2407.10671] — dense GQA decoder with QKV bias; the
reference's config (72.7 B parameters: in bf16 more than one 80 GB card
holds, so the card runs it cut in depth)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064, qkv_bias=True,
    rope_theta=1e6, source="arXiv:2407.10671",
)
