"""Qwen2-7B [arXiv:2407.10671] — dense GQA decoder with QKV bias; the
reference's config."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064, qkv_bias=True,
    rope_theta=1e6, source="arXiv:2407.10671",
)
