"""Granite-8B-Code [arXiv:2405.04324] — llama-arch dense decoder; the
reference's config."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=49152, rope_theta=1e4,
    source="arXiv:2405.04324",
)
