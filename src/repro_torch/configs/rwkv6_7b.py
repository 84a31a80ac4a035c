"""RWKV6-7B "Finch" [arXiv:2404.05892] — attention-free, data-dependent
decay; the reference's config."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab_size=65536,
    ssm=SSMConfig(state_size=64, head_dim=64, expand=1, conv_width=0,
                  chunk_size=128, kind="rwkv6"),
    source="arXiv:2404.05892",
)
