"""Zamba2-7B [arXiv:2411.15242] — 81 Mamba2 layers and a weight-tied
attention + MLP block applied after every 27 of them (3 applications);
the reference's config."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm=SSMConfig(state_size=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=128, kind="mamba2"),
    shared_attn_every=27, source="arXiv:2411.15242",
)
