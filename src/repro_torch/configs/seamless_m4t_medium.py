"""SeamlessM4T-medium [arXiv:2308.11596] — encoder-decoder (audio in,
text out); the reference's config. The speech frontend (mel filterbank and
conv feature extractor) is a stub, as in the reference: the model takes
precomputed frame embeddings (B, T_src, d_model). A 12-layer transformer
encoder and a 12-layer decoder with cross-attention over the 256,206-entry
text vocabulary, untied: 977,757,184 parameters (1.96 GB in bf16)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, n_encoder_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, rope_theta=1e4,
    source="arXiv:2308.11596",
)
