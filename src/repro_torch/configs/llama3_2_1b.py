"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B] — small llama3 (GQA kv=8),
tied embeddings; the reference's config, sliding window included."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=128256, rope_theta=5e5,
    sliding_window=8192, tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)
