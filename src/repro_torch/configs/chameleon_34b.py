"""Chameleon-34B [arXiv:2405.09818] — early-fusion VLM.

VQ image tokens are ordinary vocabulary entries (vocab 65536 includes the
8192 image codes), so the backbone is a plain dense decoder; the VQ-VAE
tokenizer is the stubbed modality frontend (input_specs feeds token ids).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab_size=65536, rope_theta=1e4,
    source="arXiv:2405.09818",
)
