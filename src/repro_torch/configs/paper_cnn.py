"""The paper's experimental model (appendix D.5 3-layer CNN)."""
from repro_torch.configs.base import ArchConfig

# ArchConfig used loosely: d_model = conv width, n_layers = conv blocks.
CONFIG = ArchConfig(
    name="paper-cnn", family="cnn",
    n_layers=3, d_model=64, n_heads=1, n_kv_heads=1,
    d_ff=256, vocab_size=10,   # vocab_size doubles as n_classes
    param_dtype="float32", source="FedELMY appendix D.5",
)
