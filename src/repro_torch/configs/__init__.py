"""Config registry: architecture id → ArchConfig."""
from repro_torch.configs import paper_cnn
from repro_torch.configs.base import ArchConfig, FedConfig

ARCHS = {"paper-cnn": paper_cnn.CONFIG}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ArchConfig", "FedConfig", "get_arch"]
