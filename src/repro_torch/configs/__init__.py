"""Config registry: architecture id → ArchConfig."""
from repro_torch.configs import llama3_2_1b, paper_cnn
from repro_torch.configs.base import ArchConfig, FedConfig

ARCHS = {"llama3.2-1b": llama3_2_1b.CONFIG, "paper-cnn": paper_cnn.CONFIG}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ArchConfig", "FedConfig", "get_arch"]
