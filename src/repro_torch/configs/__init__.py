"""Config registry: architecture id → ArchConfig."""
from repro_torch.configs import (llama3_2_1b, paper_cnn, rwkv6_7b,
                                 zamba2_7b)
from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, FedConfig,
                                      ShapeConfig, SSMConfig)

ARCHS = {"llama3.2-1b": llama3_2_1b.CONFIG, "paper-cnn": paper_cnn.CONFIG,
         "rwkv6-7b": rwkv6_7b.CONFIG, "zamba2-7b": zamba2_7b.CONFIG}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ArchConfig", "FedConfig", "INPUT_SHAPES",
           "ShapeConfig", "SSMConfig", "get_arch"]
