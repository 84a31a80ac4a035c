"""Config registry: architecture id → ArchConfig."""
from repro_torch.configs import (chameleon_34b, deepseek_v2_lite_16b,
                                 granite_8b, llama3_2_1b, paper_cnn,
                                 qwen2_7b, qwen2_72b, qwen3_moe_235b_a22b,
                                 rwkv6_7b, seamless_m4t_medium, zamba2_7b)
from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, FedConfig,
                                      MLAConfig, MoEConfig, ShapeConfig,
                                      SSMConfig)

ARCHS = {"chameleon-34b": chameleon_34b.CONFIG,
         "deepseek-v2-lite-16b": deepseek_v2_lite_16b.CONFIG,
         "granite-8b": granite_8b.CONFIG, "llama3.2-1b": llama3_2_1b.CONFIG,
         "paper-cnn": paper_cnn.CONFIG, "qwen2-7b": qwen2_7b.CONFIG,
         "qwen2-72b": qwen2_72b.CONFIG,
         "qwen3-moe-235b-a22b": qwen3_moe_235b_a22b.CONFIG,
         "rwkv6-7b": rwkv6_7b.CONFIG,
         "seamless-m4t-medium": seamless_m4t_medium.CONFIG,
         "zamba2-7b": zamba2_7b.CONFIG}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ArchConfig", "FedConfig", "INPUT_SHAPES", "MLAConfig",
           "MoEConfig", "ShapeConfig", "SSMConfig", "get_arch"]
