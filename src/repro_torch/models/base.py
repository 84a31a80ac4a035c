"""The model interface every engine entry point consumes (port of the
``Model`` NamedTuple of ``repro/models/transformer.py``) and the He
initialiser of ``repro/models/layers.py``."""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

Params = Dict[str, torch.Tensor]


class Model(NamedTuple):
    cfg: Any
    init: Callable[[int], Params]                 # seed -> params on device
    forward: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor]
    loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor]
    prefill: Optional[Callable]
    decode: Optional[Callable]
    init_cache: Optional[Callable]
    device: torch.device


def he_normal(gen: torch.Generator, shape, fan_in=None) -> torch.Tensor:
    """N(0, 1/fan_in) f32 draw on the CPU from `gen` (fan_in defaults to
    shape[0]); the same seed gives the same values on every device."""
    fan_in = fan_in or shape[0]
    return torch.randn(shape, generator=gen) / math.sqrt(fan_in)
