"""Serving step functions (port of the prefill and decode kinds of
``repro/launch/steps.py``).

    prefill → prefill_step(params, batch): the full prompt's forward,
              returning the last position's logits and the KV/SSM cache.
    decode  → serve_step(params, token, cache, pos): ONE token against the
              cache, returning its logits and the new cache.

The ``train`` kind (the FedELMY train step with the moment-form pool)
waits for the transformer training slice; the reference's
`ShapeDtypeStruct` input specs serve its dry-run only and have no
counterpart here."""
from __future__ import annotations

from typing import Callable, Tuple

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike
from repro_torch.models import build_model


def make_step(cfg: ArchConfig, shape: ShapeConfig,
              device: DeviceLike = None) -> Callable:
    """The step function of `shape.kind` for `cfg`'s model on `device`
    (the CUDA device by default)."""
    if shape.kind == "train":
        raise NotImplementedError(
            "make_step('train') is not ported yet (it arrives with the "
            "transformer training slice)")
    model = build_model(cfg, device)
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return model.prefill(params, batch)
        return prefill_step
    if shape.kind == "decode":
        def serve_step(params, token, cache, pos):
            return model.decode(params, token, cache, pos)
        return serve_step
    raise ValueError(f"unknown step kind {shape.kind!r}")


def shape_supported(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """The long_500k carve-out (DESIGN.md §4): decode at 500k runs only for
    bounded-state or sub-quadratic archs. The cnn check runs first so a
    classifier arch gets the accurate skip reason, not a KV-cache one."""
    if shape.kind in ("prefill", "decode") and cfg.family == "cnn":
        return False, "classifier arch: no autoregressive serving"
    if shape.name == "long_500k" and not cfg.supports_long_decode:
        return False, ("full-attention KV at 500k context — skipped per "
                       "DESIGN.md (no sub-quadratic variant for this arch)")
    return True, ""
