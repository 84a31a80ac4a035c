from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models.base import Model
from repro_torch.models.cnn import PaperCNN, build_cnn
from repro_torch.models.transformer import (build_decoder_only, build_encdec,
                                            build_hybrid, build_rwkv,
                                            lm_eval_fn)


def build_model(cfg: ArchConfig, device: DeviceLike = None) -> Model:
    """The model for `cfg` on `device` (the CUDA device by default; raises
    without a GPU unless a device is named)."""
    if cfg.family == "cnn":
        return build_cnn(cfg, device)
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return build_decoder_only(cfg, device)
    if cfg.family == "hybrid":
        return build_hybrid(cfg, device)
    if cfg.family == "ssm":
        if cfg.ssm.kind == "rwkv6":
            return build_rwkv(cfg, device)
        return build_hybrid(cfg, device)
    if cfg.family == "encdec":
        return build_encdec(cfg, device)
    raise ValueError(cfg.family)


__all__ = ["Model", "PaperCNN", "build_cnn", "build_decoder_only",
           "build_encdec", "build_hybrid", "build_model", "build_rwkv",
           "lm_eval_fn"]
