from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike
from repro_torch.models.base import Model
from repro_torch.models.cnn import PaperCNN, build_cnn


def build_model(cfg: ArchConfig, device: DeviceLike = None) -> Model:
    """The model for `cfg` on `device` (the CUDA device by default; raises
    without a GPU unless a device is named)."""
    if cfg.family == "cnn":
        return build_cnn(cfg, device)
    raise NotImplementedError(
        f"model family {cfg.family!r} is not ported yet (the transformer "
        "family arrives with its own slice)")


__all__ = ["Model", "PaperCNN", "build_cnn", "build_model"]
