"""The paper's 3-block CNN classifier (appendix D.5; port of
``repro/models/cnn.py``), NHWC activations and HWIO conv weights.

`PaperCNN` is an `nn.Module` whose parameters carry the reference's leaf
names (``c1.b``, ``c1.w``, …, ``fc2.w``). The engine moves parameters as a
name → tensor dict and applies them with `torch.func.functional_call`, so
pools stack per leaf exactly as the reference's pytrees do.

Two formulations of one network:

* ``forward`` — `F.conv2d` + max-pool, the counterpart of the reference's
  `lax.conv` graph, used for evaluation and by the steps the strategies
  build over ``loss_fn`` itself (DFedSAM's SAM step, MetaFed's anchored
  step), as in the reference. It runs under `native_conv_flags`: cuDNN's
  TF32 off, so the card computes in f32 as the reference does, and
  deterministic algorithms, so a step repeats bit for bit. The steps hold
  the same flags around their `torch.autograd.grad` as well, since the
  convs' backward picks its algorithms under the flags in force when
  autograd runs it, after this forward's block has exited.
* ``fused_forward`` — im2col + the GEMM kernel and reshape-max
  (`kernels/local_step`), attached to ``loss_fn`` under `FUSED_LOSS_ATTR`; the
  trainer builds every step over it, so each conv's forward and both of
  its gradients run through the hand-written GEMM.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.local_step import (FUSED_LOSS_ATTR, conv2d_gemm,
                                            maxpool2x2)
from repro_torch.models.base import Model, Params, he_normal

_CONVS = ("c1", "c2", "c3")


def native_conv_flags():
    """cuDNN's flags for the native formulation, as a context manager:
    enabled, TF32 off, no benchmark search, deterministic algorithms. It
    sets nothing process-wide; hold it around a forward *and* the
    `torch.autograd.grad` that differentiates it."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class _Affine(nn.Module):
    """A layer holding ``b`` then ``w`` (the reference's leaf order)."""

    def __init__(self, w_shape, n_out, device=None):
        super().__init__()
        self.b = nn.Parameter(torch.zeros(n_out, device=device))
        self.w = nn.Parameter(torch.zeros(w_shape, device=device))


class PaperCNN(nn.Module):
    """Three conv(3×3, SAME) + ReLU + 2×2 max-pool blocks of widths
    w, 2w, 4w on 32×32×3 images, then fc1 (4·4·4w → d_ff) + ReLU and fc2
    (d_ff → classes)."""

    def __init__(self, cfg: ArchConfig, device=None):
        super().__init__()
        w = cfg.d_model
        self.c1 = _Affine((3, 3, 3, w), w, device)
        self.c2 = _Affine((3, 3, w, 2 * w), 2 * w, device)
        self.c3 = _Affine((3, 3, 2 * w, 4 * w), 4 * w, device)
        self.fc1 = _Affine((4 * w * 16, cfg.d_ff), cfg.d_ff, device)
        self.fc2 = _Affine((cfg.d_ff, cfg.vocab_size), cfg.vocab_size,
                           device)

    def _head(self, x):
        x = x.reshape(x.shape[0], -1)                  # (B, 4*4*4w), NHWC
        x = F.relu(x @ self.fc1.w + self.fc1.b)
        return x @ self.fc2.w + self.fc2.b

    def forward(self, images: torch.Tensor, fused: bool = False):
        x = images.float()                             # (B, 32, 32, 3)
        if fused:
            for name in _CONVS:
                layer = getattr(self, name)
                x = maxpool2x2(F.relu(conv2d_gemm(x, layer.w, layer.b)))
            return self._head(x)
        x = x.permute(0, 3, 1, 2)                      # NCHW for cuDNN
        with native_conv_flags():
            for name in _CONVS:
                layer = getattr(self, name)
                x = F.conv2d(x, layer.w.permute(3, 2, 0, 1), layer.b,
                             padding="same")
                x = F.max_pool2d(F.relu(x), 2)
        return self._head(x.permute(0, 2, 3, 1))


def _xent(logits, labels):
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(lse - gold)


def build_cnn(cfg: ArchConfig, device: DeviceLike = None) -> Model:
    dev = resolve_device(device)
    net = PaperCNN(cfg, device="meta")   # structure only; params come in
    width, n_classes = cfg.d_model, cfg.vocab_size

    def init(seed: int) -> Params:
        """Fresh parameters on the model's device, drawn on the CPU from
        `seed` in the reference's key order (c1, c2, c3, fc1, fc2)."""
        gen = torch.Generator().manual_seed(int(seed))
        shapes = {"c1": (3, 3, 3, width), "c2": (3, 3, width, 2 * width),
                  "c3": (3, 3, 2 * width, 4 * width),
                  "fc1": (4 * width * 16, cfg.d_ff),
                  "fc2": (cfg.d_ff, n_classes)}
        params: Dict[str, torch.Tensor] = {}
        for name, shape in shapes.items():
            fan_in = 9 * shape[2] if name in _CONVS else None
            params[f"{name}.w"] = he_normal(gen, shape, fan_in)
            params[f"{name}.b"] = torch.zeros(shape[-1])
        return {k: params[k].to(dev) for k in sorted(params)}

    def forward(params: Params, batch) -> torch.Tensor:
        return functional_call(net, params, (batch["images"],))

    def fused_forward(params: Params, batch) -> torch.Tensor:
        return functional_call(net, params, (batch["images"],),
                               {"fused": True})

    def loss_fn(params: Params, batch) -> torch.Tensor:
        return _xent(forward(params, batch), batch["labels"])

    def fused_loss(params: Params, batch) -> torch.Tensor:
        return _xent(fused_forward(params, batch), batch["labels"])

    setattr(loss_fn, FUSED_LOSS_ATTR, fused_loss)
    return Model(cfg, init, forward, loss_fn, None, None, None, dev)
