"""Serving step functions (port of the prefill and decode kinds of
``repro/launch/steps.py``).

    prefill → prefill_step(params, batch): the full prompt's forward,
              returning the last position's logits and the KV/SSM cache.
    decode  → serve_step(params, token, cache, pos): ONE token against the
              cache, returning its logits and the cache. For the dense
              family the step is a `CapturedDecode`, the counterpart of
              the reference's ``jax.jit(model.decode)``: one CUDA graph
              on the card, replayed every token. The hybrid's and RWKV6's
              decode run eagerly (their decode takes a host position).

The ``train`` kind (the FedELMY train step with the moment-form pool)
waits for the transformer training slice; the reference's
`ShapeDtypeStruct` input specs serve its dry-run only and have no
counterpart here."""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.device import DeviceLike
from repro_torch.kernels import build
from repro_torch.models import build_model
from repro_torch.models.base import Model, Params
from repro_torch.models.transformer import (DECODE_INTO_ATTR, cache_len,
                                            check_decode_pos)


class CapturedDecode:
    """The dense family's decode step on static buffers: the token (B, 1)
    int64, the position (0-d int64), the cache ``{"k", "v"}`` of (L, B,
    `cache_len(cfg, seq_len)`, KV, hd) and the f32 logits (B, 1, V). The
    buffers are made at the first call, the cache in the dtype of the
    cache passed in.

    A call checks `pos` on the host (`check_decode_pos`: without a window,
    C8's bound), then copies the token and pos into their buffers, and the
    cache passed in unless it is the step's own (the one an earlier call
    returned): after prefill and the grow, the cache is copied in once
    (`cache_loads` counts the copies). The body is the model's in-place
    decode (``decode.decode_into``) on the buffers; it reads pos on the
    device, so the slot, the entries' positions and the window's mask are
    computed on the card and the new key and value are written in place.

    On CUDA the first call runs the body eagerly on a side stream (a real
    step), then captures it there into one CUDA graph; every later call
    is a replay (`captures`, `replays`). Params at other addresses (any
    leaf's `data_ptr`) are captured anew. A capture that fails raises;
    there is no eager fallback. On the CPU the body runs eagerly on the
    same buffers.

    Returns (logits, cache): the step's own buffers, which the next call
    overwrites (clone what must outlive it)."""

    def __init__(self, model: Model, batch: int, seq_len: int):
        if not hasattr(model.decode, DECODE_INTO_ATTR):
            raise ValueError(f"CapturedDecode: the {model.cfg.family} "
                             "family's decode has no in-place body")
        self.model = model
        self.body = getattr(model.decode, DECODE_INTO_ATTR)
        cfg = model.cfg
        self.cache_shape = (cfg.n_layers, batch, cache_len(cfg, seq_len),
                            cfg.n_kv_heads, cfg.resolved_head_dim)
        self.token = self.pos = self.cache = self.logits = None
        self.captured = self.stream = None      # (graph, counts)
        self._ptrs = None
        self.captures = self.replays = self.cache_loads = 0

    def _buffers(self, cache) -> None:
        dev, (_, b) = self.model.device, self.cache_shape[:2]
        self.token = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.cache = {n: torch.zeros(self.cache_shape, dtype=cache[n].dtype,
                                     device=dev) for n in ("k", "v")}
        self.logits = torch.zeros((b, 1, self.model.cfg.vocab_size),
                                  dtype=torch.float32, device=dev)

    def _load(self, token: torch.Tensor, cache, pos) -> None:
        if self.cache is None:
            self._buffers(cache)
        if tuple(token.shape) != tuple(self.token.shape):
            raise ValueError(f"CapturedDecode: token {tuple(token.shape)}; "
                             f"the step takes {tuple(self.token.shape)}")
        self.token.copy_(token)
        if isinstance(pos, torch.Tensor):
            self.pos.copy_(pos.reshape(()))
        else:
            self.pos.fill_(int(pos))
        if all(cache[n] is self.cache[n] for n in ("k", "v")):
            return
        for n, buf in self.cache.items():
            if cache[n].shape != buf.shape or cache[n].dtype != buf.dtype:
                raise ValueError(
                    f"CapturedDecode: cache[{n!r}] {tuple(cache[n].shape)} "
                    f"{cache[n].dtype}; the step's buffer is "
                    f"{tuple(buf.shape)} {buf.dtype}")
            buf.copy_(cache[n])
        self.cache_loads += 1

    def _run(self, params: Params) -> None:
        self.logits.copy_(self.body(params, self.token, self.cache,
                                    self.pos))

    def __call__(self, params: Params, token: torch.Tensor, cache, pos):
        check_decode_pos(self.model.cfg, pos, self.cache_shape[2])
        if self.model.device.type != "cuda":
            self._load(token, cache, pos)
            self._run(params)
            return self.logits, self.cache
        with build.side_stream(self, self.model.device):
            self._load(token, cache, pos)
            ptrs = tuple(v.data_ptr() for v in params.values())
            if ptrs != self._ptrs:
                self.captured = None
            self.captured, fresh, replays = build.graph_steps(
                self.captured, lambda: self._run(params))
            self._ptrs = ptrs
            self.captures += fresh
            self.replays += replays
        return self.logits, self.cache


def make_step(cfg: ArchConfig, shape: ShapeConfig,
              device: DeviceLike = None) -> Callable:
    """The step function of `shape.kind` for `cfg`'s model on `device`
    (the CUDA device by default); a dense decode step is a
    `CapturedDecode` at the shape's batch and sequence length."""
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
        if cfg.family == "dense":
            return CapturedDecode(model, shape.global_batch, shape.seq_len)

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
