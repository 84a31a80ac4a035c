"""Step functions and their input specs (port of
``repro/launch/steps.py``).

    train   → train_step(params, opt_state, batch, pool, step) → (params,
              opt_state, task): the FedELMY train step. The task loss
              (the model's `fused_loss_for` twin) plus −α·log_scale(d1) +
              β·log_scale(d2) with the l2 measure, then an Adam update
              (`optim.make_optimizer` from the FedConfig; f32 moments,
              the new params cast to the params' dtype). d1 and d2 come
              from the pool: a `MomentPool` (the default form) gives d1 =
              sqrt(mean_sq_distance + 1e-12) and d2 through the sweep over
              its anchor on the card; a stacked `ModelPool` gives both
              from one sweep (`core.distances.d1_d2_pool_distance`, the
              same math as the reference's two calls). With
              ``REPRO_MICROBATCH`` = N > 1 (read when `make_step` is
              called) the batch's rows go as N contiguous blocks, each
              block's task gradient summed into f32 in block order, task
              the blocks' mean; the regularizers' gradient is taken once,
              with task detached, and added in f32. The step runs eagerly
              and is functional: the caller's tensors are not changed.
    prefill → prefill_step(params, batch): the full prompt's forward,
              returning the last position's logits and the KV/SSM cache.
    decode  → serve_step(params, token, cache, pos): ONE token against the
              cache, returning its logits and the cache. For the dense
              family the step is a `CapturedDecode`, the counterpart of
              the reference's ``jax.jit(model.decode)``: one CUDA graph
              on the card, replayed every token; the MoE, MLA, `vlm`
              and `audio` families', built by the same
              `build_decoder_only`, likewise. The hybrid's, RWKV6's and
              the encoder-decoder's decode run eagerly (their decode
              takes a host position).

`input_specs(cfg, shape, fed)` gives every argument of that step as
tensors on the meta device, shapes and dtypes with nothing allocated:
the counterpart of the reference's `jax.ShapeDtypeStruct` specs, under the
reference's keys. The params come from the model's own `init`, run on
fake tensors (`param_specs_for`), so specs and init cannot drift; the
pool's form follows ``REPRO_POOL_FORM`` ("moment" by default; "exact" is a
`ModelPool` of `pool_size` + 1 slots), as in the reference."""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, FedConfig, ShapeConfig
from repro_torch.core.distances import (d1_d2_pool_distance, d1_moment,
                                        d2_anchor_distance, log_scale)
from repro_torch.core.pool import ModelPool, MomentPool
from repro_torch.device import DeviceLike
from repro_torch.kernels import build
from repro_torch.kernels.local_step import fused_loss_for
from repro_torch.models import build_model
from repro_torch.models.base import Model, Params
from repro_torch.models.transformer import (DECODE_INTO_ATTR,
                                            check_decode_pos, param_dtype)
from repro_torch.optim import make_optimizer

I32 = torch.int32
F32 = torch.float32
META = torch.device("meta")


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shapes and dtypes, nothing allocated)
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _abstract(fn: Callable[[], Dict[str, torch.Tensor]]
              ) -> Dict[str, torch.Tensor]:
    """The name → tensor dict `fn()` returns, run on fake tensors (nothing
    allocated, no kernel run), as meta tensors of the same shapes and
    dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        out = fn()
    return {k: _spec(tuple(v.shape), v.dtype) for k, v in out.items()}


def batch_specs_for(cfg: ArchConfig, shape: ShapeConfig
                    ) -> Dict[str, torch.Tensor]:
    """The batch of a `shape.kind` step: images and labels for the CNN;
    int32 tokens (and labels for train) of (B, T) for a language model,
    and for the encoder-decoder the source frame embeddings `src_embeds`
    (B, T, d_model) in the param dtype; one token (B, 1) and a 0-d
    position for decode."""
    b, t = shape.global_batch, shape.seq_len
    if cfg.family == "cnn":
        return {"images": _spec((b, 32, 32, 3), F32),
                "labels": _spec((b,), I32)}
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": _spec((b, t), I32)}
        if shape.kind == "train":
            specs["labels"] = _spec((b, t), I32)
        if cfg.family == "encdec":
            specs["src_embeds"] = _spec((b, t, cfg.d_model),
                                        param_dtype(cfg))
        return specs
    return {"token": _spec((b, 1), I32), "pos": _spec((), I32)}


def cache_specs_for(cfg: ArchConfig, shape: ShapeConfig
                    ) -> Dict[str, torch.Tensor]:
    """The model's `init_cache(B, T)` as meta tensors (the
    encoder-decoder's cross leaves at T source entries, as the
    reference's)."""
    model = build_model(cfg, "cpu")
    return _abstract(lambda: model.init_cache(shape.global_batch,
                                              shape.seq_len))


def param_specs_for(cfg: ArchConfig) -> Params:
    """The model's `init` as meta tensors: the same names, shapes and
    dtypes as real params, from the same code."""
    model = build_model(cfg, "cpu")
    return _abstract(lambda: model.init(0))


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                fed: Optional[FedConfig] = None) -> Dict[str, Any]:
    """Every argument of the step that `make_step` returns, as meta
    tensors: params, opt_state, batch, pool and step for train (the pool
    by ``REPRO_POOL_FORM``); params and batch for prefill; params, token,
    cache and pos for decode."""
    fed = fed or FedConfig()
    params = param_specs_for(cfg)
    if shape.kind == "train":
        opt = make_optimizer(fed.optimizer, fed.learning_rate,
                             fed.weight_decay)
        if os.environ.get("REPRO_POOL_FORM", "moment") == "exact":
            # paper-faithful pool: S + 1 stacked full copies
            pool = ModelPool.create(params, fed.pool_size + 1)
        else:
            pool = MomentPool.create(params)
        return {"params": params, "opt_state": opt.init(params),
                "batch": batch_specs_for(cfg, shape), "pool": pool,
                "step": _spec((), I32)}
    if shape.kind == "prefill":
        return {"params": params, "batch": batch_specs_for(cfg, shape)}
    b = batch_specs_for(cfg, shape)
    return {"params": params, "token": b["token"],
            "cache": cache_specs_for(cfg, shape), "pos": b["pos"]}


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

class CapturedDecode:
    """The decode step of `build_decoder_only`'s families on static
    buffers: the token (B, 1) int64, the position (0-d int64), the cache
    under the names and shapes of the model's `init_cache(batch,
    seq_len)` (``{"k", "v"}`` of (L, B, W, KV, hd); with MLA ``{"c_kv",
    "k_rope"}`` of (L, B, W, r) and (L, B, W, rope)) and the f32 logits
    (B, 1, V). The buffers are made at the first call, the cache in the
    dtype of the cache passed in.

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
        self.batch = batch
        self.cache_shapes = {
            n: tuple(v.shape) for n, v in cache_specs_for(
                model.cfg, ShapeConfig("decode", seq_len, batch,
                                       "decode")).items()}
        self.entries = next(iter(self.cache_shapes.values()))[2]
        self.token = self.pos = self.cache = self.logits = None
        self.captured = self.stream = None      # (graph, counts)
        self._ptrs = None
        self.captures = self.replays = self.cache_loads = 0

    def _buffers(self, cache) -> None:
        dev, b = self.model.device, self.batch
        self.token = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.cache = {n: torch.zeros(shape, dtype=cache[n].dtype, device=dev)
                      for n, shape in self.cache_shapes.items()}
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
        if set(cache) != set(self.cache):
            raise ValueError(f"CapturedDecode: cache {sorted(cache)}; the "
                             f"step's buffers are {sorted(self.cache)}")
        if all(cache[n] is self.cache[n] for n in self.cache):
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
        check_decode_pos(self.model.cfg, pos, self.entries)
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


def _row_blocks(batch: Dict[str, torch.Tensor], n: int
                ) -> List[Dict[str, torch.Tensor]]:
    """The batch's n contiguous row blocks in order, views: the blocks of
    the reference's ``a.reshape(n, B // n, …)``."""
    rows = next(iter(batch.values())).shape[0]
    if rows % n:
        raise ValueError(f"REPRO_MICROBATCH={n} does not divide the batch's "
                         f"{rows} rows")
    r = rows // n
    return [{k: v[i * r:(i + 1) * r] for k, v in batch.items()}
            for i in range(n)]


def _grads(loss: torch.Tensor, leaves: Params) -> Params:
    return dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _make_train_step(model: Model, fed: FedConfig, regularizers: bool,
                     n_micro: int) -> Callable:
    """The FedELMY train step of `model` (see the module docstring), with
    the task gradient accumulated over `n_micro` row blocks."""
    opt = make_optimizer(fed.optimizer, fed.learning_rate, fed.weight_decay)
    step_loss = fused_loss_for(model.loss_fn)

    def reg_terms(p: Params, task: torch.Tensor, pool) -> torch.Tensor:
        if isinstance(pool, ModelPool):
            d1, d2 = d1_d2_pool_distance(p, pool, "l2")
        else:
            d1 = d1_moment(p, pool)
            d2 = d2_anchor_distance(p, pool.first(), "l2")
        return (-fed.alpha * log_scale(d1, task)
                + fed.beta * log_scale(d2, task))

    def train_step(params: Params, opt_state, batch, pool, step
                   ) -> Tuple[Params, Any, torch.Tensor]:
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        if n_micro > 1:
            grads = {k: torch.zeros(v.shape, dtype=F32, device=v.device)
                     for k, v in params.items()}
            t_sum = torch.zeros((), dtype=F32,
                                device=next(iter(params.values())).device)
            for block in _row_blocks(batch, n_micro):
                t = step_loss(leaves, block)
                for k, g in _grads(t, leaves).items():
                    grads[k].add_(g)
                t_sum = t_sum + t.detach()
            task = t_sum / n_micro
            for g in grads.values():
                g.div_(n_micro)
            if regularizers:
                for k, g in _grads(reg_terms(leaves, task, pool),
                                   leaves).items():
                    grads[k].add_(g.to(F32))
        else:
            task = step_loss(leaves, batch)
            total = task + reg_terms(leaves, task, pool) if regularizers \
                else task
            grads = _grads(total, leaves)
            task = task.detach()
        params, opt_state = opt.update(params, grads, opt_state, step)
        return params, opt_state, task

    return train_step


def make_step(cfg: ArchConfig, shape: ShapeConfig,
              fed: Optional[FedConfig] = None, regularizers: bool = True, *,
              device: DeviceLike = None) -> Callable:
    """The step function of `shape.kind` for `cfg`'s model on `device`
    (the CUDA device by default): the train step (``REPRO_MICROBATCH``
    read here), prefill, or decode (a `CapturedDecode` at the shape's
    batch and sequence length for `build_decoder_only`'s families)."""
    model = build_model(cfg, device)
    if shape.kind == "train":
        return _make_train_step(model, fed or FedConfig(), regularizers,
                                int(os.environ.get("REPRO_MICROBATCH",
                                                   "1")))
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return model.prefill(params, batch)
        return prefill_step
    if shape.kind == "decode":
        if cfg.family in ("dense", "moe", "vlm", "audio"):
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
