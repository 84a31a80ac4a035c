"""The dense decoder-only transformer (port of `build_decoder_only`,
`lm_logits`, `chunked_xent` and `lm_eval_fn` of
``repro/models/transformer.py``, dense family only).

Parameters are a name → tensor dict in the reference's leaf order:
``embed``, ``final_norm.scale``, ``layers.attn.{wk,wo,wq,wv}``,
``layers.ffn.{w_down,w_gate,w_up}``, ``layers.ln1.scale``,
``layers.ln2.scale`` (each layer leaf stacked on a leading L axis) and,
untied, ``lm_head``; reference pytrees convert by plain copy
(`repro_torch.convert.from_jax_params`). The reference's layer scan is a
Python loop over the L-stacked leaves. Init draws on the model's device
from a `torch.Generator` there: it matches the reference in distribution,
not in values (parity tests carry the reference's init across).

The forward carries the factored-serving hook (`models/factored.py`), as
the reference's dense family does. Prefill, cached decode and the other
families (MoE, MLA, hybrid, RWKV, encoder-decoder) are not ported: they
raise `NotImplementedError` naming their slice."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.base import Model, Params
from repro_torch.models.factored import (FACTORED_FORWARD_ATTR,
                                         make_decoder_factored)

LOSS_CHUNK = 512
ACC = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def param_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


def sub_params(params: Params, prefix: str) -> Params:
    """The leaves under ``prefix.`` with the prefix stripped."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def layer_params(params: Params, l: int) -> Params:
    """Layer l's slice of every ``layers.`` leaf, names without the
    prefix (contiguous views: the layer axis leads)."""
    return {k: v[l] for k, v in sub_params(params, "layers").items()}


def lm_eval_fn(model: Model, test_batch: Dict) -> Callable:
    """Held-out evaluation for an LM client: the mean negative NLL over a
    fixed {tokens, labels} batch (higher is better, as `Experiment.eval_fn`
    expects)."""
    batch = {k: torch.as_tensor(v).to(model.device)
             for k, v in test_batch.items()}

    def nll(params):
        with torch.no_grad():
            return -model.loss_fn(params, batch)
    return nll


def _unembed_w(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def lm_logits(params: Params, cfg: ArchConfig, h: torch.Tensor):
    """(…, D) final hidden states → f32 logits (…, V)."""
    h = L.rms_norm(params["final_norm.scale"], h, cfg.norm_eps)
    return L.matmul_f32(h, _unembed_w(params, cfg))


def chunked_xent(params: Params, cfg: ArchConfig, h: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over chunks of LOSS_CHUNK positions
    (a ragged tail beyond the last whole chunk is dropped, as in the
    reference), never holding (B, T, V) logits at once."""
    b, t, _ = h.shape
    h = L.rms_norm(params["final_norm.scale"], h, cfg.norm_eps)
    w = _unembed_w(params, cfg)
    chunk = min(LOSS_CHUNK, t)
    n = t // chunk
    tot = torch.zeros((), dtype=ACC, device=h.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        logits = L.matmul_f32(h[:, sl], w)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, sl, None].long())[..., 0]
        tot = tot + torch.sum(lse - gold)
    return tot / (b * n * chunk)


def _block_fwd(lp: Params, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(lp["ln1.scale"], x, cfg.norm_eps)
    x = x + L.self_attention(sub_params(lp, "attn"), cfg, h, positions)
    h = L.rms_norm(lp["ln2.scale"], x, cfg.norm_eps)
    return x + L.mlp(sub_params(lp, "ffn"), h)


def _init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Fresh parameters on the generator's device: embed N(0, 0.02²),
    He-normal matrices (fan-in = the input dim), unit norm scales; the
    layer leaves drawn stacked on their leading L axis."""
    dt, dev, d = param_dtype(cfg), gen.device, cfg.d_model
    lead = (cfg.n_layers,)
    emb = torch.randn((cfg.vocab_size, d), generator=gen, device=dev)
    p = {"embed": (emb * 0.02).to(dt),
         "final_norm.scale": L.rms_norm_init(d, dt, dev)["scale"]}
    p.update({f"layers.attn.{k}": v
              for k, v in L.attn_init(gen, cfg, dt, lead).items()})
    p.update({f"layers.ffn.{k}": v
              for k, v in L.mlp_init(gen, d, cfg.d_ff, dt, lead).items()})
    for name in ("ln1", "ln2"):
        p[f"layers.{name}.scale"] = L.rms_norm_init(d, dt, dev,
                                                    lead)["scale"]
    if not cfg.tie_embeddings:
        p["lm_head"] = L._he(gen, (d, cfg.vocab_size), dt)
    return p


def _not_ported(what: str, slice_: str) -> Callable:
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{what} is not ported yet (it arrives "
                                  f"with {slice_})")
    return fn


def build_decoder_only(cfg: ArchConfig, device: DeviceLike = None) -> Model:
    dev = resolve_device(device)

    def init(seed: int) -> Params:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return _init_params(cfg, gen)

    def backbone(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        b, t = tokens.shape
        x = params["embed"][tokens.long()]
        positions = torch.arange(t, device=tokens.device).expand(b, t)
        for l in range(cfg.n_layers):
            x = _block_fwd(layer_params(params, l), cfg, x, positions)
        return x

    def forward(params: Params, batch) -> torch.Tensor:
        return lm_logits(params, cfg, backbone(params, batch["tokens"]))

    setattr(forward, FACTORED_FORWARD_ATTR, make_decoder_factored(cfg))

    def loss_fn(params: Params, batch) -> torch.Tensor:
        x = backbone(params, batch["tokens"])
        return chunked_xent(params, cfg, x, batch["labels"])

    slice_ = "the cached-decode slice"
    return Model(cfg, init, forward, loss_fn,
                 _not_ported("prefill", slice_), _not_ported("decode", slice_),
                 _not_ported("init_cache", slice_), dev)
