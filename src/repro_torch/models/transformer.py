"""Model factories of the language-model families (port of
`build_decoder_only`, `build_hybrid`, `build_rwkv`, `lm_logits`,
`build_encdec`, `chunked_xent` and `lm_eval_fn` of
``repro/models/transformer.py``: the dense decoder-only family (also the
backbone of the `vlm` and `audio` families, as in the reference), its
Mixture-of-Experts variant, its Multi-head Latent Attention variant (MLA,
deepseek-v2), the hybrid (Mamba2 layers with a weight-tied attention +
MLP block between segments, zamba2), RWKV6 and the encoder-decoder
(seamless-m4t)).

Parameters are a name → tensor dict in the reference's leaf order:
``embed``, ``final_norm.scale``, ``layers.attn.{wk,wo,wq,wv}``,
``layers.ffn.{w_down,w_gate,w_up}``, ``layers.ln1.scale``,
``layers.ln2.scale`` (each layer leaf stacked on a leading L axis) and,
untied, ``lm_head``; with `cfg.moe` the layer's FFN leaves are
``layers.ffn.{router,shared.*,w_down,w_gate,w_up}`` (`models/moe.py`:
the router f32, the expert stacks (L, E, ·, ·)); with `cfg.mla` the
attention leaves are ``layers.attn.{kv_norm.scale,w_dkv,w_dq,w_kr,w_uk,
w_uv,wo}`` (`layers.mla_init`). Reference pytrees
convert by plain copy (`repro_torch.convert.from_jax_params`). The reference's layer scan is a
Python loop over the L-stacked leaves. Init draws on the model's device
from a `torch.Generator` there: it matches the reference in distribution,
not in values (parity tests carry the reference's init across).

The dense forward carries the factored-serving hook (`models/factored.py`),
as the reference's dense family does; the MoE and MLA decoders have none
(routing and the latent are not factored sites), so a pool of such
members serves densified, as in the reference. The MoE backbone carries the layers'
summed aux loss, which `loss_fn` adds to the cross-entropy and `forward`
drops; prefill and decode run the MoE FFN and drop it. Its capacity
follows the routed token count (B·T at prefill, B at decode), so
prefill(T−1) + decode(1) equals prefill(T) only where no token was
dropped. Every family has the reference's whole interface: forward,
loss, `init_cache`, `prefill` (the last position's logits and the
cache) and one-token `decode`.

The dense cache is ``{"k", "v"}``, each (L, B, W, KV, hd) with W =
`cache_len(cfg, seq_len)`. Prefill attends through `layers.
flash_attention` (the kernel on the card) and, when the prompt is longer
than the sliding window, ring-packs the cache to the window's W entries
(`_ring_pack`: entry i holds the latest position ≡ i mod W). Decode
follows the reference's arithmetic: it writes at slot pos % W (pos
without a window) and takes entry i to hold position pos − ((pos − i) mod
W). That is right for the two layouts prefill leaves: a prompt shorter
than the window with the cache grown by the new tokens, and a ring-packed
cache not grown. A grown ring cache, or a short prompt's cache not grown,
gives the reference's wrong logits, and the port's equal them (ROADMAP
C14). Without a window, decode at pos ≥ W raises where the reference
clamps the write (C8). `decode` copies the cache and returns the copy;
its attribute ``decode_into`` is the body on the cache in place with pos
a 0-d device tensor, which `launch.steps.CapturedDecode` captures in a
CUDA graph.

The MLA cache is the latent, ``{"c_kv": (L, B, W, r), "k_rope": (L, B,
W, rope)}``. Prefill attends through `layers.mla_attention` (the
kernel's (192, 128) instance on the card at deepseek's dims) and keeps
each layer's latent; decode writes the new latent at the same slot as
the dense cache and attends as the reference's `_mla_decode_attn` does:
every step up-projects the whole latent cache through w_uk and w_uv and
takes a plain masked softmax (entries at positions ≤ pos, the mask
computed on the device), no kernel.

The hybrid's and RWKV6's leaves are ``embed``, ``final_norm.scale``,
``layers.*`` (L-stacked), ``lm_head`` and, for the hybrid,
``shared_attn.*``. The hybrid's decode writes the new key and value into
copies of ``shared_k``/``shared_v`` at `pos` and raises when `pos` lies
past their length (grow them after prefill, as
``examples/serve_batched.py`` does); the reference clamps such a write.

The encoder-decoder's leaves are ``embed``, ``final_norm.scale``,
``lm_head``, ``encoder.{attn,ffn,ln1,ln2}.*`` (n_encoder_layers-stacked)
and ``decoder.{cross_attn,ffn,ln1,ln2,ln_x,self_attn}.*`` (L-stacked).
Its batch carries ``src_embeds`` (B, T_src, D), the stubbed audio
frontend's frame embeddings, cast to the param dtype; the encoder attends
over them non-causally with rope, the decoder causally over its tokens
and, through `layers.cross_attention`, non-causally over the encoder's
output (Tq ≠ Tk). Its cache is ``{"k", "v"}`` (L, B, W, KV, hd), the
decoder's self-attention, and ``{"cross_k", "cross_v"}`` (L, B, T_src,
KV, hd), each layer's keys and values of the encoder's output, kept by
prefill. Decode writes the new key and value at `pos` into copies of k
and v and attends over them and over every source entry with
`layers.decode_attention`; it returns the cross leaves as they came and
raises at pos ≥ W, where the reference clamps the write (ROADMAP C8)."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
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


def layer_params(params: Params, l: int, prefix: str = "layers") -> Params:
    """Layer l's slice of every ``{prefix}.`` leaf, names without the
    prefix (contiguous views: the layer axis leads)."""
    return {k: v[l] for k, v in sub_params(params, prefix).items()}


EVAL_ROWS = 16


def lm_eval_fn(model: Model, test_batch: Dict) -> Callable:
    """Held-out evaluation for an LM client: the mean negative NLL over a
    fixed {tokens, labels} batch (higher is better, as `Experiment.eval_fn`
    expects). The batch is scored EVAL_ROWS sequences at a time and the
    chunks' losses averaged by their rows (the whole batch's mean, summed
    in another order): a full-vocabulary model's f32 logits for the whole
    held-out set need not exist at once."""
    batch = {k: torch.as_tensor(v).to(model.device)
             for k, v in test_batch.items()}
    n = next(iter(batch.values())).shape[0]
    starts = range(0, n, EVAL_ROWS)

    def nll(params):
        with torch.no_grad():
            if n <= EVAL_ROWS:
                return -model.loss_fn(params, batch)
            total = sum(model.loss_fn(params, {k: v[i:i + EVAL_ROWS]
                                               for k, v in batch.items()})
                        * min(EVAL_ROWS, n - i) for i in starts)
            return -total / n
    return nll


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of `tokens` (any int dtype). Through
    `F.embedding`, whose backward sums a repeated token's rows in a fixed
    order on either device: the backward of indexing (`index_put_` with
    accumulate) adds them on the CPU with atomic adds from several threads,
    in an order that follows the threads' timing (ROADMAP C19)."""
    return torch.nn.functional.embedding(tokens.long(), params["embed"])


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


def _block_ffn(lp: Params, cfg: ArchConfig, x: torch.Tensor):
    """x plus the layer's FFN (the MLP, or the MoE layer), and the FFN's
    aux loss (0 for the MLP)."""
    h = L.rms_norm(lp["ln2.scale"], x, cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = MOE.moe_ffn(sub_params(lp, "ffn"), cfg, h)
        return x + y, aux
    return x + L.mlp(sub_params(lp, "ffn"), h), 0.0


def _block_fwd(lp: Params, cfg: ArchConfig, x: torch.Tensor,
               positions: torch.Tensor):
    h = L.rms_norm(lp["ln1.scale"], x, cfg.norm_eps)
    attn = sub_params(lp, "attn")
    if cfg.mla is not None:
        c_kv, k_rope = L.mla_latent(attn, cfg, h, positions)
        x = x + L.mla_attention(attn, cfg, h, positions, c_kv, k_rope)
    else:
        x = x + L.self_attention(attn, cfg, h, positions)
    return _block_ffn(lp, cfg, x)


def _prefixed(prefix: str, params: Params) -> Params:
    return {f"{prefix}.{k}": v for k, v in params.items()}


def _in_leaf_order(params: Params) -> Params:
    """The reference's leaf order: keys sorted at every level."""
    return dict(sorted(params.items(), key=lambda kv: kv[0].split(".")))


def _embed_init(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """embed N(0, 0.02²) and the final norm's unit scale."""
    dt, dev, d = param_dtype(cfg), gen.device, cfg.d_model
    emb = torch.randn((cfg.vocab_size, d), generator=gen, device=dev)
    return {"embed": (emb * 0.02).to(dt),
            "final_norm.scale": L.rms_norm_init(d, dt, dev)["scale"]}


def _lm_head_init(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Untied embeddings: a He-normal lm_head (drawn last)."""
    if cfg.tie_embeddings:
        return {}
    return {"lm_head": L._he(gen, (cfg.d_model, cfg.vocab_size),
                             param_dtype(cfg))}


def _norm_scales(cfg: ArchConfig, dev, names, lead) -> Params:
    dt = param_dtype(cfg)
    return {f"{name}.scale": L.rms_norm_init(cfg.d_model, dt, dev,
                                             lead)["scale"]
            for name in names}


def _init_params(cfg: ArchConfig, gen: torch.Generator) -> Params:
    """Fresh parameters on the generator's device: embed N(0, 0.02²),
    He-normal matrices (fan-in = the input dim), unit norm scales; the
    layer leaves drawn stacked on their leading L axis."""
    dt, dev, d = param_dtype(cfg), gen.device, cfg.d_model
    lead = (cfg.n_layers,)
    p = _embed_init(cfg, gen)
    attn_init = L.mla_init if cfg.mla is not None else L.attn_init
    p.update(_prefixed("layers.attn", attn_init(gen, cfg, dt, lead)))
    if cfg.moe is not None:
        p.update(_prefixed("layers.ffn", MOE.moe_init(gen, cfg, dt, lead)))
    else:
        p.update(_prefixed("layers.ffn", L.mlp_init(gen, d, cfg.d_ff, dt,
                                                    lead)))
    p.update(_prefixed("layers", _norm_scales(cfg, dev, ("ln1", "ln2"),
                                              lead)))
    p.update(_lm_head_init(cfg, gen))
    return p


DECODE_INTO_ATTR = "decode_into"


def cache_len(cfg: ArchConfig, seq_len: int) -> int:
    """The entries of a dense KV cache for `seq_len` positions: at most
    the sliding window's."""
    w = cfg.sliding_window
    return min(seq_len, w) if w else seq_len


def _ring_pack(c: torch.Tensor, t: int, w: int) -> torch.Tensor:
    """The last w of a prompt's t positions (axis 2), rolled so that entry
    i holds the latest position p with p % w == i."""
    return torch.roll(c[:, :, t - w:], (t - w) % w, dims=2)


def check_decode_pos(cfg: ArchConfig, pos, w: int) -> None:
    """Raise for a decode position a cache of `w` entries (the dense or
    the MLA cache: axis 2 of either's leaves) cannot take: a negative one, or, without a sliding window, one at or past w
    (the reference clamps that write onto the last entry, ROADMAP C8). A
    tensor `pos` is read to the host only where there is a bound to
    check (no window)."""
    if isinstance(pos, torch.Tensor) and cfg.sliding_window:
        return
    p = int(pos)
    if p < 0:
        raise ValueError(f"decode at a negative position {p}")
    if not cfg.sliding_window and p >= w:
        raise ValueError(
            f"decode at position {p} past the KV cache's {w} entries "
            "(no sliding window): grow the cache after prefill")


def build_decoder_only(cfg: ArchConfig, device: DeviceLike = None) -> Model:
    dev = resolve_device(device)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    window = cfg.sliding_window

    def init(seed: int) -> Params:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        return _init_params(cfg, gen)

    def backbone(params: Params, tokens: torch.Tensor):
        """The final hidden states and the layers' summed aux loss (0.0
        without MoE)."""
        b, t = tokens.shape
        x = embed_tokens(params, tokens)
        positions = torch.arange(t, device=tokens.device).expand(b, t)
        aux = 0.0
        for l in range(cfg.n_layers):
            x, a = _block_fwd(layer_params(params, l), cfg, x, positions)
            aux = aux + a
        return x, aux

    def forward(params: Params, batch) -> torch.Tensor:
        return lm_logits(params, cfg, backbone(params, batch["tokens"])[0])

    if cfg.moe is None and cfg.mla is None:
        setattr(forward, FACTORED_FORWARD_ATTR, make_decoder_factored(cfg))

    def loss_fn(params: Params, batch) -> torch.Tensor:
        x, aux = backbone(params, batch["tokens"])
        loss = chunked_xent(params, cfg, x, batch["labels"])
        return loss if cfg.moe is None else loss + aux

    def init_cache(batch: int, seq_len: int, dtype=None):
        dtype = dtype or param_dtype(cfg)
        lead = (cfg.n_layers, batch, cache_len(cfg, seq_len))
        if cfg.mla is not None:
            widths = {"c_kv": cfg.mla.kv_lora_rank,
                      "k_rope": cfg.mla.qk_rope_dim}
            return {n: torch.zeros(lead + (w,), dtype=dtype, device=dev)
                    for n, w in widths.items()}
        return {n: torch.zeros(lead + (kv, hd), dtype=dtype, device=dev)
                for n in ("k", "v")}

    def prefill(params: Params, batch):
        """The prompt's forward: the last position's f32 logits (B, 1, V)
        and the cache, ring-packed when the prompt passes the window."""
        tokens = batch["tokens"]
        b, t = tokens.shape
        x = embed_tokens(params, tokens)
        positions = torch.arange(t, device=tokens.device).expand(b, t)
        kept = []                   # a layer's (k, v) or (c_kv, k_rope)
        for l in range(cfg.n_layers):
            lp = layer_params(params, l)
            attn = sub_params(lp, "attn")
            h = L.rms_norm(lp["ln1.scale"], x, cfg.norm_eps)
            if cfg.mla is not None:
                kept.append(L.mla_latent(attn, cfg, h, positions))
                x = x + L.mla_attention(attn, cfg, h, positions, *kept[-1])
            else:
                q, k, v = L.attn_qkv(attn, cfg, h, positions)
                x = x + L.attn_out(attn, L.flash_attention(
                    q, k, v, causal=True, window=window))
                kept.append((k, v))
            x, _ = _block_ffn(lp, cfg, x)
        names = ("c_kv", "k_rope") if cfg.mla is not None else ("k", "v")
        cache = {n: torch.stack(c) for n, c in zip(names, zip(*kept))}
        if window and t > window:
            cache = {n: _ring_pack(c, t, window) for n, c in cache.items()}
        return lm_logits(params, cfg, x[:, -1:]), cache

    def decode_into(params: Params, token: torch.Tensor, cache,
                    pos: torch.Tensor) -> torch.Tensor:
        """One token (B, 1) at the 0-d int64 device position `pos`: writes
        its keys and values (MLA: its latent) into `cache` in place and
        returns the f32 logits (B, 1, V). It reads pos only on the device
        (no host sync, no branch on its value) and copies nothing from the
        host, so a CUDA graph can capture it; the caller checks pos
        (`check_decode_pos`)."""
        b = token.shape[0]
        w = _entries(cache)
        x = embed_tokens(params, token)
        idx = torch.arange(w, device=pos.device)
        if window:
            slot = torch.remainder(pos, w)
            entry_pos = pos - torch.remainder(pos - idx, w)
        else:
            slot, entry_pos = pos, idx
        slot = slot.reshape(1)
        entry_pos = entry_pos.expand(b, w)
        positions, pos_b = pos.expand(b, 1), pos.expand(b)
        valid = entry_pos[0] <= pos          # MLA's mask of the entries
        for l in range(cfg.n_layers):
            lp = layer_params(params, l)
            attn = sub_params(lp, "attn")
            h = L.rms_norm(lp["ln1.scale"], x, cfg.norm_eps)
            if cfg.mla is not None:
                c_new, r_new = L.mla_latent(attn, cfg, h, positions)
                c_l, r_l = cache["c_kv"][l], cache["k_rope"][l]
                c_l.index_copy_(1, slot, c_new.to(c_l.dtype))
                r_l.index_copy_(1, slot, r_new.to(r_l.dtype))
                a = _mla_decode_attn(attn, cfg, h, positions, c_l, r_l,
                                     valid)
            else:
                q, k, v = L.attn_qkv(attn, cfg, h, positions)
                k_l, v_l = cache["k"][l], cache["v"][l]
                k_l.index_copy_(1, slot, k.to(k_l.dtype))
                v_l.index_copy_(1, slot, v.to(v_l.dtype))
                a = L.attn_out(attn, L.decode_attention(
                    q, k_l, v_l, entry_pos, pos_b, window=window))
            x, _ = _block_ffn(lp, cfg, x + a)
        return lm_logits(params, cfg, x)

    def decode(params: Params, token: torch.Tensor, cache, pos):
        """One token (B, 1) at position `pos` (an int or a 0-d integer
        tensor on the model's device): the f32 logits (B, 1, V) and a new
        cache (the one passed in is left as it is)."""
        check_decode_pos(cfg, pos, _entries(cache))
        if isinstance(pos, torch.Tensor):
            pos = pos.to(torch.int64).reshape(())
        else:
            pos = torch.full((), int(pos), dtype=torch.int64,
                             device=token.device)
        cache = {n: c.clone() for n, c in cache.items()}
        return decode_into(params, token, cache, pos), cache

    setattr(decode, DECODE_INTO_ATTR, decode_into)
    return Model(cfg, init, forward, loss_fn, prefill, decode, init_cache,
                 dev)


def _entries(cache) -> int:
    """The entries of a dense or MLA cache: axis 2 of every leaf."""
    return next(iter(cache.values())).shape[2]


def _mla_decode_attn(p: Params, cfg: ArchConfig, h: torch.Tensor,
                     positions: torch.Tensor, c_kv: torch.Tensor,
                     k_rope: torch.Tensor, valid: torch.Tensor):
    """One query (B, 1, D) over the latent cache (c_kv (B, S, r), k_rope
    (B, S, rope)), entries where `valid` (S,) holds: the keys and values
    up-projected from the whole cache, f32 scores at scale (nope +
    rope)^-1/2, masked to −1e30, a plain softmax, out through wo (the
    reference's `_mla_decode_attn`)."""
    m = cfg.mla
    q, k, v = L.mla_qkv(p, cfg, h, positions, c_kv, k_rope)
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    sc = torch.einsum("bthd,bshd->bths", q.to(ACC) * scale, k.to(ACC))
    sc = torch.where(valid[None, None, None, :], sc,
                     torch.full_like(sc, L.NEG_INF))
    pr = torch.softmax(sc, dim=-1)
    o = torch.einsum("bths,bshd->bthd", pr, v.to(ACC)).to(h.dtype)
    return L.mla_out(p, o)


# ---------------------------------------------------------------------------
# Hybrid (Zamba2): Mamba2 backbone + weight-tied shared attention block
# ---------------------------------------------------------------------------

def build_hybrid(cfg: ArchConfig, device: DeviceLike = None) -> Model:
    """Mamba2 layers in `n_layers // shared_attn_every` segments with the
    weight-tied attention + MLP block after each (one segment and no
    shared block when `shared_attn_every` is 0: a pure Mamba2 stack)."""
    dev = resolve_device(device)
    every = cfg.shared_attn_every
    n_app = cfg.n_layers // every if every else 0
    n_seg = n_app if every else 1
    seg_len = cfg.n_layers // n_seg
    dm = SSM.mamba2_dims(cfg)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    conv_dim = dm.d_inner + 2 * dm.state

    def init(seed: int) -> Params:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        dt, d, lead = param_dtype(cfg), cfg.d_model, (cfg.n_layers,)
        p = _embed_init(cfg, gen)
        p.update(_prefixed("layers", _norm_scales(cfg, dev, ("ln",), lead)))
        p.update(_prefixed("layers.mixer",
                           SSM.mamba2_init(gen, cfg, dt, lead)))
        if every:
            p.update(_prefixed("shared_attn", _norm_scales(
                cfg, dev, ("ln1", "ln2"), ())))
            p.update(_prefixed("shared_attn.attn",
                               L.attn_init(gen, cfg, dt)))
            p.update(_prefixed("shared_attn.mlp",
                               L.mlp_init(gen, d, cfg.d_ff, dt)))
        p.update(_lm_head_init(cfg, gen))
        return _in_leaf_order(p)

    def segments():
        """(segment index, its layer indices)."""
        return [(si, range(si * seg_len, (si + 1) * seg_len))
                for si in range(n_seg)]

    def _shared_block(sp: Params, x, positions):
        h = L.rms_norm(sp["ln1.scale"], x, cfg.norm_eps)
        x = x + L.self_attention(sub_params(sp, "attn"), cfg, h, positions)
        h = L.rms_norm(sp["ln2.scale"], x, cfg.norm_eps)
        return x + L.mlp(sub_params(sp, "mlp"), h)

    def backbone(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        b, t = tokens.shape
        x = embed_tokens(params, tokens)
        positions = torch.arange(t, device=tokens.device).expand(b, t)
        sp = sub_params(params, "shared_attn")
        for _, layers in segments():
            for l in layers:
                lp = layer_params(params, l)
                x = x + SSM.mamba2_block(
                    sub_params(lp, "mixer"), cfg,
                    L.rms_norm(lp["ln.scale"], x, cfg.norm_eps))
            if every:
                x = _shared_block(sp, x, positions)
        return x

    def forward(params: Params, batch) -> torch.Tensor:
        return lm_logits(params, cfg, backbone(params, batch["tokens"]))

    def loss_fn(params: Params, batch) -> torch.Tensor:
        x = backbone(params, batch["tokens"])
        return chunked_xent(params, cfg, x, batch["labels"])

    def init_cache(batch: int, seq_len: int, dtype=None):
        dtype = dtype or param_dtype(cfg)
        c = {"ssm": torch.zeros((cfg.n_layers, batch, dm.n_heads, dm.state,
                                 dm.head_dim), dtype=ACC, device=dev),
             "conv": torch.zeros((cfg.n_layers, batch, dm.conv_width - 1,
                                  conv_dim), dtype=dtype, device=dev)}
        if every:
            for name in ("shared_k", "shared_v"):
                c[name] = torch.zeros((n_app, batch, seq_len, kv, hd),
                                      dtype=dtype, device=dev)
        return c

    def prefill(params: Params, batch):
        tokens = batch["tokens"]
        b, t = tokens.shape
        x = embed_tokens(params, tokens)
        positions = torch.arange(t, device=tokens.device).expand(b, t)
        sp = sub_params(params, "shared_attn")
        states, convs, sk, sv = [], [], [], []
        for _, layers in segments():
            for l in layers:
                lp = layer_params(params, l)
                mp = sub_params(lp, "mixer")
                h = L.rms_norm(lp["ln.scale"], x, cfg.norm_eps)
                q, k, v, ld, xh, z, conv = SSM._mamba2_qkvd(mp, cfg, h)
                y, st = SSM.gla_chunked(q, k, v, ld,
                                        chunk=min(cfg.ssm.chunk_size, t))
                x = x + SSM._mamba2_out(mp, cfg, h, y, xh, z)
                states.append(st)
                convs.append(conv)
            if every:
                attn = sub_params(sp, "attn")
                h = L.rms_norm(sp["ln1.scale"], x, cfg.norm_eps)
                q, k, v = L.attn_qkv(attn, cfg, h, positions)
                x = x + L.attn_out(attn, L.flash_attention(q, k, v,
                                                           causal=True))
                h = L.rms_norm(sp["ln2.scale"], x, cfg.norm_eps)
                x = x + L.mlp(sub_params(sp, "mlp"), h)
                sk.append(k)
                sv.append(v)
        cache = {"ssm": torch.stack(states), "conv": torch.stack(convs)}
        if every:
            cache["shared_k"] = torch.stack(sk)
            cache["shared_v"] = torch.stack(sv)
        return lm_logits(params, cfg, x[:, -1:]), cache

    def decode(params: Params, token: torch.Tensor, cache, pos):
        pos = int(pos)
        b = token.shape[0]
        x = embed_tokens(params, token)
        sp = sub_params(params, "shared_attn")
        if every:
            s_len = cache["shared_k"].shape[2]
            if not 0 <= pos < s_len:
                raise ValueError(
                    f"decode at position {pos} past the shared attention "
                    f"caches' {s_len} entries: grow shared_k/shared_v "
                    "after prefill")
            sk, sv = cache["shared_k"].clone(), cache["shared_v"].clone()
            positions = torch.full((b, 1), pos, device=token.device)
            entry_pos = torch.arange(s_len, device=token.device).expand(
                b, s_len)
            pos_b = torch.full((b,), pos, device=token.device)
        states, convs = [], []
        for si, layers in segments():
            for l in layers:
                lp = layer_params(params, l)
                h = L.rms_norm(lp["ln.scale"], x, cfg.norm_eps)
                y, st, conv = SSM.mamba2_decode(
                    sub_params(lp, "mixer"), cfg, h, cache["ssm"][l],
                    cache["conv"][l])
                x = x + y
                states.append(st)
                convs.append(conv)
            if every:
                attn = sub_params(sp, "attn")
                h = L.rms_norm(sp["ln1.scale"], x, cfg.norm_eps)
                q, k, v = L.attn_qkv(attn, cfg, h, positions)
                sk[si, :, pos] = k[:, 0].to(sk.dtype)
                sv[si, :, pos] = v[:, 0].to(sv.dtype)
                a = L.decode_attention(q, sk[si], sv[si], entry_pos, pos_b)
                x = x + L.attn_out(attn, a)
                h = L.rms_norm(sp["ln2.scale"], x, cfg.norm_eps)
                x = x + L.mlp(sub_params(sp, "mlp"), h)
        new_cache = {"ssm": torch.stack(states), "conv": torch.stack(convs)}
        if every:
            new_cache["shared_k"], new_cache["shared_v"] = sk, sv
        return lm_logits(params, cfg, x), new_cache

    return Model(cfg, init, forward, loss_fn, prefill, decode, init_cache,
                 dev)


# ---------------------------------------------------------------------------
# RWKV6 (pure SSM family)
# ---------------------------------------------------------------------------

def build_rwkv(cfg: ArchConfig, device: DeviceLike = None) -> Model:
    dev = resolve_device(device)
    s = cfg.ssm
    n_heads = cfg.d_model // s.head_dim

    def init(seed: int) -> Params:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        dt, d, lead = param_dtype(cfg), cfg.d_model, (cfg.n_layers,)
        p = _embed_init(cfg, gen)
        p.update(_prefixed("layers", _norm_scales(cfg, dev, ("ln1", "ln2"),
                                                  lead)))
        p.update(_prefixed("layers.mixer", SSM.rwkv6_init(gen, cfg, dt,
                                                          lead)))
        p.update(_prefixed("layers.ffn", L.mlp_init(gen, d, cfg.d_ff, dt,
                                                    lead)))
        p.update(_lm_head_init(cfg, gen))
        return _in_leaf_order(p)

    def _ffn(lp: Params, x):
        h = L.rms_norm(lp["ln2.scale"], x, cfg.norm_eps)
        return x + L.mlp(sub_params(lp, "ffn"), h)

    def backbone(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        x = embed_tokens(params, tokens)
        for l in range(cfg.n_layers):
            lp = layer_params(params, l)
            x = x + SSM.rwkv6_block(sub_params(lp, "mixer"), cfg,
                                    L.rms_norm(lp["ln1.scale"], x,
                                               cfg.norm_eps))
            x = _ffn(lp, x)
        return x

    def forward(params: Params, batch) -> torch.Tensor:
        return lm_logits(params, cfg, backbone(params, batch["tokens"]))

    def loss_fn(params: Params, batch) -> torch.Tensor:
        return chunked_xent(params, cfg, backbone(params, batch["tokens"]),
                            batch["labels"])

    def init_cache(batch: int, seq_len: int, dtype=None):
        dtype = dtype or param_dtype(cfg)
        return {"state": torch.zeros((cfg.n_layers, batch, n_heads,
                                      s.head_dim, s.head_dim), dtype=ACC,
                                     device=dev),
                "x_prev": torch.zeros((cfg.n_layers, batch, 1, cfg.d_model),
                                      dtype=dtype, device=dev)}

    def prefill(params: Params, batch):
        tokens = batch["tokens"]
        t = tokens.shape[1]
        x = embed_tokens(params, tokens)
        states, lasts = [], []
        for l in range(cfg.n_layers):
            lp = layer_params(params, l)
            mp = sub_params(lp, "mixer")
            h = L.rms_norm(lp["ln1.scale"], x, cfg.norm_eps)
            r, k, v, g, ld, x_last = SSM._rwkv6_inputs(
                mp, cfg, h, torch.zeros_like(h[:, :1]))
            y, st = SSM.gla_chunked(r, k, v, ld, chunk=min(32, t),
                                    bonus=torch.exp(mp["bonus_u"]))
            x = _ffn(lp, x + SSM._rwkv6_out(mp, cfg, h, y, g))
            states.append(st)
            lasts.append(x_last)
        return lm_logits(params, cfg, x[:, -1:]), \
            {"state": torch.stack(states), "x_prev": torch.stack(lasts)}

    def decode(params: Params, token: torch.Tensor, cache, pos):
        x = embed_tokens(params, token)
        states, prevs = [], []
        for l in range(cfg.n_layers):
            lp = layer_params(params, l)
            h = L.rms_norm(lp["ln1.scale"], x, cfg.norm_eps)
            y, st, xp = SSM.rwkv6_decode(sub_params(lp, "mixer"), cfg, h,
                                         cache["state"][l],
                                         cache["x_prev"][l])
            x = _ffn(lp, x + y)
            states.append(st)
            prevs.append(xp)
        return lm_logits(params, cfg, x), \
            {"state": torch.stack(states), "x_prev": torch.stack(prevs)}

    return Model(cfg, init, forward, loss_fn, prefill, decode, init_cache,
                 dev)


# ---------------------------------------------------------------------------
# Encoder-decoder (seamless-m4t): a stubbed audio frontend feeds embeddings
# ---------------------------------------------------------------------------

def build_encdec(cfg: ArchConfig, device: DeviceLike = None) -> Model:
    """A transformer encoder over precomputed frame embeddings and a
    decoder with cross-attention over its output (see the module
    docstring)."""
    dev = resolve_device(device)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dtype = param_dtype(cfg)

    def init(seed: int) -> Params:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        d, enc, dec = cfg.d_model, (cfg.n_encoder_layers,), (cfg.n_layers,)
        p = _embed_init(cfg, gen)
        p.update(_prefixed("encoder.attn", L.attn_init(gen, cfg, dtype, enc)))
        p.update(_prefixed("encoder.ffn",
                           L.mlp_init(gen, d, cfg.d_ff, dtype, enc)))
        p.update(_prefixed("encoder", _norm_scales(cfg, dev, ("ln1", "ln2"),
                                                   enc)))
        p.update(_prefixed("decoder.self_attn",
                           L.attn_init(gen, cfg, dtype, dec)))
        p.update(_prefixed("decoder.cross_attn",
                           L.cross_attn_init(gen, cfg, dtype, dec)))
        p.update(_prefixed("decoder.ffn",
                           L.mlp_init(gen, d, cfg.d_ff, dtype, dec)))
        p.update(_prefixed("decoder", _norm_scales(
            cfg, dev, ("ln1", "ln2", "ln_x"), dec)))
        p.update(_lm_head_init(cfg, gen))
        return _in_leaf_order(p)

    def _positions(b: int, t: int, device) -> torch.Tensor:
        return torch.arange(t, device=device).expand(b, t)

    def encode(params: Params, src: torch.Tensor) -> torch.Tensor:
        """src (B, T_src, D), the frame embeddings, cast to the param
        dtype; non-causal self-attention with rope."""
        b, t, _ = src.shape
        positions = _positions(b, t, src.device)
        x = src.to(dtype)
        for l in range(cfg.n_encoder_layers):
            lp = layer_params(params, l, "encoder")
            attn = sub_params(lp, "attn")
            h = L.rms_norm(lp["ln1.scale"], x, cfg.norm_eps)
            q, k, v = L.attn_qkv(attn, cfg, h, positions)
            x = x + L.attn_out(attn, L.flash_attention(q, k, v,
                                                       causal=False))
            x = x + L.mlp(sub_params(lp, "ffn"),
                          L.rms_norm(lp["ln2.scale"], x, cfg.norm_eps))
        return x

    def _cross_kv(lp: Params, enc_out: torch.Tensor):
        b, t, _ = enc_out.shape
        k = L._proj(enc_out, lp["cross_attn.wk"]).reshape(b, t, kv, hd)
        v = L._proj(enc_out, lp["cross_attn.wv"]).reshape(b, t, kv, hd)
        return k, v

    def _decode_layers(params: Params, tokens: torch.Tensor,
                       enc_out: torch.Tensor, keep: bool):
        """The decoder over `tokens` (B, T): its final hidden states and,
        with `keep`, each layer's (k, v, cross k, cross v)."""
        b, t = tokens.shape
        x = embed_tokens(params, tokens)
        positions = _positions(b, t, tokens.device)
        kept = []
        for l in range(cfg.n_layers):
            lp = layer_params(params, l, "decoder")
            self_p = sub_params(lp, "self_attn")
            h = L.rms_norm(lp["ln1.scale"], x, cfg.norm_eps)
            if keep:        # the reference's prefill: causal, no window
                q, k, v = L.attn_qkv(self_p, cfg, h, positions)
                x = x + L.attn_out(self_p, L.flash_attention(q, k, v,
                                                             causal=True))
            else:
                x = x + L.self_attention(self_p, cfg, h, positions)
            h = L.rms_norm(lp["ln_x.scale"], x, cfg.norm_eps)
            ck, cv = _cross_kv(lp, enc_out)
            x = x + L.cross_attention(sub_params(lp, "cross_attn"), cfg, h,
                                      (ck, cv))
            x = x + L.mlp(sub_params(lp, "ffn"),
                          L.rms_norm(lp["ln2.scale"], x, cfg.norm_eps))
            if keep:
                kept.append((k, v, ck, cv))
        return x, kept

    def forward(params: Params, batch) -> torch.Tensor:
        enc_out = encode(params, batch["src_embeds"])
        x, _ = _decode_layers(params, batch["tokens"], enc_out, False)
        return lm_logits(params, cfg, x)

    def loss_fn(params: Params, batch) -> torch.Tensor:
        enc_out = encode(params, batch["src_embeds"])
        x, _ = _decode_layers(params, batch["tokens"], enc_out, False)
        return chunked_xent(params, cfg, x, batch["labels"])

    def init_cache(batch: int, seq_len: int, dtype=None, src_len=None):
        dtype = dtype or param_dtype(cfg)
        src_len = src_len or seq_len
        return {n: torch.zeros((cfg.n_layers, batch, w, kv, hd),
                               dtype=dtype, device=dev)
                for n, w in (("k", seq_len), ("v", seq_len),
                             ("cross_k", src_len), ("cross_v", src_len))}

    def prefill(params: Params, batch):
        """Encode the source and run the decoder over the target prefix:
        the last position's f32 logits (B, 1, V) and the cache (each
        layer's self k/v over the prefix, cross k/v over the source)."""
        enc_out = encode(params, batch["src_embeds"])
        x, kept = _decode_layers(params, batch["tokens"], enc_out, True)
        cache = {n: torch.stack(c) for n, c in
                 zip(("k", "v", "cross_k", "cross_v"), zip(*kept))}
        return lm_logits(params, cfg, x[:, -1:]), cache

    def decode(params: Params, token: torch.Tensor, cache, pos):
        """One token (B, 1) at position `pos` (an int or a 0-d integer
        tensor): the f32 logits (B, 1, V) and a new cache, k and v
        written at pos in copies, the cross leaves passed through (the
        one passed in is left as it is)."""
        pos = int(pos)
        b = token.shape[0]
        s, s_src = cache["k"].shape[2], cache["cross_k"].shape[2]
        if not 0 <= pos < s:
            raise ValueError(
                f"decode at position {pos} past the KV cache's {s} entries "
                "(or negative): grow k/v after prefill")
        x = embed_tokens(params, token)
        positions = torch.full((b, 1), pos, device=token.device)
        pos_b = torch.full((b,), pos, device=token.device)
        entry_pos = torch.arange(s, device=token.device).expand(b, s)
        src_pos = torch.arange(s_src, device=token.device).expand(b, s_src)
        past_src = torch.full((b,), s_src + 1, device=token.device)
        k_all, v_all = cache["k"].clone(), cache["v"].clone()
        for l in range(cfg.n_layers):
            lp = layer_params(params, l, "decoder")
            self_p, cross_p = (sub_params(lp, "self_attn"),
                               sub_params(lp, "cross_attn"))
            h = L.rms_norm(lp["ln1.scale"], x, cfg.norm_eps)
            q, k, v = L.attn_qkv(self_p, cfg, h, positions)
            k_all[l, :, pos] = k[:, 0].to(k_all.dtype)
            v_all[l, :, pos] = v[:, 0].to(v_all.dtype)
            a = L.decode_attention(q, k_all[l], v_all[l], entry_pos, pos_b)
            x = x + L.attn_out(self_p, a)
            h = L.rms_norm(lp["ln_x.scale"], x, cfg.norm_eps)
            qc = L._proj(h, cross_p["wq"]).reshape(b, 1, cfg.n_heads, hd)
            ac = L.decode_attention(qc, cache["cross_k"][l],
                                    cache["cross_v"][l], src_pos, past_src)
            x = x + L.attn_out(cross_p, ac)
            x = x + L.mlp(sub_params(lp, "ffn"),
                          L.rms_norm(lp["ln2.scale"], x, cfg.norm_eps))
        return lm_logits(params, cfg, x), {**cache, "k": k_all, "v": v_all}

    return Model(cfg, init, forward, loss_fn, prefill, decode, init_cache,
                 dev)
