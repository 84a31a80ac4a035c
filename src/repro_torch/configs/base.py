"""Run configuration dataclasses (port of ``repro/configs/base.py``).

`ArchConfig` keeps the fields of the families this port runs — the paper
CNN, the dense decoder-only transformer (also the backbone of the
reference's `vlm` and `audio` families), its Mixture-of-Experts variant,
Multi-head Latent Attention (`mla`), the SSM family (RWKV6), the
hybrid (Mamba2 + a shared attention block) and the encoder-decoder
(`n_encoder_layers`) — with the reference's
defaults and its `reduced()` smoke-test variant; `ShapeConfig` and
`INPUT_SHAPES` are the reference's step shapes; `FedConfig` is the full
FedELMY hyper-parameter set with the reference's validation, error
messages included."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_size: int = 64          # N (per-channel state) for Mamba2
    head_dim: int = 64            # P
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 128
    kind: str = "mamba2"          # "mamba2" | "rwkv6"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    # cnn | dense | moe | ssm | hybrid | vlm | audio | encdec
    family: str
    n_layers: int                 # cnn: conv blocks
    d_model: int                  # cnn: base conv width
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int               # cnn: number of classes
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: apply one shared attention block every `shared_attn_every` layers
    shared_attn_every: int = 0
    n_encoder_layers: int = 0     # encdec: the encoder's layers
    sliding_window: int = 0       # 0 = full attention
    param_dtype: str = "bfloat16"
    source: str = ""              # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_decode(self) -> bool:
        """True if decoding at 500k context is sub-quadratic or holds a
        bounded state."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window > 0

    def reduced(self) -> "ArchConfig":
        """A smoke-test-sized variant of the same family (<=2 layers,
        d<=256), the reference's rules for the dense, MoE, MLA, SSM,
        hybrid and encoder-decoder families (MLA: its own small dims, and
        no head_dim)."""
        heads = min(4, self.n_heads)
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:         # keep heads % kv == 0
            kv -= 1
        d = min(256, self.d_model)
        moe = None if self.moe is None else MoEConfig(
            n_experts=min(4, self.moe.n_experts),
            top_k=min(2, self.moe.top_k),
            d_ff_expert=min(128, self.moe.d_ff_expert),
            n_shared_experts=min(1, self.moe.n_shared_experts))
        ssm = None if self.ssm is None else SSMConfig(
            state_size=min(16, self.ssm.state_size),
            head_dim=min(32, self.ssm.head_dim), expand=2, conv_width=4,
            chunk_size=32, kind=self.ssm.kind)
        mla = None if self.mla is None else MLAConfig(
            kv_lora_rank=64, qk_rope_dim=16, qk_nope_dim=32, v_head_dim=32)
        return dataclasses.replace(
            self, n_layers=min(2, self.n_layers), d_model=d, n_heads=heads,
            n_kv_heads=kv, d_ff=min(512, self.d_ff),
            vocab_size=min(1024, self.vocab_size),
            head_dim=None if mla else d // heads,
            param_dtype="float32", moe=moe, mla=mla, ssm=ssm,
            shared_attn_every=1 if self.shared_attn_every else 0,
            n_encoder_layers=min(2, self.n_encoder_layers),
            sliding_window=64 if self.sliding_window else 0)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# Valid FedConfig string knobs (the reference's lists, verbatim).
DISTANCE_MEASURES = ("l2", "l1", "cosine", "squared_l2")
OPTIMIZERS = ("sgd", "momentum", "adam", "adamw")


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """FedELMY hyper-parameters (paper Alg. 1 notation)."""
    n_clients: int = 10
    pool_size: int = 5            # S
    e_local: int = 200            # E_local (steps in the step-based trainer)
    e_warmup: int = 30            # E_w
    alpha: float = 0.06           # d1 scale
    beta: float = 1.0             # d2 scale
    learning_rate: float = 5e-5
    weight_decay: float = 1e-4
    optimizer: str = "adam"
    distance_measure: str = "l2"  # l2 | l1 | cosine | squared_l2
    use_d1: bool = True
    use_d2: bool = True
    use_pool: bool = True         # ablation: pool vs single model
    log_scale_distances: bool = True
    moment_form: bool = False     # legacy alias for pool_backend="moment"
    pool_backend: Optional[str] = None
    pool_rank: int = 8
    seed: int = 0

    def __post_init__(self):
        if self.distance_measure not in DISTANCE_MEASURES:
            raise ValueError(
                f"unknown distance_measure {self.distance_measure!r}; "
                f"expected one of {DISTANCE_MEASURES}")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(
                f"unknown optimizer {self.optimizer!r}; "
                f"expected one of {OPTIMIZERS}")
        if self.moment_form and self.pool_backend not in (None, "moment"):
            raise ValueError(
                f"moment_form=True conflicts with "
                f"pool_backend={self.pool_backend!r}; drop moment_form and "
                f"set pool_backend explicitly")
        if self.pool_rank < 1:
            raise ValueError(f"pool_rank must be >= 1, got {self.pool_rank}")
        if self.resolved_pool_backend == "lowrank" and \
                self.distance_measure not in ("l2", "squared_l2"):
            raise ValueError(
                "the low-rank delta pool computes distances from factor "
                "Grams, which is exact for l2/squared_l2 only; got "
                f"{self.distance_measure!r}. Use pool_backend='stacked' "
                "for l1/cosine.")
        if self.resolved_pool_backend == "moment" and \
                self.distance_measure != "squared_l2":
            raise ValueError(
                "the moment-form pool keeps only (μ, q) statistics and "
                "supports distance_measure='squared_l2' exactly; got "
                f"{self.distance_measure!r}. Use pool_backend='stacked' for "
                "l2/l1/cosine, or set distance_measure='squared_l2'.")

    @property
    def resolved_pool_backend(self) -> str:
        """Backend name for the pool registry."""
        if self.pool_backend is not None:
            return self.pool_backend
        return "moment" if self.moment_form else "stacked"
