"""Model configuration for the PyTorch port: the port's own copy of
``repro.configs.base`` (``Family``, ``LoRAConfig``, ``ModelConfig``),
kept field-for-field identical so a config built here describes the
same model as the JAX package's.  Family-specific fields are unused by
the others; reduced (smoke) variants are derived via ``scaled()``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class Family(str, enum.Enum):
    DENSE = "dense"      # decoder-only full-attention transformer
    SSM = "ssm"          # attention-free state-space (Mamba2 / SSD)
    HYBRID = "hybrid"    # parallel attention + SSM heads (Hymba)
    MOE = "moe"          # decoder-only with mixture-of-experts MLPs
    ENCODER = "encoder"  # encoder-only (HuBERT audio backbone)
    VLM = "vlm"          # decoder with interleaved cross-attention layers


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """LoRA adapter surface (the paper's unified PEFT interface)."""
    rank: int = 16
    alpha: float = 32.0
    # projections that receive adapters; subset of
    # {"q","k","v","o","gate","up","down","ssm_in","ssm_out"}
    targets: Tuple[str, ...] = ("q", "k", "v", "o")
    dropout: float = 0.0

    @property
    def scaling(self) -> float:
        return self.alpha / float(self.rank)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads

    # ---- attention options -------------------------------------------------
    qk_norm: bool = False                  # qwen3-style per-head RMSNorm
    qkv_bias: bool = False                 # qwen1.5-style projection bias
    rope_theta: float = 10000.0
    sliding_window: int = 0                # 0 = full attention
    # ---- SSM (mamba2 / hymba) ---------------------------------------------
    ssm_state: int = 0                     # d_state (N)
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    # ---- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ---- VLM ----------------------------------------------------------------
    cross_attn_every: int = 0              # every Nth layer is cross-attn
    vision_tokens: int = 1601              # stub frontend patch-embedding count
    # ---- encoder ------------------------------------------------------------
    encoder_only: bool = False
    # ---- numerics / memory ---------------------------------------------------
    dtype: str = "bfloat16"                # activations
    param_dtype: str = "bfloat16"
    remat: str = "none"                    # none | block | full
    scan_layers: bool = True
    attn_impl: str = "auto"                # auto | dense | blockwise
    unroll_attn_blocks: bool = False       # cost-calibration variant
    kv_cache_dtype: str = ""               # "" = activation dtype;
                                           # "float8_e4m3fn" halves caches
    # ---- adapters -----------------------------------------------------------
    lora: LoRAConfig = dataclasses.field(default_factory=LoRAConfig)
    # ---- MoE sharding mode: "ep" experts over model axis, "tp" ff over it ---
    moe_shard: str = "auto"
    # ---- provenance ----------------------------------------------------------
    source: str = ""

    # ------------------------------------------------------------------ utils
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(
                f"{self.name}: n_heads={self.n_heads} not divisible by "
                f"n_kv_heads={self.n_kv_heads}")

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.family is not Family.SSM

    @property
    def has_ssm(self) -> bool:
        return self.family in (Family.SSM, Family.HYBRID)

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (sub-quadratic attention)."""
        return self.family is Family.SSM or (
            self.family is Family.HYBRID and self.sliding_window > 0)

    # ---------------------------------------------------------- param counts
    def param_count(self) -> int:
        """Total base parameters (embedding included, untied head)."""
        d, h = self.d_model, self.head_dim
        per_layer = 0
        if self.has_attention:
            per_layer += d * (self.n_heads * h)            # q
            per_layer += 2 * d * (self.n_kv_heads * h)     # k, v
            per_layer += (self.n_heads * h) * d            # o
            if self.qkv_bias:
                per_layer += (self.n_heads + 2 * self.n_kv_heads) * h
        if self.has_ssm:
            di, n = self.ssm_d_inner, self.ssm_state
            per_layer += d * (2 * di + 2 * n + self.ssm_n_heads)  # in_proj
            per_layer += di * d                                   # out_proj
            per_layer += self.ssm_conv_width * (di + 2 * n)       # conv
            per_layer += 2 * self.ssm_n_heads                     # A_log, D
        if self.d_ff > 0:
            ff = 3 * d * self.d_ff                          # gate/up/down
            if self.family is Family.MOE:
                per_layer += self.n_experts * ff + d * self.n_experts
            else:
                per_layer += ff
        per_layer += 2 * d                                  # 2 rmsnorm scales
        total = self.n_layers * per_layer
        total += self.vocab_size * d                        # embed
        if not self.encoder_only:
            total += self.vocab_size * d                    # lm head (untied)
        total += d                                          # final norm
        if self.family is Family.VLM and self.cross_attn_every:
            n_cross = self.n_layers // self.cross_attn_every
            cross = 2 * (d * self.n_heads * h + d * self.n_kv_heads * h)
            total += n_cross * (cross + 2 * d)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family is not Family.MOE or not self.n_experts:
            return self.param_count()
        ff = 3 * self.d_model * self.d_ff
        inactive = self.n_layers * (self.n_experts - self.top_k) * ff
        return self.param_count() - inactive

    def lora_param_count(self) -> int:
        d, h, r = self.d_model, self.head_dim, self.lora.rank
        dims = {
            "q": (d, self.n_heads * h), "k": (d, self.n_kv_heads * h),
            "v": (d, self.n_kv_heads * h), "o": (self.n_heads * h, d),
            "gate": (d, self.d_ff), "up": (d, self.d_ff),
            "down": (self.d_ff, d),
            "ssm_in": (d, 2 * self.ssm_d_inner + 2 * self.ssm_state
                       + self.ssm_n_heads),
            "ssm_out": (self.ssm_d_inner, d),
        }
        total = 0
        for t in self.lora.targets:
            if t not in dims:
                continue
            di, do = dims[t]
            if do <= 0 or di <= 0:
                continue
            total += r * (di + do)
        return self.n_layers * total

    # ----------------------------------------------------------- reductions
    def scaled(self, *, n_layers: int = 2, d_model: int = 128,
               n_heads: int = 4, d_ff: int = 256, vocab_size: int = 512,
               **kw) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kv = max(1, self.n_kv_heads * n_heads // self.n_heads)
        upd = dict(
            name=self.name + "-smoke", n_layers=n_layers, d_model=d_model,
            n_heads=n_heads, n_kv_heads=kv, head_dim=d_model // n_heads,
            d_ff=0 if self.d_ff == 0 else d_ff, vocab_size=vocab_size,
            dtype="float32", param_dtype="float32", remat="none",
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32),
            ssm_chunk=32,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            sliding_window=min(self.sliding_window, 32)
            if self.sliding_window else 0,
            # keep ≥1 full (self*, cross) unit in reduced VLM stacks
            cross_attn_every=min(self.cross_attn_every, max(n_layers, 2))
            if self.cross_attn_every else 0,
            vision_tokens=16 if self.family is Family.VLM else self.vision_tokens,
            lora=dataclasses.replace(self.lora, rank=4, alpha=8.0),
        )
        upd.update(kw)
        return dataclasses.replace(self, **upd)
