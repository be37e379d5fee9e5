"""LoRA adapter trees — the port of ``repro.models.lora``.

One ``{"a": [L, din, r], "b": [L, r, dout]}`` pair per target projection,
float32 (adapters train in f32), applied as a low-rank bypass over the
frozen, shared base weights.  The model's projections go through
``project``, which computes the base product and the bypass in one
``kernels.lora_matmul`` call; ``apply`` is the unfused form, kept as the
plain version of the same function.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.lora_matmul import LoRAMatmulFn, lora_matmul


def target_dims(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    d, h = cfg.d_model, cfg.head_dim
    dims = {
        "q": (d, cfg.n_heads * h),
        "k": (d, cfg.n_kv_heads * h),
        "v": (d, cfg.n_kv_heads * h),
        "o": (cfg.n_heads * h, d),
    }
    if cfg.d_ff > 0:
        dims.update({"gate": (d, cfg.d_ff), "up": (d, cfg.d_ff),
                     "down": (cfg.d_ff, d)})
    if cfg.has_ssm:
        dims.update({
            "ssm_in": (d, 2 * cfg.ssm_d_inner + 2 * cfg.ssm_state
                       + cfg.ssm_n_heads),
            "ssm_out": (cfg.ssm_d_inner, d),
        })
    return dims


def init_lora(generator: torch.Generator, cfg: ModelConfig,
              stacked: int) -> Dict:
    """One (a, b) pair per target, stacked over ``stacked`` layers:
    a ~ N(0, 1/din), b = 0 (the adapter starts as a no-op)."""
    dims = target_dims(cfg)
    r = cfg.lora.rank
    dev = generator.device
    out = {}
    for t in cfg.lora.targets:
        if t not in dims:
            continue
        din, dout = dims[t]
        a = torch.randn((stacked, din, r), generator=generator,
                        dtype=torch.float32, device=dev) / math.sqrt(din)
        b = torch.zeros((stacked, r, dout), dtype=torch.float32, device=dev)
        out[t] = {"a": a, "b": b}
    return out


def apply(x: torch.Tensor, base_out: torch.Tensor, pair: Optional[Dict],
          scaling: float, adapter_idx=None) -> torch.Tensor:
    """base_out + scaling * (x @ A) @ B, with A and B cast to x's dtype
    first (as the JAX bypass does)."""
    if pair is None:
        return base_out
    if adapter_idx is not None:
        raise NotImplementedError(
            "per-row adapter selection (multi-LoRA serving) is not ported "
            "yet; see ROADMAP.md")
    a = pair["a"].to(x.dtype)
    b = pair["b"].to(x.dtype)
    return base_out + ((x @ a) @ b) * scaling


def project(x: torch.Tensor, w: torch.Tensor, pair: Optional[Dict],
            scaling: float) -> torch.Tensor:
    """x @ w + scaling * (x @ A) @ B in one fused ``lora_matmul`` over
    x's rows, with A and B cast to x's dtype first (as the JAX bypass
    does); through ``LoRAMatmulFn`` when autograd has to see it.  Without
    an adapter it is the plain product ``x @ w``."""
    if pair is None:
        return x @ w
    a = pair["a"].to(x.dtype)
    b = pair["b"].to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and (x2.requires_grad or a.requires_grad
                                    or b.requires_grad):
        y = LoRAMatmulFn.apply(x2, w, a, b, scaling)
    else:
        y = lora_matmul(x2, w, a, b, scaling)
    return y.reshape(*x.shape[:-1], w.shape[1])
