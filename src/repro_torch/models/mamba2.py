"""Mamba2 SSD (state-space duality) mixer — the port of
``repro.models.mamba2``.

The chunked SSD algorithm (Dao & Gu, arXiv:2405.21060): within a chunk
the recurrence is a decay-masked quadratic form, across chunks a state
is carried.  Prefill runs it through ``kernels.ssd_scan`` (the
hand-written kernel on the card, its plain version on the CPU); decode
keeps the state ``[Bt, H, P, N]`` and takes O(1) per token.

Shapes, single B/C group:
  x:  [Bt, S, H, P]     dt: [Bt, S, H]     A: [H] (negative)
  B:  [Bt, S, N]        C:  [Bt, S, N]

Both LoRA projections (``ssm_in`` on ``in_proj``, ``ssm_out`` on
``out_proj``) go through ``lora.project``, one ``lora_matmul`` each.
Apart from that the arithmetic and its casts are the JAX mixer's.
Params are a dict with the JAX ``SSMParams`` fields; ``A_log``,
``D_skip`` and ``dt_bias`` stay float32 whatever the param dtype.
``pad_storage`` keeps ``in_proj`` in storage padded to whole 16-byte
rows, a view of the JAX shape (hymba-1.5b's width, 6,482, is no
multiple of 8; the bf16 ``lora_matmul`` wrapper would otherwise copy it
into such storage on every call).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.lora_matmul import pad_columns
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import lora as lora_lib
from repro_torch.models.layers import dense_init, rms_norm

# leaves the JAX init keeps in float32 (``convert.py`` reads this too)
FLOAT32_LEAVES = ("A_log", "D_skip", "dt_bias")
# LoRA-projected weights ``pad_storage`` keeps in padded storage
PADDED_LEAVES = ("in_proj",)


def pad_storage(tree):
    """``tree`` (a params tree, nested dicts) with every leaf named in
    ``PADDED_LEAVES`` in padded storage (``lora_matmul.pad_columns``; a
    copy where the width is no multiple of 8, else the leaf itself):
    ``Model.init`` and ``convert.params_from_numpy`` hand their trees
    through it."""
    if not isinstance(tree, dict):
        return tree
    return {k: pad_columns(v) if k in PADDED_LEAVES else pad_storage(v)
            for k, v in tree.items()}


def init_ssm(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    d, di, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, \
        cfg.ssm_n_heads
    dtype = getattr(torch, cfg.param_dtype)
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    conv_w = torch.randn((cfg.ssm_conv_width, di + 2 * n), generator=gen,
                         **f32) * 0.1
    return {
        "in_proj": dense_init(gen, d, 2 * di + 2 * n + h, dtype),
        "out_proj": dense_init(gen, di, d, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((di + 2 * n,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D_skip": torch.ones((h,), **f32),
        "dt_bias": torch.full((h,), math.log(math.expm1(0.01)), **f32),
        "norm": torch.ones((di,), dtype=dtype, device=dev),
    }


def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    """gate [.., di], conv input [.., di + 2N], dt [.., H] (views)."""
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
    return torch.split(zxbcdt, [di, di + 2 * n, h], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d over ``[state ‖ xbc]``, then SiLU.
    xbc: [Bt,S,C]; w: [W,C].  Returns (out [Bt,S,C], new tail
    [Bt,W-1,C])."""
    width = w.shape[0]
    if state is None:
        state = torch.zeros((xbc.shape[0], width - 1, xbc.shape[-1]),
                            dtype=xbc.dtype, device=xbc.device)
    xext = torch.cat([state, xbc], dim=1)
    s = xbc.shape[1]
    out = sum(xext[:, i:i + s] * w[i] for i in range(width))
    new_state = xext[:, xext.shape[1] - (width - 1):]
    return F.silu(out + b), new_state


# the reference's name for the chunked SSD scan: (x, dt, A, B, C, *,
# chunk, init_state) -> (y [Bt,S,H,P] in x's dtype, final state
# [Bt,H,P,N] float32), the kernel on the card
ssd_chunked = ssd_scan


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One-token SSD recurrence.  state: [Bt,H,P,N]; x_t: [Bt,H,P];
    dt_t: [Bt,H]; B_t/C_t: [Bt,N].  Returns (y_t [Bt,H,P], new state)."""
    da = dt_t * A[None, :]
    decay = torch.exp(da)[:, :, None, None]
    inject = torch.einsum("bh,bn,bhp->bhpn", dt_t, B_t, x_t)
    new_state = state * decay + inject
    y = torch.einsum("bhpn,bn->bhp", new_state, C_t)
    return y, new_state


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device,
                   stacked: int = 0) -> Dict:
    """{"conv": [.., Bt, W-1, d_inner + 2N] in ``dtype``, "state":
    [.., Bt, H, P, N] float32}, zeros; ``stacked`` adds a leading layer
    axis."""
    di, n, h, p = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads,
                   cfg.ssm_head_dim)
    lead = (stacked,) if stacked else ()
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv_width - 1,
                                    di + 2 * n), dtype=dtype, device=device),
        "state": torch.zeros(lead + (batch, h, p, n), dtype=torch.float32,
                             device=device),
    }


def ssm_mixer(params: Dict, x: torch.Tensor, cfg: ModelConfig,
              cache: Optional[Dict] = None, lora=None
              ) -> Tuple[torch.Tensor, Dict]:
    """Full Mamba2 mixer: in_proj -> conv -> SSD -> gated norm -> out_proj.

    x: [Bt,S,D].  With ``cache`` and S == 1 runs the O(1) decode path.
    ``lora``: one layer's adapter tree ("ssm_in"/"ssm_out" pairs).
    Returns (out [Bt,S,D], {"conv", "state"}): prefill's conv tail and
    final state, or decode's new ones (new tensors; the caller writes
    them into its cache)."""
    di, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_n_heads
    p = cfg.ssm_head_dim
    sc = cfg.lora.scaling
    A = -torch.exp(params["A_log"].float())

    zxbcdt = lora_lib.project(x, params["in_proj"],
                              lora.get("ssm_in") if lora else None, sc)
    z, xbc, dt_raw = _split_in_proj(cfg, zxbcdt)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())

    decode = cache is not None and x.shape[1] == 1
    xbc_conv, new_conv = _causal_conv(
        xbc, params["conv_w"], params["conv_b"],
        cache["conv"] if cache is not None else None)
    xs, B, C = torch.split(xbc_conv, [di, n, n], dim=-1)
    bt, s = xs.shape[0], xs.shape[1]
    xh = xs.reshape(bt, s, h, p)

    if decode:
        y, new_state = ssd_decode_step(
            cache["state"], xh[:, 0].float(), dt[:, 0], A,
            B[:, 0].float(), C[:, 0].float())
        y = y[:, None]
    else:
        y, new_state = ssd_chunked(
            xh, dt, A, B.float(), C.float(), chunk=cfg.ssm_chunk,
            init_state=cache["state"] if cache is not None else None)
        # the tail alone: a view would keep the layer's whole [Bt, S + W-1,
        # d_inner + 2N] conv input alive until prefill stacks the caches
        new_conv = new_conv.clone()

    y = y + xh.float() * params["D_skip"][None, None, :, None]
    y = y.reshape(bt, s, di).to(x.dtype)
    # gated RMSNorm (mamba2): norm(y * silu(z))
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["norm"])
    out = lora_lib.project(y, params["out_proj"],
                           lora.get("ssm_out") if lora else None, sc)
    return out, {"conv": new_conv, "state": new_state}
