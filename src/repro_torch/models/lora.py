"""LoRA adapter trees — the port of ``repro.models.lora``.

One ``{"a": [L, din, r], "b": [L, r, dout]}`` pair per target projection,
float32 (adapters train in f32), applied as a low-rank bypass over the
frozen, shared base weights.  The model's projections go through
``project``, which computes the base product and the bypass in one
``kernels.lora_matmul`` call; ``apply`` is the unfused form, kept as the
plain version of the same function.

Multi-tenant serving stacks several tenants' trees into one
(``stack_adapters``: leaves ``[L, A, din, r]``, slot axis 1) and tags
each sequence with its slot (``adapter_idx`` [B] int32, < 0 for the
base model alone): ``project`` then runs ``segmented_lora_matmul`` over
the rows, ``apply_segmented`` is its unfused form.

On a mesh, ``project_sharded`` runs ``project`` on a rank's block of the
base weight, the adapter tree staying replicated (it is tiny): B cut
with W's columns on a column-parallel projection, A cut with W's rows
on a row-parallel one, whose base and bypass partials are summed
together by one all-reduce: sum_r (x_r W_r + s (x_r A_r) B) = x W +
s (x A) B, exact up to rounding.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import collectives as col
from repro_torch.kernels.lora_matmul import (
    LoRAMatmulFn, lora_matmul, segmented_lora_matmul,
)
from repro_torch.tree import tree_map


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


def lora_shapes(cfg: ModelConfig, stacked: int) -> Dict:
    """The shapes of ``init_lora``'s tree: ``{target: {"a": (stacked,
    din, r), "b": (stacked, r, dout)}}``."""
    dims = target_dims(cfg)
    r = cfg.lora.rank
    return {t: {"a": (stacked, dims[t][0], r), "b": (stacked, r, dims[t][1])}
            for t in cfg.lora.targets if t in dims}


def init_lora(generator: torch.Generator, cfg: ModelConfig,
              stacked: int) -> Dict:
    """One (a, b) pair per target, stacked over ``stacked`` layers:
    a ~ N(0, 1/din), b = 0 (the adapter starts as a no-op), float32."""
    dev = generator.device
    out = {}
    for t, shp in lora_shapes(cfg, stacked).items():
        a = torch.randn(shp["a"], generator=generator, dtype=torch.float32,
                        device=dev) / math.sqrt(shp["a"][1])
        b = torch.zeros(shp["b"], dtype=torch.float32, device=dev)
        out[t] = {"a": a, "b": b}
    return out


def apply(x: torch.Tensor, base_out: torch.Tensor, pair: Optional[Dict],
          scaling: float, adapter_idx=None) -> torch.Tensor:
    """base_out + scaling * (x @ A) @ B, with A and B cast to x's dtype
    first (as the JAX bypass does).  With ``adapter_idx`` set, ``pair``
    holds one layer's slot stack and each row applies its own slot
    (``apply_segmented``)."""
    if pair is None:
        return base_out
    if adapter_idx is not None:
        return apply_segmented(x, base_out, pair, adapter_idx, scaling)
    a = pair["a"].to(x.dtype)
    b = pair["b"].to(x.dtype)
    return base_out + ((x @ a) @ b) * scaling


def apply_segmented(x: torch.Tensor, base_out: torch.Tensor, pair: Dict,
                    adapter_idx: torch.Tensor,
                    scaling: float) -> torch.Tensor:
    """Per-row adapter selection over one layer's slot stack: x [B, S,
    din]; pair ``{"a": [A, din, r], "b": [A, r, dout]}``; adapter_idx [B]
    int, the row's slot (clamped to the last), < 0 for the base output
    bitwise: the select comes after the products, so a stale or NaN slot
    never reaches those rows."""
    a = pair["a"].to(x.dtype)
    b = pair["b"].to(x.dtype)
    idx = adapter_idx.long()
    sel = idx.clamp(0, a.shape[0] - 1)
    xa = torch.einsum("bsk,bkr->bsr", x, a[sel])
    low = torch.einsum("bsr,brn->bsn", xa, b[sel])
    y = base_out + low * scaling
    return torch.where((idx >= 0)[:, None, None], y, base_out)


def stack_adapters(trees: "list[Dict]") -> Dict:
    """Stack same-structure adapter trees into one multi-slot tree:
    leaves go from ``[L, din, r]`` to ``[L, k, din, r]`` (slot axis 1, so
    the layer loop still slices axis 0)."""
    return tree_map(lambda *leaves: torch.stack(leaves, dim=1), *trees)


def project(x: torch.Tensor, w: torch.Tensor, pair: Optional[Dict],
            scaling: float, adapter_idx=None) -> torch.Tensor:
    """x @ w + scaling * (x @ A) @ B in one fused ``lora_matmul`` over
    x's rows, with A and B cast to x's dtype first (as the JAX bypass
    does); through ``LoRAMatmulFn`` when autograd has to see it.  Without
    an adapter it is the plain product ``x @ w``.  With ``adapter_idx``
    [B] (per sequence of x [B, ...]), ``pair`` is one layer's slot stack
    and one ``segmented_lora_matmul`` runs every row of x against its
    sequence's slot; that path has no gradient."""
    if pair is None:
        return x @ w
    a = pair["a"].to(x.dtype)
    b = pair["b"].to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if adapter_idx is not None:
        if torch.is_grad_enabled() and (x2.requires_grad or a.requires_grad
                                        or b.requires_grad):
            raise ValueError("segmented_lora_matmul has no gradient; train "
                             "one adapter tree without adapter_idx")
        rows = adapter_idx.to(device=x.device, dtype=torch.int32)
        if x2.shape[0] != rows.numel():     # one slot per sequence
            rows = rows.repeat_interleave(x2.shape[0] // rows.numel())
        y = segmented_lora_matmul(x2, w, a, b, rows, scaling)
        return y.reshape(*x.shape[:-1], w.shape[1])
    if torch.is_grad_enabled() and (x2.requires_grad or a.requires_grad
                                    or b.requires_grad):
        y = LoRAMatmulFn.apply(x2, w, a, b, scaling)
    else:
        y = lora_matmul(x2, w, a, b, scaling)
    return y.reshape(*x.shape[:-1], w.shape[1])


def project_sharded(x: torch.Tensor, w: torch.Tensor, w_spec,
                    pair: Optional[Dict], scaling: float, x_axes=(),
                    rows=(), reduce: bool = True, adapter_idx=None):
    """``project`` on a mesh: x [..., K_x] whose rows (dim 0) are cut along
    the axes ``rows`` and whose features are cut along ``x_axes``; ``w``
    this rank's block of a whole ``[K, N]`` weight cut as ``w_spec`` (two
    spec entries) says.  Returns (y, the axes y's last dim is cut along).

    A weight dim cut along an axis the rows are cut along is gathered
    whole first (FSDP: those ranks hold other rows).  The contraction dim
    keeps its other cuts: x's features are brought to it (a view where x
    is whole) and the partial products are summed over them (row
    parallel).  The output dim keeps its other cuts (column parallel).
    ``reduce=False`` returns (partial, the axes still to sum over, the
    output's axes) for a caller that sums several projections at once
    (``psum_rounded`` on their concatenation).  With every spec entry
    None (outside a mesh) it is ``project`` (``adapter_idx`` included)
    and every collective is the identity."""
    k_ax, n_ax = (col.axes_of(e) for e in w_spec)

    def fsdp(axes):
        cut = tuple(a for a in axes if a in rows)
        if cut and cut != axes:
            raise NotImplementedError(
                f"a weight dim cut along {axes} with rows cut along {rows}")
        return cut

    k_g, n_g = fsdp(k_ax), fsdp(n_ax)
    w = col.all_gather(col.all_gather(w, k_g, 0), n_g, 1)
    k_rest = () if k_g else k_ax
    n_rest = () if n_g else n_ax
    x = col.reshard_dim(x, -1, x_axes, k_rest)
    if pair is not None and (k_rest or n_rest):
        pair = {"a": col.local_slice(pair["a"], k_rest, 0).contiguous(),
                "b": col.local_slice(pair["b"], n_rest, 1).contiguous()}
    y = project(x, w, pair, scaling, adapter_idx)
    if not reduce:
        return y, k_rest, n_rest
    return psum_rounded(y, k_rest), n_rest


def psum_rounded(y: torch.Tensor, axes) -> torch.Tensor:
    """Partial products summed over ``axes`` in float32 and rounded to
    their dtype once (a bf16 sum would round at every add)."""
    if not col.axes_of(axes):
        return y
    return col.psum(y.float(), axes).to(y.dtype)
