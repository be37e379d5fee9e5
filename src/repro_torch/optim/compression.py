"""Gradient compression with error feedback (``repro.optim.compression``):
the compression error of one round is kept locally and added to the next
round's gradient instead of being lost.

  * top-k sparsification: keep the k largest-|g| entries per tensor,
    k = max(1, int(size * frac)); every entry at or above the k-th
    largest |g| is kept (``>=``), so ties at the threshold keep more
    than k entries;
  * int8 symmetric quantization with a per-tensor float32 scale
    ``max(max |g|, 1e-12) / 127``, rounded half to even (as
    ``jnp.round``), optionally stochastic (uniform noise in [-0.5, 0.5)
    from a ``torch.Generator`` before rounding).

Only tests call it (``tests/test_torch_compression.py`` holds it against
the reference); neither package's training loop compresses its
gradients.  Trees are the port's nested dicts of tensors.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_map


class ErrorFeedback(NamedTuple):
    residual: Any  # tree matching grads, float32


def init_error_feedback(grads) -> ErrorFeedback:
    return ErrorFeedback(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


def topk_compress(g: torch.Tensor, frac: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep the top-``frac`` fraction of entries; returns (values, mask),
    both float32 shaped like ``g``."""
    flat = g.reshape(-1).float()
    k = max(1, int(flat.numel() * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    mask = (flat.abs() >= thresh).float()
    return (flat * mask).reshape(g.shape), mask.reshape(g.shape)


def _split(tree, n: int):
    """A tree of n-tuples -> n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))


def compress_tree_topk(grads, ef: ErrorFeedback, frac: float = 0.05
                       ) -> Tuple[Any, ErrorFeedback]:
    """(kept tree, new error feedback): each leaf's top-k of gradient plus
    residual, and what it left out as the next residual."""
    def one(g, r):
        acc = g.float() + r
        kept, mask = topk_compress(acc, frac)
        return kept, acc * (1.0 - mask)
    kept, resid = _split(tree_map(one, grads, ef.residual), 2)
    return kept, ErrorFeedback(resid)


def quantize_int8(g: torch.Tensor,
                  key: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization: (q int8, scale float32
    scalar).  With ``key`` (a generator on ``g``'s device) uniform noise
    in [-0.5, 0.5) is added before rounding: stochastic rounding,
    unbiased in expectation."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    scaled = gf / scale
    if key is not None:
        scaled = scaled + (torch.rand(g.shape, generator=key,
                                      device=g.device) - 0.5)
    q = torch.clamp(torch.round(scaled), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree_int8(grads, ef: ErrorFeedback
                       ) -> Tuple[Any, Any, ErrorFeedback]:
    """Returns (q tree, scale tree, new error feedback); decode each leaf
    with ``dequantize_int8``."""
    def one(g, r):
        acc = g.float() + r
        q, s = quantize_int8(acc)
        return q, s, acc - dequantize_int8(q, s)
    qt, st, rt = _split(tree_map(one, grads, ef.residual), 3)
    return qt, st, ErrorFeedback(rt)
