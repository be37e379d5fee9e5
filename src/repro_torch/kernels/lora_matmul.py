"""Fused LoRA matmul: ``y = x @ W + s * (x @ A) @ B``, the contraction of
every adapter-bearing projection in the prefill, decode and training
paths (CoLLM's unified PEFT interface).

Replaces the TPU kernel ``repro.kernels.lora_matmul.lora_matmul``
(``src/repro/kernels/lora_matmul.py:57``, its ``pallas_call`` at ``:72``)
with a CUDA kernel written for Hopper, ``csrc/lora_matmul.cu``, built by
``kernels/_build.py`` and bound with ``ctypes``.  Both products are
summed in float32, ``x @ A`` is rounded to B's dtype once, and the
output is in x's dtype, as in the Pallas kernel.  What bounds it: bytes
at decode (M = 8: the 2 MB of W at qwen1.5-0.5b's width, 0.63 us at
3.35 TB/s), operations from M of a few hundred on (M = 3968: 8.6 GFLOP,
8.7 us at 989 TFLOP/s bf16).  Its design notes are in the source.

``lora_matmul`` dispatches on where its tensors lie: CPU tensors take the
plain PyTorch version ``lora_matmul_ref``; CUDA tensors launch the
kernel, or raise on a dtype, shape, rank or device it does not take.
Nothing falls back from one to the other.  ``lora_matmul.launches``
counts kernel launches.  Operands are taken with their strides, so
transposed views cost no copy (bf16: W, A and B all row-major or all
column-major, strides a multiple of 8 elements).

``LoRAMatmulFn`` is its gradient (the Pallas kernel has none; JAX trains
through autodiff of the jnp bypass).  With ``t = s * dY @ B^T``:
``dX = dY @ W^T + t @ A^T`` is the forward's form and runs the same
kernel on ``(dY, W^T, B^T, A^T)``; ``dA = x^T @ t`` and
``dB = s * (x @ A)^T @ dY`` are rank-r products left to ``torch.matmul``.
W is frozen and gets no gradient; dX is skipped when x needs none.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_RANK = 64
_I = ctypes.c_int
_L = ctypes.c_longlong
_P = ctypes.c_void_p


def lora_matmul_ref(x, w, a, b, scaling: float):
    """Plain PyTorch version, the Pallas kernel's arithmetic: both sums
    in float32 (float64 for float64 inputs), ``x @ A`` rounded to B's
    dtype, output in x's dtype."""
    acc_t = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc_t)
    acc = xf @ w.to(acc_t)
    xa = (xf @ a.to(acc_t)).to(b.dtype)
    low = xa.to(acc_t) @ b.to(acc_t)
    return (acc + scaling * low).to(x.dtype)


def _check(x, w, a, b) -> None:
    dev = x.device
    for name, t in (("w", w), ("a", a), ("b", b)):
        if t.device != dev:
            raise ValueError(f"lora_matmul: {name} is on {t.device}, x on "
                             f"{dev}")
    if dev.type != "cuda":
        raise ValueError(f"lora_matmul: no kernel for device {dev} (CPU "
                         "tensors take the plain version)")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"lora_matmul: dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    if any(t.dtype != x.dtype for t in (w, a, b)):
        raise TypeError("lora_matmul: x, w, a and b must share a dtype, got "
                        f"{x.dtype}, {w.dtype}, {a.dtype}, {b.dtype}")
    if x.dim() != 2 or w.dim() != 2 or a.dim() != 2 or b.dim() != 2:
        raise ValueError("lora_matmul: expected x [M,K], w [K,N], a [K,r], "
                         "b [r,N]")
    m, k = x.shape
    n = w.shape[1]
    r = a.shape[1]
    if w.shape[0] != k or a.shape[0] != k or tuple(b.shape) != (r, n):
        raise ValueError(
            f"lora_matmul: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)} do not agree")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"lora_matmul: rank {r} outside 1..{MAX_RANK}")
    if min(m, n, k) < 1 or max(m, n, k) >= 2 ** 31:
        raise ValueError(f"lora_matmul: M, N, K = {m}, {n}, {k} out of range")
    if any(s < 0 for t in (x, w, a, b) for s in t.stride()):
        raise ValueError("lora_matmul: negative strides are not supported")
    if x.dtype == torch.bfloat16:
        _check_bf16_layout(x, w, a, b)


def _check_bf16_layout(x, w, a, b) -> None:
    """The bf16 kernel stages 16-byte chunks along each operand's unit
    stride: x [M,K] row-major; W, A, B all row-major (the forward) or all
    column-major (the backward's transposed views); every other stride a
    multiple of 8 elements and every pointer 16-byte aligned."""
    if x.stride(1) != 1:
        raise ValueError("lora_matmul: bf16 x must have unit stride along K")
    if all(t.stride(1) == 1 for t in (w, a, b)):
        lds = [t.stride(0) for t in (x, w, a, b)]
    elif all(t.stride(0) == 1 for t in (w, a, b)):
        lds = [x.stride(0)] + [t.stride(1) for t in (w, a, b)]
    else:
        raise ValueError(
            "lora_matmul: bf16 w, a and b must all be row-major or all "
            f"column-major, got strides {w.stride()}, {a.stride()}, "
            f"{b.stride()}")
    if any(ld % 8 for ld in lds) or any(t.data_ptr() % 16
                                        for t in (x, w, a, b)):
        raise ValueError(
            f"lora_matmul: bf16 row strides {lds} must be multiples of 8 "
            "elements and the tensors 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, built and loaded on first use."""
    fn = _build.library("lora_matmul").lora_matmul_launch
    fn.restype = _I
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, ctypes.c_float, _P]
    return fn


def _launch(x, w, a, b, scaling: float):
    _check(x, w, a, b)
    fn = _entry()
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
                 a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, r,
                 *x.stride(), *w.stride(), *a.stride(), *b.stride(),
                 float(scaling), stream)
    if err != 0:
        raise RuntimeError(
            f"lora_matmul: launch failed with CUDA error {err} (x "
            f"{tuple(x.shape)}, w {tuple(w.shape)}, r {r}, {x.dtype})")
    lora_matmul.launches += 1
    return out


def lora_matmul(x, w, a, b, scaling: float):
    """x [M,K], w [K,N], a [K,r], b [r,N], one dtype -> [M,N] in x's
    dtype.  CPU tensors take ``lora_matmul_ref``; CUDA tensors launch the
    kernel (see the module docstring)."""
    if all(t.device.type == "cpu" for t in (x, w, a, b)):
        return lora_matmul_ref(x, w, a, b, scaling)
    return _launch(x, w, a, b, scaling)


lora_matmul.launches = 0


class LoRAMatmulFn(torch.autograd.Function):
    """``lora_matmul`` with its gradient in x, A and B (see the module
    docstring); W must not require a gradient."""

    @staticmethod
    def forward(ctx, x, w, a, b, scaling: float):
        if w.requires_grad:
            raise ValueError("LoRAMatmulFn: the base weight is frozen and "
                             "gets no gradient; pass it detached")
        ctx.save_for_backward(x, w, a, b)
        ctx.scaling = scaling
        return lora_matmul(x, w, a, b, scaling)

    @staticmethod
    def backward(ctx, dy):
        x, w, a, b = ctx.saved_tensors
        s = ctx.scaling
        dx = da = db = None
        if ctx.needs_input_grad[0]:
            dx = lora_matmul(dy.contiguous(), w.t(), b.t(), a.t(), s)
        if ctx.needs_input_grad[2]:
            t = (dy @ b.t()) * s
            da = x.t() @ t
        if ctx.needs_input_grad[3]:
            db = ((x @ a).t() @ dy) * s
        return dx, None, da, db, None

