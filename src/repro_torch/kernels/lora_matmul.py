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

``segmented_lora_matmul`` is the multi-tenant form: each row of x takes
its own adapter slot from stacked ``A [NA,K,r]`` / ``B [NA,r,N]``
(``adapter_idx`` [M] int32, < 0 for the base product alone).  It
replaces the TPU kernel ``repro.kernels.lora_matmul.
segmented_lora_matmul`` (``src/repro/kernels/lora_matmul.py:132``, its
``pallas_call`` at ``:170``) with ``csrc/segmented_lora_matmul.cu``,
which runs ``csrc/lora_mma.cuh``'s kernels, lora_matmul's, over the
slots: with r a multiple of 16 a bf16 row is bitwise what
``lora_matmul`` gives with its slot's A and B at the same M.  Bound by
bytes at decode (M = 8, K = N = 1024, 4 slots of r = 16: W's 2 MB and
the stacks' 256 KB, 0.7 us at 3.35 TB/s), by operations above a few
hundred rows.  Same dispatch and counter (``segmented_lora_matmul.
launches``); no gradient (training steps one adapter through
``lora_matmul``).
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


def _check_operands(op: str, x, named) -> None:
    """x and the ``(name, tensor)`` pairs on one CUDA device, in one
    dtype the kernel takes."""
    dev = x.device
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{op}: {name} is on {t.device}, x on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{op}: no kernel for device {dev} (CPU tensors "
                         "take the plain version)")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{op}: dtype {x.dtype} not supported (float32, "
                        "bfloat16)")
    if any(t.dtype != x.dtype for _, t in named):
        raise TypeError(f"{op}: operands must share x's dtype {x.dtype}, "
                        f"got {[(n, t.dtype) for n, t in named]}")


def _check(x, w, a, b) -> None:
    _check_operands("lora_matmul", x, (("w", w), ("a", a), ("b", b)))
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


# ------------------------------------------------------------ multi-tenant -
def segmented_lora_matmul_ref(x, w, a_stack, b_stack, adapter_idx,
                              scaling: float):
    """Plain PyTorch version, the oracle's semantics with the Pallas
    kernel's rounding: the base product is one float32 ``x @ W`` (as in
    ``lora_matmul_ref``); every slot's ``x @ A[s]`` is rounded to B's
    dtype and multiplied by ``B[s]``, and each row then keeps its own
    slot's product (``adapter_idx`` clamped to the last slot).  The
    select comes after the products, so a row with ``adapter_idx < 0``
    is the base product bitwise even when the stacks hold NaN."""
    acc_t = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc_t)
    base = xf @ w.to(acc_t)
    idx = adapter_idx.long()
    sel = idx.clamp(0, a_stack.shape[0] - 1)
    xa = (xf @ a_stack.to(acc_t)).to(b_stack.dtype)        # [NA, M, r]
    low = xa.to(acc_t) @ b_stack.to(acc_t)                  # [NA, M, N]
    low = low[sel, torch.arange(x.shape[0], device=x.device)]
    y = torch.where((idx >= 0)[:, None], base + scaling * low, base)
    return y.to(x.dtype)


def _check_seg(x, w, a, b, idx) -> None:
    op = "segmented_lora_matmul"
    _check_operands(op, x, (("w", w), ("a_stack", a), ("b_stack", b)))
    if idx.device != x.device:
        raise ValueError(f"{op}: adapter_idx is on {idx.device}, x on "
                         f"{x.device}")
    if x.dim() != 2 or w.dim() != 2 or a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"{op}: expected x [M,K], w [K,N], a_stack "
                         "[NA,K,r], b_stack [NA,r,N]")
    m, k = x.shape
    n = w.shape[1]
    na, r = a.shape[0], a.shape[2]
    if w.shape[0] != k or tuple(a.shape[:2]) != (na, k) \
            or tuple(b.shape) != (na, r, n):
        raise ValueError(
            f"{op}: shapes x {tuple(x.shape)}, w {tuple(w.shape)}, a_stack "
            f"{tuple(a.shape)}, b_stack {tuple(b.shape)} do not agree")
    if idx.dtype != torch.int32 or tuple(idx.shape) != (m,) \
            or idx.stride(0) != 1:
        raise ValueError(f"{op}: adapter_idx must be a contiguous int32 "
                         f"[{m}], got {idx.dtype} {tuple(idx.shape)}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"{op}: rank {r} outside 1..{MAX_RANK}")
    if na * (16 if r <= 16 else 64) > 128:
        raise ValueError(f"{op}: {na} slots of rank {r} exceed the kernel's "
                         "128 low-rank columns (8 slots at r <= 16, 2 at "
                         "r <= 64)")
    if min(m, n, k) < 1 or max(m, n, k) >= 2 ** 31:
        raise ValueError(f"{op}: M, N, K = {m}, {n}, {k} out of range")
    if any(s < 0 for t in (x, w, a, b) for s in t.stride()):
        raise ValueError(f"{op}: negative strides are not supported")
    if x.dtype == torch.bfloat16:
        units = (x.stride(1), w.stride(1), a.stride(2), b.stride(2))
        lds = (x.stride(0), w.stride(0), *a.stride()[:2], *b.stride()[:2])
        if units != (1, 1, 1, 1) or any(ld % 8 for ld in lds) \
                or any(t.data_ptr() % 16 for t in (x, w, a, b)):
            raise ValueError(
                f"{op}: bf16 operands need unit stride along their last "
                "axis, other strides multiples of 8 elements and 16-byte "
                f"alignment; got unit strides {units}, others {lds}")


@functools.lru_cache(maxsize=None)
def _seg_entry():
    """The C entry point of the multi-tenant kernel."""
    fn = _build.library("segmented_lora_matmul").segmented_lora_matmul_launch
    fn.restype = _I
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, ctypes.c_float, _P]
    return fn


def segmented_lora_matmul(x, w, a_stack, b_stack, adapter_idx,
                          scaling: float):
    """x [M,K], w [K,N], a_stack [NA,K,r], b_stack [NA,r,N] in one dtype,
    adapter_idx [M] int32 -> [M,N] in x's dtype.  CPU tensors take
    ``segmented_lora_matmul_ref``; CUDA tensors launch the kernel or
    raise (see the module docstring)."""
    if all(t.device.type == "cpu"
           for t in (x, w, a_stack, b_stack, adapter_idx)):
        return segmented_lora_matmul_ref(x, w, a_stack, b_stack,
                                         adapter_idx, scaling)
    _check_seg(x, w, a_stack, b_stack, adapter_idx)
    fn = _seg_entry()
    m, k = x.shape
    n = w.shape[1]
    na, r = a_stack.shape[0], a_stack.shape[2]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
                 a_stack.data_ptr(), b_stack.data_ptr(),
                 adapter_idx.data_ptr(), out.data_ptr(), m, n, k, r, na,
                 *x.stride(), *w.stride(), *a_stack.stride(),
                 *b_stack.stride(), float(scaling), stream)
    if err != 0:
        raise RuntimeError(
            f"segmented_lora_matmul: launch failed with CUDA error {err} "
            f"(x {tuple(x.shape)}, w {tuple(w.shape)}, {na} slots of rank "
            f"{r}, {x.dtype})")
    segmented_lora_matmul.launches += 1
    return out


segmented_lora_matmul.launches = 0


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

