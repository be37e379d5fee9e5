"""Flash attention: causal or windowed GQA softmax attention over a whole
sequence with an online softmax, forward and backward — the prefill and
training attention of every sequence longer than the dense path takes
(``s*s > 1M``, ``models/transformer.py::use_dense_prefill``).

Replaces the TPU kernel ``repro.kernels.flash_attention.flash_attention``
(``src/repro/kernels/flash_attention.py:86``, its ``pallas_call`` at
``:110``) with CUDA kernels written for Hopper,
``csrc/flash_attention.cu``, built by ``kernels/_build.py`` and bound
with ``ctypes``.  The Pallas kernel is forward only; JAX trains through
autodiff of the ``lax.scan`` in ``models/layers.py::attention_blockwise``
(``src/repro/models/layers.py:105``).  The port's gradient is a kernel
too: ``FlashAttentionFn``.

What it computes, per query row: softmax(q k^T * scale) over the allowed
keys, times v.  Allowed: ``kpos < Skv``; with ``causal``
``kpos <= qpos``; with ``window > 0`` ``qpos - kpos < window``.  Head h
reads KV head ``h // (H / Hkv)`` through the index (no repeated copy).
A fully masked row gives zeros.  Numerics of the Pallas kernel: q k^T
with operands in the input dtype and float32 accumulation, the online
max and sum in float32, p rounded to v's dtype for the PV product, the
output in q's dtype.  What bounds it: operations (at 2,048 tokens and
head_dim 64 a causal head is ~34 flop per byte of q/k/v/o).

Layout: the public functions take the JAX layout ``q [B, H, Sq, D]``,
``k, v [B, Hkv, Skv, D]``, but with any strides whose head-dim stride is
1, so the model's ``[B, S, H, D]`` tensors go in as transposed views
without a copy.  Outputs (o, dq, dk, dv) are allocated ``[B, S, H, D]``
in memory and returned as ``[B, H, S, D]`` views, so the model reads
them back in its own layout without a copy either.

Dispatch: the public entry is ``FlashAttentionFn`` (forward and
gradient).  CPU tensors take the plain PyTorch versions
(``flash_attention_ref`` and, for the gradient, autograd of it in
``flash_attention_grad_ref``); CUDA tensors launch the kernels
(``flash_attention_fwd``, ``flash_attention_backward``), which raise on
a dtype (float32, bfloat16), head_dim (64, 128), layout or device they
do not take.  Nothing falls back.  ``flash_attention_fwd.launches``
counts forward launches (one per call), ``flash_attention_backward.
launches`` backward launches: three per backward.  In bfloat16 (wgmma
and TMA, ``csrc/flash_attention.cu``): a prep kernel (``delta =
rowsum(dO * O)``, lse in log2 units, the float32 dQ accumulator zeroed),
the single pass that forms dK, dV and adds dQ into the accumulator, and
dQ's rounding into the model layout.  In float32: delta, then dK/dV,
then dQ.  The bfloat16 dQ sums its key tiles with atomic adds, so it
differs from run to run at float32 rounding; dK and dV do not.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)
_I = ctypes.c_int
_L = ctypes.c_longlong
_P = ctypes.c_void_p


# ------------------------------------------------------ plain versions ----
def _mask(sq: int, skv: int, causal: bool, window: int, device):
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return mask


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None):
    """Plain PyTorch version (``repro.kernels.ref.flash_attention``):
    dense float32 softmax, fully masked rows zeroed.  q [B,H,Sq,D];
    k, v [B,Hkv,Skv,D] -> [B,H,Sq,D] in q's dtype."""
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    s = s.masked_fill(~_mask(sq, skv, causal, window, q.device),
                      float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, h, sq, d).to(q.dtype)


def flash_attention_grad_ref(q, k, v, do, *, causal: bool = True,
                             window: int = 0, scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, ...]:
    """The backward's plain version: (dq, dk, dv) by autograd of
    ``flash_attention_ref``, each in its input's dtype."""
    with torch.enable_grad():
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = flash_attention_ref(qr, kr, vr, causal=causal, window=window,
                                scale=scale)
        return torch.autograd.grad(o, (qr, kr, vr), do)


# ------------------------------------------------------------ checks ------
def _check(q, k, v, extra=()) -> None:
    dev = q.device
    for name, t in (("k", k), ("v", v)) + tuple(extra):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev} "
                         "(CPU tensors take the plain version)")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        "(float32, bfloat16)")
    tensors = (("k", k), ("v", v)) + tuple(extra)
    if any(t.dtype != q.dtype for n, t in tensors if n != "lse"):
        raise TypeError("flash_attention: q, k, v (and o, dO) must share "
                        "a dtype")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: expected q [B,H,Sq,D], k and v "
                         "[B,Hkv,Skv,D]")
    b, h, sq, d = q.shape
    _, hkv, skv, dk = k.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != b or dk != d \
            or hkv < 1 or h % hkv:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "agree")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not supported "
                         f"{HEAD_DIMS}")
    if min(b, sq, skv) < 1 or max(b * h * sq, b * hkv * skv) >= 2 ** 31:
        raise ValueError(f"flash_attention: B, Sq, Skv = {b}, {sq}, {skv} "
                         "out of range")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(
            (n, t) for n, t in extra if n != "lse"):
        if t.stride(3) != 1 or any(s < 0 for s in t.stride()):
            raise ValueError(f"flash_attention: {name} needs unit stride "
                             "along head_dim and no negative strides")
        if q.dtype == torch.bfloat16 and (
                any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16):
            raise ValueError(
                f"flash_attention: bf16 {name} strides {t.stride()} must be "
                "multiples of 8 elements and the tensor 16-byte aligned")


def _bhs(t):
    """(batch, head, sequence) element strides of a [B, H, S, D] view."""
    return t.stride(0), t.stride(1), t.stride(2)


def _alloc_like_model(b, h, s, d, dtype, device):
    """A [B, H, S, D] view of a fresh [B, S, H, D] tensor."""
    return torch.empty((b, s, h, d), dtype=dtype,
                       device=device).transpose(1, 2)


@functools.lru_cache(maxsize=None)
def _entries():
    """The C entry points, built and loaded on first use."""
    lib = _build.library("flash_attention")
    dims = [_I] * 6                     # B, H, Hkv, Sq, Skv, D
    mask = [_I, _I, ctypes.c_float]     # causal, window, scale
    fwd = lib.flash_attention_fwd_launch
    fwd.argtypes = [_I, _P, _P, _P, _P, _P] + dims + [_L] * 12 + mask + [_P]
    delta = lib.flash_attention_bwd_delta_launch
    delta.argtypes = [_I, _P, _P, _P] + [_I] * 4 + [_L] * 6 + [_P]
    dkdv = lib.flash_attention_bwd_dkdv_launch
    dkdv.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P] + dims \
        + [_L] * 18 + mask + [_P]
    dq = lib.flash_attention_bwd_dq_launch
    dq.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P] + dims + [_L] * 15 \
        + mask + [_P]
    prep = lib.flash_attention_bwd_bf16_prep_launch
    prep.argtypes = [_P] * 6 + [_I] * 5 + [_L] * 6 + [_P]
    single = lib.flash_attention_bwd_bf16_launch
    single.argtypes = [_P] * 9 + dims + [_I] + [_L] * 18 + mask \
        + [_I, _P, _I, _P]
    finish = lib.flash_attention_bwd_bf16_finish_launch
    finish.argtypes = [_P] * 5 + dims + [_I] * 3 + [_L] * 9 \
        + [ctypes.c_float, _P]
    for fn in (fwd, delta, dkdv, dq, prep, single, finish):
        fn.restype = _I
    return fwd, delta, dkdv, dq, prep, single, finish


def _raise_on(err: int, what: str, q, k) -> None:
    if err != 0:
        raise RuntimeError(
            f"flash_attention: {what} launch failed with CUDA error {err} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _n_sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def backward_split(b: int, hkv: int, group: int, skv: int,
                   n_sms: int) -> int:
    """How many blocks share each (128-key tile, KV head, batch) of the
    bfloat16 backward, each taking an equal slice of the group's
    ``group`` query heads: doubled while it divides the group and the
    grid is smaller than the card (``n_sms`` SMs).  A causal grid of one
    wave runs as long as its longest block, the first KV tile's, which
    walks every query tile of every head of its group; slices above 1
    add f32 partial dK and dV that the last launch sums."""
    split, blocks = 1, -(-skv // 128) * hkv * b
    while group % (2 * split) == 0 and blocks * split < n_sms:
        split *= 2
    return split


# ----------------------------------------------------------- forward ------
def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None):
    """The forward kernel: (o [B,H,Sq,D] in q's dtype, lse [B,H,Sq]
    float32, the natural-log sum of exp of each row's scaled scores)."""
    _check(q, k, v)
    fwd = _entries()[0]
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    o = _alloc_like_model(b, h, sq, d, q.dtype, q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fwd(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, hkv, sq,
                  skv, d, *_bhs(q), *_bhs(k), *_bhs(v), *_bhs(o),
                  int(causal), int(window), float(scale), _stream(q))
    _raise_on(err, "forward", q, k)
    flash_attention_fwd.launches += 1
    return o, lse


flash_attention_fwd.launches = 0


# ---------------------------------------------------------- backward ------
def flash_attention_backward(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, scale: Optional[float] = None):
    """The backward kernels: (dq, dk, dv) like q, k, v.  Three launches.
    bfloat16: the prep (delta, lse in log2 units and a zeroed float32 dQ
    accumulator, rows padded to 128), then one block per (128-key tile,
    KV head, batch) that walks the query tiles of the group's heads,
    recomputes P once from ``lse`` and forms dK, dV and its adds into
    dQ, then dQ rounded into place.  float32: delta = rowsum(dO * O);
    one block per (batch, KV head, KV tile) for dK and dV; one block per
    (batch, head, query tile) for dQ, both recomputing P."""
    _check(q, k, v, (("o", o), ("do", do), ("lse", lse)))
    if lse.dtype != torch.float32 or not lse.is_contiguous() \
            or tuple(lse.shape) != tuple(q.shape[:3]) \
            or tuple(o.shape) != tuple(q.shape) \
            or tuple(do.shape) != tuple(q.shape):
        raise ValueError("flash_attention_backward: o and dO must be "
                         "shaped like q, lse a contiguous float32 "
                         "[B,H,Sq]")
    _, delta_fn, dkdv_fn, dq_fn, prep_fn, single_fn, finish_fn = _entries()
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    code = _DTYPE_CODE[q.dtype]
    dq = _alloc_like_model(b, h, sq, d, q.dtype, q.device)
    dk = _alloc_like_model(b, hkv, skv, d, k.dtype, k.device)
    dv = _alloc_like_model(b, hkv, skv, d, v.dtype, v.device)
    mask = (int(causal), int(window), float(scale))
    dims = (b, h, hkv, sq, skv, d)
    if q.dtype == torch.bfloat16:
        sqp, skvp = -(-sq // 128) * 128, -(-skv // 128) * 128
        split = backward_split(b, hkv, h // hkv, skv, _n_sms(q.device))
        lse2 = torch.empty((b, h, sqp), dtype=torch.float32, device=q.device)
        delta = torch.empty_like(lse2)
        acc = torch.empty((b * h * sqp * d,), dtype=torch.float32,
                          device=q.device)
        part = torch.empty((2 * split * b * hkv * skvp * d,),
                           dtype=torch.float32, device=q.device) \
            if split > 1 else None
        with torch.cuda.device(q.device):
            stream = _stream(q)
            err = prep_fn(o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                          lse2.data_ptr(), delta.data_ptr(), acc.data_ptr(),
                          b, h, sq, d, sqp, *_bhs(o), *_bhs(do), stream)
            _raise_on(err, "backward prep", q, k)
            flash_attention_backward.launches += 1
            err = single_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
                            acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                            *dims, sqp, *_bhs(q), *_bhs(k), *_bhs(v),
                            *_bhs(do), *_bhs(dk), *_bhs(dv), *mask, split,
                            part.data_ptr() if split > 1 else None, skvp,
                            stream)
            _raise_on(err, "backward", q, k)
            flash_attention_backward.launches += 1
            err = finish_fn(acc.data_ptr(), dq.data_ptr(),
                            part.data_ptr() if split > 1 else None,
                            dk.data_ptr(), dv.data_ptr(), *dims, sqp, split,
                            skvp, *_bhs(dq), *_bhs(dk), *_bhs(dv),
                            float(scale), stream)
            _raise_on(err, "backward finish", q, k)
            flash_attention_backward.launches += 1
        return dq, dk, dv
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = _stream(q)
        err = delta_fn(code, o.data_ptr(), do.data_ptr(), delta.data_ptr(),
                       b, h, sq, d, *_bhs(o), *_bhs(do), stream)
        _raise_on(err, "backward delta", q, k)
        flash_attention_backward.launches += 1
        err = dkdv_fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), *dims, *_bhs(q),
                      *_bhs(k), *_bhs(v), *_bhs(do), *_bhs(dk), *_bhs(dv),
                      *mask, stream)
        _raise_on(err, "backward dK/dV", q, k)
        flash_attention_backward.launches += 1
        err = dq_fn(code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                    dq.data_ptr(), *dims, *_bhs(q), *_bhs(k), *_bhs(v),
                    *_bhs(do), *_bhs(dq), *mask, stream)
        _raise_on(err, "backward dQ", q, k)
        flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its gradient in q, k and v: q [B,H,Sq,D];
    k, v [B,Hkv,Skv,D] -> [B,H,Sq,D].  CUDA tensors run the forward
    kernel and the three backward launches; CPU tensors run
    ``flash_attention_ref`` and autograd of it."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int,
                scale: Optional[float]):
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        if all(t.device.type == "cpu" for t in (q, k, v)):
            ctx.save_for_backward(q, k, v)
            return flash_attention_ref(q, k, v, causal=causal,
                                       window=window, scale=scale)
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        kw = dict(causal=ctx.causal, window=ctx.window, scale=ctx.scale)
        saved = ctx.saved_tensors
        if len(saved) == 3:
            grads = flash_attention_grad_ref(*saved, do, **kw)
        else:
            q, k, v, o, lse = saved
            if do.stride(3) != 1 or (q.dtype == torch.bfloat16 and any(
                    s % 8 for s in do.stride()[:3])):
                do = do.contiguous()
            grads = flash_attention_backward(q, k, v, o, lse, do, **kw)
        return (*grads, None, None, None)
