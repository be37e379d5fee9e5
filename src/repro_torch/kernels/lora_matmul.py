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
3.35 TB/s), operations from M of a few hundred on (M = 3968: 8.3 GFLOP,
8.4 us at 989 TFLOP/s bf16).  Its design notes are in the source.
In bf16, M <= 16 (decode) takes a path of its own: K split across
blocks by ``decode_split_plan``, f32 partials summed in split order by
the last block of each tile, with a workspace and ticket counters kept
per (device, stream) by ``kernels/_scratch.py`` (no allocation or memset
per call).  Above it a persistent wgmma kernel fed by TMA walks the
output tiles of ``mma_tile_plan`` with the low-rank product in its
epilogue.

``lora_matmul`` dispatches on where its tensors lie: CPU tensors take the
plain PyTorch version ``lora_matmul_ref``; CUDA tensors launch the
kernel, or raise on a dtype, shape, rank or device it does not take.
Nothing falls back from one to the other.  ``lora_matmul.launches``
counts kernel launches.  Operands are taken with their strides, so
transposed views cost no copy (bf16: W, A and B all row-major or all
column-major, strides a multiple of 8 elements).  A bf16 operand whose
row stride is no multiple of 8 (hymba-1.5b's ``ssm_in``, N = 6,482 =
8 x 810 + 2: its B, and dY in the dX backward) is copied by the wrapper
into storage padded to one (``pad_columns``), in its own layout; the
kernels read each row's valid elements (the rest of a 16-byte chunk and
of a TMA box load as zeros) and write the output row by row.  So any
tensor of the reference's shape is taken; the model keeps its large W
in padded storage (``mamba2.pad_storage``) only so that no call copies
it.

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
from typing import Tuple

import torch

from repro_torch.kernels import _build, _scratch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_RANK = 64
_I = ctypes.c_int
_L = ctypes.c_longlong
_P = ctypes.c_void_p

# the bf16 decode path (M <= 16, csrc/lora_mma.cuh::dec_body): 64-column
# tiles of W, K split across blocks on 16-row MMA steps, about
# DECODE_BLOCKS_PER_SM blocks per SM, at least DECODE_MIN_ROWS rows of K
# a split, at most DECODE_MAX_SPLITS splits
DECODE_MAX_M = 16
DECODE_BN = 64
DECODE_STEP = 16
DECODE_MIN_ROWS = 64
DECODE_MAX_SPLITS = 32
DECODE_BLOCKS_PER_SM = 2
# the bf16 path above it (csrc/lora_mma.cuh::wg_body): output tiles of
# MMA_BM rows by one of MMA_WIDTHS columns, walked by a persistent grid in
# groups of MMA_GROUP_M tiles of M.  A 64-row K step of a tile BN wide
# costs the card about BN + MMA_STEP_COST columns' worth of shared-memory
# traffic (TMA writes of x, W and A; wgmma reads of x twice, for x @ W
# and x @ A, and of W): the x side is a fixed cost per tile, which makes
# wide tiles cheaper per column.
MMA_BM = 128
MMA_WIDTHS = (256, 192, 128, 64)
MMA_STEP_COST = 144
MMA_GROUP_M = 8


def _cdiv(a: int, c: int) -> int:
    return -(-a // c)


ROW_ALIGN = 8            # bf16 row strides: whole 16-byte chunks


def pad_columns(t: torch.Tensor) -> torch.Tensor:
    """``t`` (any rank >= 2) as a view of zero-padded storage with unit
    stride along its last axis and a row stride that is a multiple of
    ``ROW_ALIGN`` elements; ``t`` itself when it already is so."""
    n = t.shape[-1]
    if t.dim() < 2 or (t.stride(-1) == 1 and t.stride(-2) >= n
                       and t.stride(-2) % ROW_ALIGN == 0):
        return t
    return torch.nn.functional.pad(t, (0, -n % ROW_ALIGN))[..., :n]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """A 2-D bf16 operand as the kernels take it: ``t`` itself, or, where
    its row stride (its column stride, column-major) is no multiple of
    ``ROW_ALIGN``, a copy in padded storage of the same layout.  Any
    other layout passes through to ``_check``, which refuses it."""
    if t.dim() == 2 and t.stride(1) == 1:
        return pad_columns(t)
    if t.dim() == 2 and t.stride(0) == 1:
        return pad_columns(t.t()).t()
    return t


@functools.lru_cache(maxsize=None)
def mma_tile_plan(m: int, k: int, n: int, n_sm: int) -> Tuple[int, int, int]:
    """(tile_n, blocks, group) of the bf16 path at M > 16: the tile
    width of MMA_WIDTHS that minimises rounds x (width + MMA_STEP_COST),
    rounds being the tiles each SM walks at most (the widest on a tie);
    one persistent block per SM at most, walking the tiles in groups of
    ``MMA_GROUP_M`` M tiles (``mma_tile``).  Every tile runs the same K
    steps, so K does not move the choice.  A function of M, K and N
    alone, never of the slots, so ``lora_matmul`` and
    ``segmented_lora_matmul`` sum every row in the same order.  The
    widths it picks at the port's shapes were the fastest of the four in
    ``chip_smoke.py`` bring-up sweeps (NVIDIA H100 80GB HBM3, 700 W)."""
    del k
    tiles_m = _cdiv(m, MMA_BM)

    def cost(bn: int) -> int:
        return _cdiv(tiles_m * _cdiv(n, bn), n_sm) * (bn + MMA_STEP_COST)

    bn = min(MMA_WIDTHS, key=cost)
    return bn, min(tiles_m * _cdiv(n, bn), n_sm), MMA_GROUP_M


def mma_tile(t: int, m: int, n: int, bn: int,
             group: int) -> Tuple[int, int]:
    """(M tile, N tile) of the ``t``-th output tile of the walk, as
    ``csrc/lora_mma.cuh::tile_mn`` computes it: the M tiles in groups of
    ``group``, inside a group every N tile of the group's rows, one M
    tile after another; block b of G takes tiles b, b + G, ..."""
    tiles_m, tiles_n = _cdiv(m, MMA_BM), _cdiv(n, bn)
    per = group * tiles_n
    first = (t // per) * group
    size = min(group, tiles_m - first)
    j = t % per
    return first + j % size, j // size


@functools.lru_cache(maxsize=None)
def decode_split_plan(k: int, n: int, n_sm: int) -> Tuple[int, int]:
    """(splits, rows of K per split) of the bf16 decode path: balanced
    splits of whole 16-row steps, as many as give the card
    ``DECODE_BLOCKS_PER_SM`` blocks of (64-column tile, split) per SM
    (rounded down to a balanced split), but none shorter than
    ``DECODE_MIN_ROWS`` rows and at most ``DECODE_MAX_SPLITS``.  A
    function of K and N alone, so ``lora_matmul`` and
    ``segmented_lora_matmul`` sum every row in the same order, whatever
    the slots.  ``chip_smoke.py splits`` times 4 to 32 splits at every
    decode shape of the port (NVIDIA H100 80GB HBM3, 700 W; PERF.md):
    two blocks per SM are fastest or within 10% of it, and short splits
    cost more in the last block's reduction than their bytes save
    (qwen1.5-0.5b's q/k/v/o, K = 1,024: 8 splits 11.7 us, 16 12.8, 32
    17.9).  The floor is 64 rows, not 128, because the slots share the
    plan: at 8 splits four slots took 20.0 us and eight 35.7, at 16
    splits 15.5 and 21.6."""
    tiles, steps = _cdiv(n, DECODE_BN), _cdiv(k, DECODE_STEP)
    want = max(1, min(steps * DECODE_STEP // DECODE_MIN_ROWS,
                      DECODE_MAX_SPLITS,
                      _cdiv(DECODE_BLOCKS_PER_SM * n_sm, tiles)))
    per = _cdiv(steps, want)
    return _cdiv(steps, per), per * DECODE_STEP


@functools.lru_cache(maxsize=None)
def decode_workspace(k: int, n: int, r: int, na: int,
                     n_sm: int) -> Tuple[int, int, int, int]:
    """(splits, chunk, f32 workspace floats, tickets) of one bf16 decode
    call with ``na`` adapter slots of rank ``r``: a record per (tile,
    split) of x @ W [64, 16] and each slot's x @ A [rp, 16] (rp = 16 for
    r <= 16, else 64, as the kernel pads r), and a ticket per tile."""
    splits, chunk = decode_split_plan(k, n, n_sm)
    tiles = _cdiv(n, DECODE_BN)
    rp = 16 if r <= 16 else 64
    record = DECODE_BN * 16 + na * rp * 16
    return splits, chunk, tiles * splits * record, tiles


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
    """The bf16 kernels load 16-byte chunks (TMA boxes at M > 16) along
    each operand's unit stride: x [M,K] row-major; W, A, B all row-major
    (the forward) or all column-major (the backward's transposed views);
    every other stride a multiple of 8 elements and every pointer 16-byte
    aligned."""
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
                   _L, _L, _L, _L, _L, _L, _L, _L, ctypes.c_float,
                   _I, _I, _P, _P, _I, _I, _I, _P]
    return fn


def _plan_args(x, stream: int, k: int, n: int, r: int, na: int):
    """(splits, chunk, workspace pointer, tickets pointer, tile_n, blocks,
    group) for the C entry: in bf16 the decode path's split and scratch
    (M <= 16) or the tile plan (M > 16), zeros elsewhere."""
    m = x.shape[0]
    if x.dtype != torch.bfloat16:
        return 0, 0, None, None, 0, 0, 0
    n_sm = _scratch.sm_count(x.device.index or 0)
    if m > DECODE_MAX_M:
        return (0, 0, None, None, *mma_tile_plan(m, k, n, n_sm))
    splits, chunk, n_ws, n_tk = decode_workspace(k, n, r, na, n_sm)
    ws, tickets = _scratch.buffers(x.device, stream, n_ws, n_tk)
    return splits, chunk, ws.data_ptr(), tickets.data_ptr(), 0, 0, 0


def _launch(x, w, a, b, scaling: float):
    if x.dtype == torch.bfloat16:
        x, w, a, b = (_aligned(t) for t in (x, w, a, b))
    _check(x, w, a, b)
    fn = _entry()
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = _scratch.stream(x.device)
        err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
                 a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, r,
                 *x.stride(), *w.stride(), *a.stride(), *b.stride(),
                 float(scaling), *_plan_args(x, stream, k, n, r, 1),
                 stream)
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
        _check_seg_bf16_layout(x, w, a, b)


def _check_seg_bf16_layout(x, w, a, b) -> None:
    """The bf16 kernels load 16-byte chunks (TMA boxes at M > 16) along
    each operand's last axis: unit stride there, every other stride a
    multiple of 8 elements, every pointer 16-byte aligned."""
    units = (x.stride(1), w.stride(1), a.stride(2), b.stride(2))
    lds = (x.stride(0), w.stride(0), *a.stride()[:2], *b.stride()[:2])
    if units != (1, 1, 1, 1) or any(ld % 8 for ld in lds) \
            or any(t.data_ptr() % 16 for t in (x, w, a, b)):
        raise ValueError(
            "segmented_lora_matmul: bf16 operands need unit stride along "
            "their last axis, other strides multiples of 8 elements and "
            f"16-byte alignment; got unit strides {units}, others {lds}")


@functools.lru_cache(maxsize=None)
def _seg_entry():
    """The C entry point of the multi-tenant kernel."""
    fn = _build.library("segmented_lora_matmul").segmented_lora_matmul_launch
    fn.restype = _I
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, ctypes.c_float,
                   _I, _I, _P, _P, _I, _I, _I, _P]
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
        stream = _scratch.stream(x.device)
        err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
                 a_stack.data_ptr(), b_stack.data_ptr(),
                 adapter_idx.data_ptr(), out.data_ptr(), m, n, k, r, na,
                 *x.stride(), *w.stride(), *a_stack.stride(),
                 *b_stack.stride(), float(scaling),
                 *_plan_args(x, stream, k, n, r, na), stream)
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

