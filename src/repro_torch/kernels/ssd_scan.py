"""Mamba2 SSD chunked scan: the prefill of every state-space layer
(``models/mamba2.py::ssd_chunked``).

Replaces the TPU kernel ``repro.kernels.ssd_scan.ssd_scan``
(``src/repro/kernels/ssd_scan.py:78``, its ``pallas_call`` at ``:94``)
with a CUDA kernel written for Hopper, ``csrc/ssd_scan.cu``, built by
``kernels/_build.py`` and bound with ``ctypes``.  It computes what
``repro.models.mamba2.ssd_chunked`` computes: per chunk, the
decay-masked quadratic form plus the carried state's contribution,
then the state update; everything in float32, ``y`` in x's dtype, the
final state in float32.  The kernel walks its own 64-position chunks
(a 256 x 256 float32 score tile would not fit a block's shared memory);
the recurrence is the same for any chunk length, so ``chunk`` reaches
only the plain version.  What bounds it: float32 operations (at 2,048
tokens, 48 heads of P = 64, N = 128: about 4.9 GFLOP counting the causal
half of each 256-wide chunk and C B^T once per chunk, as the heads share
the single B/C group; 0.073 ms at 67 TFLOP/s).

A call is two launches (``LAUNCHES``): a prep pass forms C B^T once per
(batch, chunk), then one block per (batch, chunk, head) forms its
chunk's own state and output and takes the state entering its chunk
from the block of the previous chunk through scratch in L2
(``kernel_plan``, ``scratch_sizes``; the design notes are in the
source).  The workspace and the self-resetting counters are the
(device, stream) scratch of ``kernels/_scratch.py``.

Layout, as ``ssd_chunked`` takes it: ``x [B, S, H, P]`` (any strides
with unit stride along P, so the mixer's view of its ``in_proj`` output
goes in without a copy), ``dt [B, S, H]``, ``a [H]``, ``bmat``/``cmat``
``[B, S, N]`` (unit stride along N), ``init_state [B, H, P, N]`` (unit
stride along N) or None for zeros.  Returns ``(y [B, S, H, P],
final_state [B, H, P, N])``.

Dispatch: CPU tensors take the plain PyTorch version ``ssd_scan_ref``;
CUDA tensors launch the kernel, or raise on a dtype, rank, shape, stride
or device it does not take, and raise ``NotImplementedError`` when an
input requires grad (the kernel has no backward yet).  Nothing falls
back.  ``ssd_scan.launches`` counts kernel launches, ``LAUNCHES`` a call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, _scratch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 128          # N: padded to 64 or 128 state columns
MAX_ROWS = 64            # P: rows of the state (one block's worth)
_I = ctypes.c_int
_L = ctypes.c_longlong
_P = ctypes.c_void_p
_BACKWARD = ("ssd_scan has no backward on the card yet; see ROADMAP.md, "
             "'Other families' (SSM co-training: the ssd_scan backward)")


def ssd_scan_ref(x, dt, a, bmat, cmat, *, chunk: int = 256,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``repro.models.mamba2.ssd_chunked`` op for
    op (float32 throughout, ``L`` selected with ``where`` so exp of the
    masked positive differences never reaches the sum)."""
    bt, s, h, p = x.shape
    n = bmat.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    q = chunk
    xc = x.reshape(bt, nc, q, h, p).float()
    dtc = dt.reshape(bt, nc, q, h).float()
    bc = bmat.reshape(bt, nc, q, n).float()
    cc = cmat.reshape(bt, nc, q, n).float()

    da = dtc * a.float()[None, None, None, :]          # [Bt,nc,q,H] (<0)
    cum = torch.cumsum(da, dim=2)                      # within-chunk
    seg_total = cum[:, :, -1, :]                       # [Bt,nc,H]

    # intra-chunk (quadratic, attention-like) term
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [Bt,nc,q,q,H]
    ii = torch.arange(q, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    lmat = torch.where(causal, torch.exp(diff), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)           # [Bt,nc,q,q]
    scores = cb[..., None] * lmat * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xc)

    # chunk-final states
    decay_to_end = torch.exp(seg_total[:, :, None, :] - cum)
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_to_end * dtc, bc,
                          xc)                               # [Bt,nc,H,P,N]

    # inter-chunk scan: the state entering each chunk
    prev = torch.zeros((bt, h, p, n), dtype=torch.float32,
                       device=x.device) if init_state is None \
        else init_state.float()
    entering = []
    for c in range(nc):
        entering.append(prev)
        prev = states[:, c] + prev * torch.exp(seg_total[:, c])[:, :, None,
                                                                 None]
    prev_states = torch.stack(entering, dim=1)             # [Bt,nc,H,P,N]

    y_inter = torch.einsum("bcin,bchpn->bcihp", cc, prev_states) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bt, nc * q, h, p)[:, :s]
    return y.to(x.dtype), prev


def _check(x, dt, a, bmat, cmat, init_state) -> None:
    named = [("dt", dt), ("a", a), ("bmat", bmat), ("cmat", cmat)]
    if init_state is not None:
        named.append(("init_state", init_state))
    dev = x.device
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on {dev}")
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan: no kernel for device {dev} (CPU "
                         "tensors take the plain version)")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"ssd_scan: x dtype {x.dtype} not supported "
                        "(float32, bfloat16)")
    bad = [n for n, t in named if t.dtype != torch.float32]
    if bad:
        raise TypeError(f"ssd_scan: {bad} must be float32")
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or bmat.dim() != 3 \
            or cmat.dim() != 3:
        raise ValueError("ssd_scan: expected x [B,S,H,P], dt [B,S,H], a [H], "
                         "bmat and cmat [B,S,N]")
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    if tuple(dt.shape) != (b, s, h) or tuple(a.shape) != (h,) \
            or tuple(bmat.shape) != (b, s, n) \
            or tuple(cmat.shape) != (b, s, n) or (
                init_state is not None
                and tuple(init_state.shape) != (b, h, p, n)):
        raise ValueError(
            f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, a "
            f"{tuple(a.shape)}, bmat {tuple(bmat.shape)}, cmat "
            f"{tuple(cmat.shape)}"
            + (f", init_state {tuple(init_state.shape)}"
               if init_state is not None else "") + " do not agree")
    if min(b, s, h) < 1 or not 1 <= n <= MAX_STATE or p % 16 \
            or not 16 <= p <= MAX_ROWS:
        raise ValueError(f"ssd_scan: B, S, H = {b}, {s}, {h}, head dim {p} "
                         f"(a multiple of 16 up to {MAX_ROWS}) and state {n} "
                         f"(1..{MAX_STATE}) out of range")
    wrong = [name for name, t in [("x", x), ("a", a)] + named[2:]
             if t.stride(-1) != 1 and t.shape[-1] > 1]
    if wrong:
        raise ValueError(f"ssd_scan: {wrong} need unit stride along their "
                         "last axis")
    if any(st < 0 for t in [x] + [t for _, t in named] for st in t.stride()):
        raise ValueError("ssd_scan: negative strides are not supported")


CHUNK = 64               # the kernel's own chunk length
HANDOFF_WARPS = 8        # warps of a main block, each hands on its own part
LAUNCHES = 2             # a call: prep, then the main launch


def kernel_plan(b: int, s: int, h: int, n: int) -> Tuple[int, int, int]:
    """The kernel's work for one call: (chunks, blocks of the main launch
    (one per (batch, chunk, head), in the kernel's chunk-major ticket
    order), state columns kept in shared memory (``n`` padded to 64 or
    128))."""
    nc = -(-s // CHUNK)
    return nc, b * nc * h, 64 if n <= 64 else 128


def scratch_sizes(b: int, s: int, h: int, n: int) -> Tuple[int, int]:
    """(float32 workspace, int32 counters) of one call: C B^T and C^T per
    (batch, chunk), then two state slots per (batch, head); the ticket and
    a progress counter per (batch, head) for each of the main block's
    ``HANDOFF_WARPS`` warps."""
    nc, _, npad = kernel_plan(b, s, h, n)
    states = b * h * 2 * npad * MAX_ROWS
    return b * nc * CHUNK * (CHUNK + npad) + states, 1 + b * h * HANDOFF_WARPS


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, built and loaded on first use."""
    fn = _build.library("ssd_scan").ssd_scan_launch
    fn.restype = _I
    fn.argtypes = [_I] + [_P] * 10 + [_I] * 5 + [_L] * 13 + [_I, _P]
    return fn


def _aligned(t, base_strides) -> bool:
    """16-byte copies reach every row: a 16-byte aligned base and strides
    that are multiples of 16 bytes."""
    elt = t.element_size()
    return t.data_ptr() % 16 == 0 and all((st * elt) % 16 == 0
                                          for st in base_strides)


def ssd_scan(x, dt, a, bmat, cmat, *, chunk: int = 256,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P], dt [B,S,H], a [H], bmat/cmat [B,S,N], init_state
    [B,H,P,N] or None -> (y [B,S,H,P] in x's dtype, final state
    [B,H,P,N] float32).  CPU tensors take ``ssd_scan_ref`` (``chunk``
    is its chunk length); CUDA tensors launch the kernel (see the module
    docstring)."""
    tensors = [x, dt, a, bmat, cmat] + (
        [init_state] if init_state is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk,
                            init_state=init_state)
    if any(t.requires_grad for t in tensors):
        raise NotImplementedError(_BACKWARD)
    _check(x, dt, a, bmat, cmat, init_state)
    fn = _entry()
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=x.device)
    fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    init_ptr, init_strides = None, (0, 0, 0)
    if init_state is not None:
        init_ptr, init_strides = init_state.data_ptr(), init_state.stride()[:3]
    vec = int(_aligned(x, x.stride()[:3])) \
        | 2 * int(n % 4 == 0 and _aligned(bmat, bmat.stride()[:2])) \
        | 4 * int(n % 4 == 0 and _aligned(cmat, cmat.stride()[:2]))
    with torch.cuda.device(x.device):
        stream = _scratch.stream(x.device)
        ws, sync = _scratch.buffers(x.device, stream,
                                    *scratch_sizes(b, s, h, n))
        err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(),
                 a.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), init_ptr,
                 y.data_ptr(), fin.data_ptr(), ws.data_ptr(), sync.data_ptr(),
                 b, s, h, p, n, *x.stride()[:3], *dt.stride(), bmat.stride(0),
                 bmat.stride(1), cmat.stride(0), cmat.stride(1),
                 *init_strides, vec, stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_scan: launch failed with CUDA error {err} (x "
            f"{tuple(x.shape)}, state {n}, {x.dtype})")
    ssd_scan.launches += LAUNCHES
    return y, fin


ssd_scan.launches = 0
