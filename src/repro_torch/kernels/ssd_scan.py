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
or device it does not take.  Nothing falls back.  ``ssd_scan.launches``
counts kernel launches, ``LAUNCHES`` a call.

The gradient (``SSDScanFn``, taken whenever autograd has to see the
call): ``ssd_scan_bwd`` computes dx, ddt, da, dB, dC and d(init_state)
from dy and d(final_state), the gradients ``jax.vjp`` of
``repro.models.mamba2.ssd_chunked`` gives.  The Pallas kernel has no
backward (JAX differentiates the jnp ``ssd_chunked``), so its CUDA
kernel, ``csrc/ssd_scan_bwd.cu``, replaces no TPU kernel; it exists
because a CUDA tensor never takes a plain version.  CPU tensors take
``ssd_scan_bwd_ref``, the chunk-wise backward written out in explicit
formulas, which the kernel mirrors.  Design, memory and bound are in the
source note; ``ssd_scan_bwd.launches`` counts its launches,
``bwd_plan(...).launches`` names a call's (of ``LAUNCHES_BWD``: the
chain of states past a single chunk or with an initial state, main, and
the reduce, which sums da and, when there are several head groups, dB
and dC over them).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, _scratch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 128          # N: padded to 64 or 128 state columns
MAX_ROWS = 64            # P: rows of the state (one block's worth)
_I = ctypes.c_int
_L = ctypes.c_longlong
_P = ctypes.c_void_p


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


def _launch(x, dt, a, bmat, cmat, init_state):
    """The forward kernel on CUDA tensors (checked first)."""
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


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors if t is not None)


def _forward(x, dt, a, bmat, cmat, chunk, init_state):
    if _on_cpu(x, dt, a, bmat, cmat, init_state):
        return ssd_scan_ref(x, dt, a, bmat, cmat, chunk=chunk,
                            init_state=init_state)
    return _launch(x, dt, a, bmat, cmat, init_state)


def ssd_scan(x, dt, a, bmat, cmat, *, chunk: int = 256,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,H,P], dt [B,S,H], a [H], bmat/cmat [B,S,N], init_state
    [B,H,P,N] or None -> (y [B,S,H,P] in x's dtype, final state
    [B,H,P,N] float32).  CPU tensors take ``ssd_scan_ref`` (``chunk``
    is its chunk length); CUDA tensors launch the kernel (see the module
    docstring); through ``SSDScanFn`` when an input requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, bmat, cmat, init_state)):
        return SSDScanFn.apply(x, dt, a, bmat, cmat, init_state, chunk)
    return _forward(x, dt, a, bmat, cmat, chunk, init_state)


ssd_scan.launches = 0


# ------------------------------------------------------------- backward ---
def ssd_scan_bwd_ref(x, dt, a, bmat, cmat, dy, dfinal=None, *,
                     chunk: int = 256,
                     init_state: Optional[torch.Tensor] = None):
    """Plain PyTorch version of the backward, the chunk-wise formulas
    the kernel computes (float32 throughout).  Per chunk, with cum the
    inclusive cumsum of dt * a, seg its last value, L[i, j] = exp(cum_i
    - cum_j) for i >= j, w = exp(seg - cum) dt, E the state entering the
    chunk and G the gradient of the state leaving it (G of the last
    chunk is d(final_state), G of chunk c - 1 is exp(seg) G + sum_i
    exp(cum_i) dy_i C_i^T, and what that gives before chunk 0 is
    d(init_state)):

      M = dy x^T (per head)     K = C B^T o L o M     S = C B^T o L o dt^T
      dx = S^T dy + w o (B G^T)
      dC = (sum_h M o L o dt^T) B + sum_h exp(cum) o (dy E)
      dB = (sum_h M o L o dt^T)^T C + sum_h w o (x G)
      d cum = K dt - dt o colsum(K) + exp(cum) o rowsum(C o (dy E))
              - w o rowsum(x o (B G^T))
      d seg = exp(seg) <G, E> + sum_j w_j x_j . (B G^T)_j
      d(dt * a) = reverse cumsum of d cum, plus d seg
      ddt = a d(dt * a) + colsum(K) + exp(seg - cum) o rowsum(x o (B G^T))
      da = sum over batch and positions of d(dt * a) o dt

    Returns (dx [B,S,H,P] in x's dtype, ddt [B,S,H], da [H], dB
    [B,S,N], dC [B,S,N], d(init_state) [B,H,P,N] or None without an
    ``init_state``); ``dfinal`` None means zeros."""
    bt, s, h, p = x.shape
    n = bmat.shape[-1]
    q = chunk
    nc = -(-s // q)
    pad = nc * q - s
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dy = F.pad(dy, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
    xc = x.reshape(bt, nc, q, h, p).float()
    dyc = dy.reshape(bt, nc, q, h, p).float()
    dtc = dt.reshape(bt, nc, q, h).float()
    bc = bmat.reshape(bt, nc, q, n).float()
    cc = cmat.reshape(bt, nc, q, n).float()
    af = a.float()

    cum = torch.cumsum(dtc * af, dim=2)                   # [Bt,nc,q,H]
    seg = cum[:, :, -1]                                   # [Bt,nc,H]
    eseg = torch.exp(seg)
    ecum = torch.exp(cum)
    ed = torch.exp(seg[:, :, None] - cum)                 # decay to the end
    w = ed * dtc
    ii = torch.arange(q, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    lmat = torch.where(causal, torch.exp(cum[:, :, :, None]
                                         - cum[:, :, None, :]), 0.0)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)

    # the state entering each chunk, and the gradient of the one leaving
    own = torch.einsum("bcjh,bcjn,bcjhp->bchpn", w, bc, xc)
    rown = torch.einsum("bcih,bcin,bcihp->bchpn", ecum, cc, dyc)
    e = torch.zeros((bt, h, p, n), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.float()
    ents = []
    for c in range(nc):
        ents.append(e)
        e = own[:, c] + e * eseg[:, c, :, None, None]
    g = torch.zeros((bt, h, p, n), dtype=torch.float32, device=x.device) \
        if dfinal is None else dfinal.float()
    gs = [None] * nc
    for c in range(nc - 1, -1, -1):
        gs[c] = g
        g = rown[:, c] + g * eseg[:, c, :, None, None]
    ent = torch.stack(ents, dim=1)                        # [Bt,nc,H,P,N]
    gl = torch.stack(gs, dim=1)

    bg = torch.einsum("bcjn,bchpn->bcjhp", bc, gl)        # B G^T
    m = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    kmat = cb[..., None] * lmat * m
    scores = cb[..., None] * lmat * dtc[:, :, None]
    dx = torch.einsum("bcijh,bcihp->bcjhp", scores, dyc) + w[..., None] * bg
    dcb = (m * lmat * dtc[:, :, None]).sum(-1)            # over the heads
    dye = torch.einsum("bcihp,bchpn->bcihn", dyc, ent)
    d_c = torch.einsum("bcij,bcjn->bcin", dcb, bc) \
        + torch.einsum("bcih,bcihn->bcin", ecum, dye)
    d_b = torch.einsum("bcij,bcin->bcjn", dcb, cc) \
        + torch.einsum("bcjh,bcjhp,bchpn->bcjn", w, xc, gl)
    row_k = (kmat * dtc[:, :, None]).sum(3)               # [Bt,nc,i,H]
    col_k = kmat.sum(2)                                   # [Bt,nc,j,H]
    r = ecum * torch.einsum("bcihn,bcin->bcih", dye, cc)
    v = ed * (xc * bg).sum(-1)
    u = dtc * v
    dseg = eseg * (gl * ent).sum((-1, -2)) + u.sum(2)
    dcum = row_k - dtc * col_k + r - u
    dda = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2]) \
        + dseg[:, :, None]
    ddt = af * dda + col_k + v
    da = (dda * dtc).sum((0, 1, 2))
    dx = dx.reshape(bt, nc * q, h, p)[:, :s].to(x.dtype)
    ddt = ddt.reshape(bt, nc * q, h)[:, :s]
    d_b = d_b.reshape(bt, nc * q, n)[:, :s]
    d_c = d_c.reshape(bt, nc * q, n)[:, :s]
    return dx, ddt, da, d_b, d_c, (g if init_state is not None else None)


# the launches a backward call can make, each at most once: the chain of
# states (past a single chunk, or with an initial state, whose gradient it
# writes), main, and the reduce (da; dB and dC over head groups when there
# are several), which every call makes
LAUNCHES_BWD = ("chain", "main", "reduce")
BWD_MIN_BLOCKS = 132     # main blocks to aim for (one an SM on an H100)


def bwd_state_cols(n: int) -> int:
    """State columns the backward keeps: ``n`` padded to 16, 32, 64 or
    128."""
    return next(c for c in (16, 32, 64, 128) if n <= c)


class BwdPlan(NamedTuple):
    """One backward call's work: ``chunks`` of 64 rows; main's ``groups``
    of ``per`` heads (a block per (batch, chunk, group)); the float32
    workspace it needs; its ``launches``, by name (``LAUNCHES_BWD``)."""
    chunks: int
    groups: int
    per: int
    floats: int
    launches: Tuple[str, ...]


def bwd_plan(b: int, s: int, h: int, p: int, n: int, init: bool = False,
             n_sm: int = BWD_MIN_BLOCKS) -> BwdPlan:
    """The plan of one backward call.  Main runs a block per (batch,
    chunk, head group), each walking its group's heads: the most heads a
    group that still give ``n_sm`` blocks (one head a group when even
    that gives fewer).  The workspace holds, past a single chunk, the
    state entering each chunk and the gradient of the state leaving it
    per head ([B, chunks, H, P, NP] each, written by the chain launch and
    read by main), the da partial per (batch, chunk, head), and with more
    than one group each main block's dB and dC partials ([2, 64, NP]);
    the reduce launch sums the da partials in a fixed order and the dB
    and dC partials in group order."""
    nc = -(-s // CHUNK)
    npad = bwd_state_cols(n)
    per = -(-h // max(1, min(h, -(-n_sm // (b * nc)))))
    while per > 1 and b * nc * -(-h // per) < n_sm:
        per -= 1
    groups = -(-h // per)
    states = 2 * b * nc * h * p * npad if nc > 1 else 0
    parts = b * nc * groups * 2 * CHUNK * npad if groups > 1 else 0
    launches = LAUNCHES_BWD if nc > 1 or init else LAUNCHES_BWD[1:]
    return BwdPlan(nc, groups, per, states + b * nc * h + parts, launches)


@functools.lru_cache(maxsize=None)
def _entry_bwd():
    """The backward's C entry point, built and loaded on first use."""
    fn = _build.library("ssd_scan_bwd").ssd_scan_bwd_launch
    fn.restype = _I
    fn.argtypes = [_I] + [_P] * 15 + [_I] * 7 + [_L] * 10 + [_I, _P]
    return fn


def _check_bwd(x, dy, dfinal, n: int) -> None:
    if dy.device != x.device or (dfinal is not None
                                 and dfinal.device != x.device):
        raise ValueError("ssd_scan_bwd: dy and d(final_state) must be on "
                         f"x's device {x.device}")
    if dy.dtype != x.dtype or tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"ssd_scan_bwd: dy {dy.dtype} {tuple(dy.shape)} "
                         f"must match y ({x.dtype} {tuple(x.shape)})")
    b, _, h, p = x.shape
    if dfinal is not None and (dfinal.dtype != torch.float32
                               or tuple(dfinal.shape) != (b, h, p, n)):
        raise ValueError(f"ssd_scan_bwd: d(final_state) {dfinal.dtype} "
                         f"{tuple(dfinal.shape)} must be float32 "
                         f"[{b}, {h}, {p}, {n}]")


def _launch_bwd(x, dt, a, bmat, cmat, dy, dfinal, init_state):
    """The backward kernel on CUDA tensors (checked first)."""
    _check(x, dt, a, bmat, cmat, init_state)
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    _check_bwd(x, dy, dfinal, n)
    fn = _entry_bwd()
    dev = x.device
    plan = bwd_plan(b, s, h, p, n, init_state is not None,
                    _scratch.sm_count(dev.index or 0))
    dy = dy.contiguous()
    dfinal = dfinal.contiguous() if dfinal is not None else None
    init = init_state.contiguous() if init_state is not None else None
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, s, h), **f32)
    da = torch.empty((h,), **f32)
    d_b = torch.empty((b, s, n), **f32)
    d_c = torch.empty((b, s, n), **f32)
    dinit = torch.empty((b, h, p, n), **f32) if init is not None else None
    ws = torch.empty((plan.floats,), **f32)
    vec = int(_aligned(x, x.stride()[:3])) \
        | 2 * int(n % 4 == 0 and _aligned(bmat, bmat.stride()[:2])) \
        | 4 * int(n % 4 == 0 and _aligned(cmat, cmat.stride()[:2]))

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        stream = _scratch.stream(dev)
        err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), dy.data_ptr(),
                 dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
                 cmat.data_ptr(), ptr(init), ptr(dfinal), dx.data_ptr(),
                 ddt.data_ptr(), da.data_ptr(), d_b.data_ptr(),
                 d_c.data_ptr(), ptr(dinit), ws.data_ptr(), b, s, h, p, n,
                 plan.groups, plan.per, *x.stride()[:3], *dt.stride(),
                 bmat.stride(0), bmat.stride(1),
                 cmat.stride(0), cmat.stride(1), vec, stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_scan_bwd: launch failed with CUDA error {err} (x "
            f"{tuple(x.shape)}, state {n}, {x.dtype})")
    ssd_scan_bwd.launches += len(plan.launches)
    return dx, ddt, da, d_b, d_c, dinit


def ssd_scan_bwd(x, dt, a, bmat, cmat, dy, dfinal=None, *,
                 chunk: int = 256,
                 init_state: Optional[torch.Tensor] = None):
    """The gradients of ``ssd_scan`` (see ``ssd_scan_bwd_ref`` for what
    it returns).  CPU tensors take ``ssd_scan_bwd_ref`` (``chunk`` is its
    chunk length); CUDA tensors launch the kernel, or raise."""
    if _on_cpu(x, dt, a, bmat, cmat, dy, dfinal, init_state):
        return ssd_scan_bwd_ref(x, dt, a, bmat, cmat, dy, dfinal,
                                chunk=chunk, init_state=init_state)
    return _launch_bwd(x, dt, a, bmat, cmat, dy, dfinal, init_state)


ssd_scan_bwd.launches = 0


class SSDScanFn(torch.autograd.Function):
    """``ssd_scan`` with its gradient in every input: the forward as
    ``ssd_scan`` runs it, the backward ``ssd_scan_bwd`` (the kernel on
    the card, the plain version on the CPU)."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, cmat, init_state, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, a, bmat, cmat, init_state)
        return _forward(x, dt, a, bmat, cmat, chunk, init_state)

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, a, bmat, cmat, init_state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        grads = ssd_scan_bwd(x, dt, a, bmat, cmat, dy, dfinal,
                             chunk=ctx.chunk, init_state=init_state)
        return (*grads, None)
