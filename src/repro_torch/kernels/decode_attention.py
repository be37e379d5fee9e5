"""Decode attention: one query token per sequence against its K/V.

Two kernels, each replacing a TPU kernel of ``repro.kernels.
decode_attention`` with a CUDA kernel written for Hopper, built by
``kernels/_build.py`` and bound with ``ctypes``:

``paged_decode_attention``  K/V in a global block pool walked through
    per-sequence block tables; replaces ``paged_decode_attention``
    (``src/repro/kernels/decode_attention.py:172``, its ``pallas_call``
    at ``:215``) with ``csrc/paged_decode_attention.cu``.  The self
    attention of every decoder block runs it, the contiguous cache
    through identity block tables.  Its ``return_lse`` launch writes the
    unrounded float32 output and each row's log-sum-exp instead (zeros
    and ``-inf`` for a row with ``kv_len == 0``): a rank's partial of the
    sequence-sharded decode (``models/layers.py::
    attention_decode_seqsharded``), which the ranks combine through one
    max and one sum.
``decode_attention``        head-major caches ``[B, Hkv, S, D]`` of any
    strides with a unit last axis; replaces ``decode_attention``
    (``:80``, its ``pallas_call`` at ``:101``) with
    ``csrc/decode_attention.cu``.  The VLM's cross-attention decode runs
    it over each request's static vision K/V, passed as the transposed
    view of its ``[B, T, Hkv, D]`` projection (no copy).

Both are memory-bound: a call must read ``sum_b kv_len_b * Hkv * D * 2 *
sizeof(T)`` bytes of K/V and does about two FLOP per element read.  The
design notes are in the sources.  In bfloat16 both run one kernel body,
``csrc/decode_bf16.cuh`` (TMA-fed K/V tiles, tensor-core products, the
walk split by ``split_plan_bf16`` and combined by its last block), the
paged one loading each 64-row tile through the block table
(``paged_plan_bf16``); ``decode_attention`` in float32 splits by
``split_plan``.  The partials and ticket counters live in the scratch of
``kernels/_scratch.py``.

Each wrapper dispatches on where its tensors lie: CPU tensors take the
plain PyTorch version (``paged_decode_attention_ref``,
``paged_decode_attention_lse_ref``, ``decode_attention_ref``: the
contiguous decode math in float32); CUDA
tensors launch the kernel, or raise on a dtype, shape, layout or device
it does not take.  Nothing falls back from one to the other.  Each
wrapper's ``launches`` counts its kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _scratch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_I = ctypes.c_int
_L = ctypes.c_int64
_P = ctypes.c_void_p


def decode_attention_math(q, k, v, kv_len, scale: float):
    """Contiguous single-token GQA attention in f32: q [B,H,D]; k, v
    [B,S,Hkv,D]; kv_len [B] -> [B,H,D] in q's dtype.  Positions at or
    past ``kv_len`` are masked; a row with ``kv_len == 0`` gives zeros
    (the kernel's clamped-``l`` contract)."""
    b, h, d = q.shape
    s = k.shape[1]
    g = h // k.shape[2]
    kr = k.repeat_interleave(g, dim=2) if g > 1 else k
    vr = v.repeat_interleave(g, dim=2) if g > 1 else v
    scores = torch.einsum("bhd,bkhd->bhk", q.float(), kr.float()) * scale
    mask = torch.arange(s, device=q.device)[None, :] < kv_len[:, None]
    scores = scores.masked_fill(~mask[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)          # kv_len == 0 rows
    out = torch.einsum("bhk,bkhd->bhd", probs, vr.float())
    return out.to(q.dtype)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, kv_len,
                               scale: Optional[float] = None):
    """Plain PyTorch version: gather each sequence's logical cache
    [B, NB*bs, Hkv, D] through its table, then the contiguous math."""
    b, nb = block_tables.shape
    bs = k_pool.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    idx = block_tables.long()
    k = k_pool[idx].reshape(b, nb * bs, *k_pool.shape[2:])
    v = v_pool[idx].reshape(b, nb * bs, *v_pool.shape[2:])
    return decode_attention_math(q, k, v, kv_len, scale)


def paged_decode_attention_lse_ref(q, k_pool, v_pool, block_tables, kv_len,
                                   scale: Optional[float] = None):
    """Plain PyTorch version of the ``return_lse`` launch: (out [B,H,D]
    float32, unrounded; lse [B,H] float32), the contiguous math over the
    gathered caches in float32; a row with ``kv_len == 0`` gives zeros
    and ``-inf``."""
    b, nb = block_tables.shape
    bs = k_pool.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    idx = block_tables.long()
    k = k_pool[idx].reshape(b, nb * bs, *k_pool.shape[2:])
    v = v_pool[idx].reshape(b, nb * bs, *v_pool.shape[2:])
    g = q.shape[1] // k.shape[2]
    kr = k.repeat_interleave(g, dim=2) if g > 1 else k
    vr = v.repeat_interleave(g, dim=2) if g > 1 else v
    scores = torch.einsum("bhd,bkhd->bhk", q.float(), kr.float()) * scale
    mask = torch.arange(nb * bs, device=q.device)[None, :] < kv_len[:, None]
    scores = scores.masked_fill(~mask[:, None, :], float("-inf"))
    lse = torch.logsumexp(scores, dim=-1)                   # -inf: no key
    probs = torch.nan_to_num(torch.exp(scores - lse[..., None]), nan=0.0)
    out = torch.einsum("bhk,bkhd->bhd", probs, vr.float())
    return out, lse


def _check(q, k_pool, v_pool, block_tables, kv_len) -> None:
    """What both kernels refuse, each with its own message, before any
    build or launch (so CPU tensors reach every refusal but the last,
    which names the device)."""
    dev = q.device
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("kv_len", kv_len)):
        if t.device != dev:
            raise ValueError(f"paged_decode_attention: {name} is on "
                             f"{t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged_decode_attention: dtype {q.dtype} not "
                        "supported (float32, bfloat16)")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged_decode_attention: q, k_pool and v_pool "
                        f"must share a dtype, got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if block_tables.dtype != torch.int32 or kv_len.dtype != torch.int32:
        raise TypeError("paged_decode_attention: block_tables and kv_len "
                        "must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or block_tables.dim() != 2 \
            or kv_len.dim() != 1:
        raise ValueError("paged_decode_attention: expected q [B,H,D], "
                         "pools [n_blocks,bs,Hkv,D], tables [B,NB], "
                         "kv_len [B]")
    b, h, d = q.shape
    _, _, hkv, dk = k_pool.shape
    if v_pool.shape != k_pool.shape or dk != d or h % hkv \
            or block_tables.shape[0] != b or kv_len.shape[0] != b:
        raise ValueError(
            f"paged_decode_attention: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, tables "
            f"{tuple(block_tables.shape)}, kv_len {tuple(kv_len.shape)} "
            "do not agree")
    if not (kv_len.is_contiguous() and block_tables.stride(1) == 1):
        raise ValueError("paged_decode_attention: kv_len must be contiguous "
                         "and table rows unit-stride")
    if q.dtype == torch.bfloat16:
        # the MMAs take the G query heads of a KV head as N (8) and 64- or
        # 128-channel rows; TMA reads 16-byte aligned bases and strides
        if d not in BF16_HEAD_DIMS:
            raise ValueError(f"paged_decode_attention: bf16 takes head_dim "
                             f"in {BF16_HEAD_DIMS}, got {d}")
        if h // hkv > BF16_MAX_G:
            raise ValueError(f"paged_decode_attention: bf16 takes at most "
                             f"{BF16_MAX_G} query heads per KV head, got "
                             f"{h // hkv}")
        for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
            if t.stride(-1) != 1:
                raise ValueError(f"paged_decode_attention: {name} needs a "
                                 "unit stride on its last axis (strides "
                                 f"{tuple(t.stride())})")
            if t.data_ptr() % 16:
                raise ValueError(f"paged_decode_attention: {name}'s base "
                                 "address is not 16-byte aligned")
            if any((st * 2) % 16 for st in t.stride()[:-1]):
                raise ValueError(
                    f"paged_decode_attention: {name}'s strides "
                    f"{tuple(t.stride())} of 2-byte elements are not "
                    "multiples of 16 bytes")
        if q.stride(-1) != 1:
            raise ValueError("paged_decode_attention: q needs a unit stride "
                             "on its last axis")
    else:
        if not (q.is_contiguous() and k_pool.is_contiguous()
                and v_pool.is_contiguous()):
            raise ValueError("paged_decode_attention: float32 q and pools "
                             "must be contiguous")
        # the float32 kernel gathers K/V rows 16 bytes at a time
        if (d * q.element_size()) % 16 or k_pool.data_ptr() % 16 \
                or v_pool.data_ptr() % 16:
            raise ValueError(
                f"paged_decode_attention: head_dim {d} x {q.element_size()} "
                "bytes must be a multiple of 16 and the pools 16-byte "
                "aligned")
    if dev.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for device "
                         f"{dev} (CPU tensors take the plain version)")


def paged_plan_bf16(b: int, hkv: int, bs: int, nb: int,
                    n_sm: int) -> Tuple[int, int, int]:
    """bfloat16: (splits, rows per split, rows per TMA box).  The walk
    splits as the contiguous kernel's does over the table's ``nb * bs``
    rows (``split_plan_bf16``: 1 split at the serve tick's 8 sequences
    of 16 KV heads, 2 at llama3-8b's 4 of 8); a 64-row tile is ``64 /
    box`` loads of ``box = gcd(bs, 64)`` rows, which never cross a pool
    block."""
    splits, chunk = split_plan_bf16(b, hkv, nb * bs, n_sm)
    return splits, chunk, math.gcd(bs, BF16_TILE_ROWS)


@functools.lru_cache(maxsize=None)
def _entry():
    """The float32 C entry point, built and loaded on first use."""
    fn = _build.library("paged_decode_attention") \
        .paged_decode_attention_launch
    fn.restype = _I
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _I, ctypes.c_float, _P]
    return fn


@functools.lru_cache(maxsize=None)
def _entry_bf16():
    """The bfloat16 C entry point, built and loaded on first use."""
    fn = _build.library("paged_decode_attention") \
        .paged_decode_attention_bf16_launch
    fn.restype = _I
    fn.argtypes = [_P] * 11 + [_I] * 7 + [_L] * 9 + [_I] * 3 \
        + [ctypes.c_float, _P]
    return fn


def _launch(q, k_pool, v_pool, block_tables, kv_len, scale: float,
            return_lse: bool = False):
    _check(q, k_pool, v_pool, block_tables, kv_len)
    b, h, d = q.shape
    n_blocks, bs, hkv = k_pool.shape[:3]
    nb = block_tables.shape[1]
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) \
        if return_lse else None
    # the float32 output of a bf16 launch that returns the lse (the
    # bf16 `out` is then not written)
    out_f32 = torch.empty((b, h, d), dtype=torch.float32, device=q.device) \
        if return_lse and q.dtype == torch.bfloat16 else None
    with torch.cuda.device(q.device):
        if q.dtype == torch.bfloat16:
            fn = _entry_bf16()
            splits, chunk, box = paged_plan_bf16(
                b, hkv, bs, nb, _scratch.sm_count(q.device.index or 0))
            stream = _scratch.stream(q.device)
            # per (b, query head, split): the partial acc [D], then (m, l);
            # one ticket per (b, KV head)
            n_acc = b * h * splits * d
            ws, tickets = _scratch.buffers(q.device, stream,
                                           n_acc + b * h * splits * 2,
                                           b * hkv)
            err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                     block_tables.data_ptr(), kv_len.data_ptr(),
                     out.data_ptr(), _ptr(out_f32), _ptr(lse),
                     ws.data_ptr(), ws.data_ptr() + 4 * n_acc,
                     tickets.data_ptr(), b, h, hkv, d, n_blocks, bs, nb,
                     block_tables.stride(0), q.stride(0), q.stride(1),
                     *k_pool.stride()[:3], *v_pool.stride()[:3], splits,
                     chunk, box, scale, stream)
        else:
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = _entry()(_DTYPE_CODE[q.dtype], q.data_ptr(),
                           k_pool.data_ptr(), v_pool.data_ptr(),
                           block_tables.data_ptr(), kv_len.data_ptr(),
                           out.data_ptr(), _ptr(lse), b, h, hkv, d, bs, nb,
                           block_tables.stride(0), scale, stream)
    if err != 0:
        raise RuntimeError(
            f"paged_decode_attention: launch failed with CUDA error {err} "
            f"(q {tuple(q.shape)}, pools {tuple(k_pool.shape)}, "
            f"tables {tuple(block_tables.shape)}, {q.dtype})")
    if return_lse:
        paged_decode_attention.lse_launches += 1
        return (out if out_f32 is None else out_f32), lse
    paged_decode_attention.launches += 1
    return out


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def paged_decode_attention(q, k_pool, v_pool, block_tables, kv_len,
                           scale: Optional[float] = None,
                           return_lse: bool = False):
    """q [B,H,D]; pools [n_blocks, block_size, Hkv, D]; block_tables
    [B, NB] int32; kv_len [B] int32 -> [B,H,D].

    Table entries past a sequence's live blocks must be valid pool
    indices (the runtime points them at scratch block 0); they are never
    read.  CPU tensors take ``paged_decode_attention_ref``; CUDA tensors
    launch the kernel (see the module docstring).  The bfloat16 kernel
    takes head_dim 64 or 128, at most 8 query heads per KV head, pools of
    any strides with a unit last axis that are multiples of 16 bytes and
    16-byte aligned bases, and raises otherwise; every shipped config
    qualifies (qwen1.5-0.5b G 1 / D 64, internlm2-1.8b G 2 / D 128,
    llama3-8b G 4 / D 128, qwen3-14b G 5 / D 128, the VLM's self-attention
    G 8 / D 128, contiguous caches through identity tables of blocks of 1
    to 256 rows).  The float32 kernel takes contiguous q and pools.

    ``return_lse=True`` returns ``(out, lse)`` instead: the output
    unrounded in float32 ``[B, H, D]`` and each row's natural log-sum-exp
    of its scaled scores ``[B, H]`` float32, ``-inf`` (and a zero output)
    for a row with ``kv_len == 0``: a rank's partial of the
    sequence-sharded decode.  Those launches count in ``lse_launches``,
    the others in ``launches``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu" and all(
            t.device.type == "cpu"
            for t in (k_pool, v_pool, block_tables, kv_len)):
        if return_lse:
            return paged_decode_attention_lse_ref(
                q, k_pool, v_pool, block_tables, kv_len, scale)
        return paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                          kv_len, scale)
    return _launch(q, k_pool, v_pool, block_tables, kv_len, scale,
                   return_lse)


paged_decode_attention.launches = 0
paged_decode_attention.lse_launches = 0


# ------------------------------------------------------ contiguous caches --
def decode_attention_ref(q, k_cache, v_cache, kv_len,
                         scale: Optional[float] = None):
    """Plain PyTorch version: the contiguous math on the ``[B, S, Hkv,
    D]`` views of the head-major caches."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return decode_attention_math(q, k_cache.transpose(1, 2),
                                 v_cache.transpose(1, 2), kv_len, scale)


# splits of one (sequence, KV head)'s cache walk, at most
_MAX_SPLITS = 64
# float32: the split kernel's 256 threads keep two PV columns (4 query
# heads, one channel) each: ceil(G / 4) * D <= 512
_MAX_COLS = 512
# bfloat16: the G query heads of a KV head are the MMA's N (8), and the
# tiles are TMA boxes of 64-column swizzle regions
BF16_MAX_G = 8
BF16_HEAD_DIMS = (64, 128)
BF16_TILE_ROWS = 64


def _check_contiguous(q, k_cache, v_cache, kv_len) -> None:
    dev = q.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("kv_len", kv_len)):
        if t.device != dev:
            raise ValueError(f"decode_attention: {name} is on {t.device}, "
                             f"q on {dev}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"decode_attention: dtype {q.dtype} not supported "
                        "(float32, bfloat16)")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("decode_attention: q, k_cache and v_cache must "
                        f"share a dtype, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if kv_len.dtype != torch.int32:
        raise TypeError("decode_attention: kv_len must be int32")
    if q.dim() != 3 or k_cache.dim() != 4 or kv_len.dim() != 1:
        raise ValueError("decode_attention: expected q [B,H,D], caches "
                         "[B,Hkv,S,D], kv_len [B]")
    b, h, d = q.shape
    bk, hkv, s, dk = k_cache.shape
    if v_cache.shape != k_cache.shape or bk != b or dk != d or h % hkv \
            or kv_len.shape[0] != b or s < 1:
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)}, caches "
            f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, kv_len "
            f"{tuple(kv_len.shape)} do not agree")
    g = h // hkv
    if q.dtype == torch.bfloat16 and (g > BF16_MAX_G
                                      or d not in BF16_HEAD_DIMS):
        raise ValueError(f"decode_attention: bf16 takes at most "
                         f"{BF16_MAX_G} query heads per KV head and head_dim "
                         f"in {BF16_HEAD_DIMS}, got {g} and {d}")
    if q.dtype == torch.float32 and -(-g // 4) * d > _MAX_COLS:
        raise ValueError(f"decode_attention: {g} query heads per KV "
                         f"head at head_dim {d} exceeds the kernel's "
                         f"{_MAX_COLS} columns of 4 heads")
    # K/V are read 16 bytes at a time (float32) or by TMA (bfloat16): a
    # unit last axis, a 16-byte aligned base, every other stride a
    # multiple of 16 bytes
    elt = q.element_size()
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name} needs a unit stride "
                             f"on its last axis (strides {tuple(t.stride())})")
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name}'s base address is "
                             "not 16-byte aligned")
        if any((st * elt) % 16 for st in t.stride()[:-1]):
            raise ValueError(
                f"decode_attention: {name}'s strides {tuple(t.stride())} "
                f"of {elt}-byte elements are not multiples of 16 bytes")
    if q.stride(-1) != 1:
        raise ValueError("decode_attention: q needs a unit stride on its "
                         "last axis")
    if (d * elt) % 16 or not kv_len.is_contiguous():
        raise ValueError(f"decode_attention: head_dim {d} x {elt} bytes must "
                         "be a multiple of 16 and kv_len contiguous")
    if dev.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {dev} "
                         "(CPU tensors take the plain version)")


def _cdiv(a: int, c: int) -> int:
    return -(-a // c)


def split_plan(b: int, hkv: int, s: int, n_sm: int) -> Tuple[int, int]:
    """float32: (splits, rows per split) of the cache axis: enough blocks
    of (sequence, KV head, split) for about eight on every SM, each split
    a whole number of the kernel's 32-row tiles, at most ``_MAX_SPLITS``.
    At the VLM's cross shape (64 pairs, 1,601 rows) that is 17 splits of
    96 rows."""
    splits = max(1, min(_cdiv(8 * n_sm, b * hkv), _MAX_SPLITS,
                        _cdiv(s, 32)))
    chunk = _cdiv(_cdiv(s, splits), 32) * 32
    return _cdiv(s, chunk), chunk


def split_plan_bf16(b: int, hkv: int, s: int, n_sm: int) -> Tuple[int, int]:
    """bfloat16: (splits, rows per split) of the cache axis, each split a
    whole number of 64-row tiles, balanced: as many splits as keep the
    blocks of (sequence, KV head, split) within half the SMs, where each
    block's ring keeps three tiles in flight.  At the VLM's cross shape
    (64 pairs, 1,601 rows) 64 blocks already held the walk at the rate
    more blocks reached, and each further split only added the combine
    (``chip_smoke.py splits``, NVIDIA H100 80GB HBM3, 700 W; PERF.md: 1
    split 32.7 us, 2 36.3, 4 36.5, 26 63.9).  So that shape takes 1
    split, and a single sequence's 8 KV heads take 7."""
    tiles = _cdiv(s, BF16_TILE_ROWS)
    splits = max(1, min(tiles, _MAX_SPLITS, (n_sm // 2) // (b * hkv)))
    per = _cdiv(tiles, splits)
    return _cdiv(tiles, per), per * BF16_TILE_ROWS


@functools.lru_cache(maxsize=None)
def _contiguous_entry():
    fn = _build.library("decode_attention").decode_attention_launch
    fn.restype = _I
    fn.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, _I, _I, ctypes.c_float,
                   _P]
    return fn


def _launch_contiguous(q, k_cache, v_cache, kv_len, scale: float):
    _check_contiguous(q, k_cache, v_cache, kv_len)
    fn = _contiguous_entry()
    b, h, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    n_sm = _scratch.sm_count(q.device.index or 0)
    splits, chunk = (split_plan_bf16(b, hkv, s, n_sm)
                     if q.dtype == torch.bfloat16
                     else split_plan(b, hkv, s, n_sm))
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = _scratch.stream(q.device)
        # per (b, query head, split): the partial acc [D], then (m, l);
        # one ticket per (b, KV head)
        n_acc = b * h * splits * d
        ws, tickets = _scratch.buffers(q.device, stream,
                                       n_acc + b * h * splits * 2, b * hkv)
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k_cache.data_ptr(),
                 v_cache.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                 ws.data_ptr(), ws.data_ptr() + 4 * n_acc,
                 tickets.data_ptr(), b, h, hkv, d, s,
                 q.stride(0), q.stride(1), *k_cache.stride()[:3],
                 *v_cache.stride()[:3], splits, chunk, scale, stream)
    if err != 0:
        raise RuntimeError(
            f"decode_attention: launch failed with CUDA error {err} "
            f"(q {tuple(q.shape)}, caches {tuple(k_cache.shape)}, "
            f"{splits} splits of {chunk} rows)")
    decode_attention.launches += 1
    return out


def decode_attention(q, k_cache, v_cache, kv_len,
                     scale: Optional[float] = None):
    """q [B,H,D]; caches [B,Hkv,S,D] (any strides with a unit last
    axis); kv_len [B] int32 -> [B,H,D] in q's dtype.

    Positions at or past ``kv_len`` are masked; a row with ``kv_len ==
    0`` gives zeros.  CPU tensors take ``decode_attention_ref``; CUDA
    tensors launch the kernel (see the module docstring)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if all(t.device.type == "cpu" for t in (q, k_cache, v_cache, kv_len)):
        return decode_attention_ref(q, k_cache, v_cache, kv_len, scale)
    return _launch_contiguous(q, k_cache, v_cache, kv_len, scale)


decode_attention.launches = 0
