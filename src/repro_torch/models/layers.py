"""Core layers of the port: norms, RoPE, GQA attention (dense prefill,
blockwise online-softmax prefill, suffix prefill over a cached prefix,
single-token decode over contiguous and paged caches) and the weight
initializer — the PyTorch counterparts of ``repro.models.layers``.

Plain functions on tensors.  Weight matrices use the ``[in, out]``
convention; stacked-layer params carry a leading ``L`` dim.  Norms and
RoPE compute in float32 and cast back, like the JAX layers.  Both decode
layouts run through ``kernels.decode_attention.paged_decode_attention``:
the paged pool directly, the contiguous cache through identity block
tables.  Blockwise attention on the card runs the ``flash_attention``
kernels (``kernels.flash_attention.FlashAttentionFn``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.flash_attention import FlashAttentionFn
from repro_torch.models import collectives as col


# ---------------------------------------------------------------- norms ----
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ----------------------------------------------------------------- RoPE ----
def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for positions [..., S] -> [..., S, head_dim/2]."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B,S,H,D]; cos/sin: [S,D/2] or [B,S,D/2] (broadcast over heads).
    Rotates the two halves of each head (no interleaving)."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ----
def _gqa_repeat(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,S,Hkv,D] -> [B,S,Hq,D] by repeating each KV head."""
    g = n_heads // k.shape[2]
    return k if g == 1 else k.repeat_interleave(g, dim=2)


def attention_dense(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, kv_len=None,
                    scale: Optional[float] = None):
    """Reference GQA attention (materializes the full score matrix).

    q: [B,Sq,Hq,D]; k,v: [B,Skv,Hkv,D].  ``q_offset`` is the absolute
    position of q[0].  ``kv_len`` ([B] tensor or int) masks positions
    >= kv_len.  Fully masked rows give zeros."""
    sq, skv = q.shape[1], k.shape[1]
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    if kv_len is not None:
        klen = torch.as_tensor(kv_len, device=q.device)
        if klen.dim():
            mask = mask & (kpos[None, :] < klen[:, None, None])   # [B,Sq,Skv]
            mask = mask[:, None]                                   # [B,1,..]
        else:
            mask = mask & (kpos[None, :] < klen)
    return _masked_attention(q, k, v, mask, scale)


def _masked_attention(q, k, v, mask, scale: Optional[float]):
    """The dense formulation both prefill attentions share: GQA repeat,
    float32 scores, masked lanes at -inf, softmax, fully masked rows
    zeroed, so masked lanes contribute exact zeros.  ``mask`` [Sq, Skv]
    or [B, 1, Sq, Skv], True where a query may read a key."""
    b, sq, hq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k = _gqa_repeat(k, hq)
    v = _gqa_repeat(v, hq)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)          # fully-masked rows
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def _online_block(carry, qi, kj, vj, qpos, kpos, skv, causal, window,
                  scale):
    """One (query block, key block) step of the online softmax with the
    JAX numerics: q k^T from the input dtype with float32 accumulation,
    p rounded to v's dtype for the PV product.  carry = (m, l, acc) of
    the query block, [B,bq,H] / [B,bq,H] / [B,bq,H,D] float32."""
    m, l, acc = carry
    s = torch.einsum("bqhd,bkhd->bqhk", qi.float(), kj.float()) * scale
    mask = kpos[None, :] < skv
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window > 0:
        mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
    s = s.masked_fill(~mask[None, :, None, :], float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1))
    dead = torch.isinf(m_new)           # rows with nothing allowed so far
    m_safe = torch.where(dead, torch.zeros_like(m_new), m_new)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(dead[..., None], torch.zeros_like(p), p)
    corr = torch.where(torch.isinf(m), torch.zeros_like(m),
                       torch.exp(m - m_safe))
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bqhk,bkhd->bqhd", p.to(vj.dtype).float(), vj.float())
    return m_new, l_new, acc * corr[..., None] + pv


def attention_blockwise(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0, block_kv: int = 512,
                        scale: Optional[float] = None,
                        skip_masked_blocks: bool = False):
    """Flash-equivalent attention with an online softmax over key blocks
    (``repro.models.layers.attention_blockwise``): memory O(Sq * block)
    instead of O(Sq * Skv).  q: [B,Sq,Hq,D]; k, v: [B,Skv,Hkv,D].

    CPU tensors run the plain block loop: queries and keys in blocks of
    ``block_kv``, every (query block, key block) pair in order, or with
    ``skip_masked_blocks`` (causal self-attention prefill only) just the
    pairs on or below the diagonal and inside the window.  A skipped
    pair would have added exact zeros with correction 1, so the two
    variants give bitwise the same result.  CUDA tensors go to the
    ``flash_attention`` kernels through ``FlashAttentionFn`` (forward
    and gradient); the kernels always skip fully masked tiles and pick
    their own tile sizes, so ``block_kv`` does not reach them, and they
    take no ``q_offset``."""
    if skip_masked_blocks:
        assert causal and q_offset == 0 and q.shape[1] == k.shape[1], \
            "block skipping is for causal self-attention prefill"
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if not all(t.device.type == "cpu" for t in (q, k, v)):
        if q_offset:
            raise ValueError("attention_blockwise: the flash_attention "
                             "kernel takes no q_offset")
        o = FlashAttentionFn.apply(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal, window, scale)
        return o.transpose(1, 2)
    k = _gqa_repeat(k, hq)
    v = _gqa_repeat(v, hq)
    bk = block_kv
    nq, nk = -(-sq // bk), -(-skv // bk)
    q = F.pad(q, (0, 0, 0, 0, 0, nq * bk - sq))
    k = F.pad(k, (0, 0, 0, 0, 0, nk * bk - skv))
    v = F.pad(v, (0, 0, 0, 0, 0, nk * bk - skv))
    wblocks = -(-window // bk) + 1 if window > 0 else nq
    outs = []
    for i in range(nq):
        qpos = q_offset + i * bk + torch.arange(bk, device=q.device)
        carry = (torch.full((b, bk, hq), float("-inf"), device=q.device),
                 torch.zeros((b, bk, hq), device=q.device),
                 torch.zeros((b, bk, hq, d), device=q.device))
        for j in range(nk):
            if skip_masked_blocks and not (j <= i and i - j < wblocks):
                continue
            kpos = j * bk + torch.arange(bk, device=q.device)
            sl = slice(j * bk, (j + 1) * bk)
            carry = _online_block(carry, q[:, i * bk:(i + 1) * bk], k[:, sl],
                                  v[:, sl], qpos, kpos, skv, causal, window,
                                  scale)
        _, l, acc = carry
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


def attention_prefix_suffix(q, k_pre, v_pre, k_suf, v_suf, prefix_len, *,
                            window: int = 0,
                            scale: Optional[float] = None):
    """Suffix-prefill attention: suffix queries attend over a cached
    prefix's K/V (gathered from the cache) plus the suffix's own causal
    K/V (``repro.models.layers.attention_prefix_suffix``).

    q, k_suf, v_suf: [B, Sq, H*, D], row ``i`` of sequence ``b`` at
    absolute position ``prefix_len[b] + i``; k_pre, v_pre: [B, Pp, Hkv,
    D] at positions ``0 .. Pp-1``, valid below ``prefix_len[b]`` (rows
    past it are other blocks' content and are masked).  The same
    formulation as ``attention_dense`` (``_masked_attention``)."""
    b, sq = q.shape[:2]
    pp = k_pre.shape[1]
    k = torch.cat([k_pre.to(q.dtype), k_suf], dim=1)
    v = torch.cat([v_pre.to(q.dtype), v_suf], dim=1)
    plen = torch.as_tensor(prefix_len, device=q.device).long()
    ar_q = torch.arange(sq, device=q.device)
    ar_p = torch.arange(pp, device=q.device)
    qpos = plen[:, None] + ar_q                                 # [B, Sq]
    kpos = torch.cat([ar_p.expand(b, pp), qpos], dim=1)         # [B, Pp+Sq]
    mask = kpos[:, None, :] <= qpos[:, :, None]                 # causal
    real = torch.cat([ar_p[None, :] < plen[:, None],            # prefix
                      torch.ones((b, sq), dtype=torch.bool,
                                 device=q.device)], dim=1)
    mask = mask & real[:, None, :]
    if window > 0:
        mask = mask & ((qpos[:, :, None] - kpos[:, None, :]) < window)
    return _masked_attention(q, k, v, mask[:, None], scale)


def attention_decode(q, k_cache, v_cache, kv_len,
                     scale: Optional[float] = None, return_lse: bool = False):
    """Single-token decode attention over a contiguous KV cache.

    q: [B,1,Hq,D]; caches: [B,S,Hkv,D]; kv_len: [B] int32 — valid cache
    entries (the new token's KV already written).  The cache is viewed as
    a block pool with an identity block table (block size: the largest
    of 256, 128, ..., 1 that divides S, as in the JAX layer), so the
    paged kernel serves both layouts.  ``return_lse``: (out [B,Hq,D]
    float32, lse [B,Hq] float32), the kernel's ``return_lse`` launch."""
    b, _, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    bk = next(bk for bk in (256, 128, 64, 32, 16, 8, 4, 2, 1) if s % bk == 0)
    nk = s // bk
    kp = k_cache.reshape(b * nk, bk, hkv, d)
    vp = v_cache.reshape(b * nk, bk, hkv, d)
    tables = torch.arange(b * nk, dtype=torch.int32,
                          device=q.device).reshape(b, nk)
    out = paged_decode_attention(q[:, 0], kp, vp, tables,
                                 kv_len.to(torch.int32), scale=scale,
                                 return_lse=return_lse)
    if return_lse:
        return out
    return out[:, None].to(q.dtype)


def attention_decode_seqsharded(q, k_new, v_new, k_cache, v_cache, pos,
                                seq_axis, scale: Optional[float] = None):
    """Sequence-sharded flash-decode (``repro.models.layers.
    attention_decode_seqsharded``): each rank of the mesh axis
    ``seq_axis`` owns a contiguous slice of every sequence's cache.

    It writes the new token's K/V only where it owns position ``pos``
    (in place: a rank that does not own it rewrites the slot's old
    value, so there is no data-dependent index), attends over its slice
    with the ``return_lse`` launch of ``paged_decode_attention`` (local
    ``kv_len = clamp(pos - start + 1, 0, S_loc)``: 0, zeros and -inf, on
    a rank whose slice lies past ``pos``), and the ranks combine their
    partials through one MAX and one SUM all-reduce over the axis:
    ``out = sum_r e^(lse_r - M) o_r / sum_r e^(lse_r - M)``.

    q/k_new/v_new: [B,1,H*,D] with every head; caches: [B,S_loc,Hkv,D],
    this rank's slice; pos: [B] (or scalar) positions of the new tokens.
    Returns (out [B,1,Hq,D] in q's dtype, caches)."""
    b, s_loc = k_cache.shape[:2]
    start = col.axis_index(seq_axis) * s_loc
    pos = torch.as_tensor(pos, device=q.device).long().expand(b)
    loc = pos - start
    own = (loc >= 0) & (loc < s_loc)
    loc_c = loc.clamp(0, s_loc - 1)
    rows = torch.arange(b, device=q.device)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        old = cache[rows, loc_c]
        cache[rows, loc_c] = torch.where(own[:, None, None],
                                         new[:, 0].to(cache.dtype), old)
    kv_len = (loc + 1).clamp(0, s_loc).to(torch.int32)
    o, lse = attention_decode(q, k_cache, v_cache, kv_len, scale=scale,
                              return_lse=True)         # [B,H,D], [B,H]
    m = col.pmax(lse, seq_axis)
    w = torch.where(torch.isinf(m), torch.zeros_like(lse), torch.exp(lse - m))
    h, d = o.shape[1:]
    packed = torch.cat([(w[..., None] * o).reshape(b, h * d), w], dim=1)
    packed = col.psum(packed, seq_axis)
    num, den = packed[:, :h * d].reshape(b, h, d), packed[:, h * d:]
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out[:, None].to(q.dtype), (k_cache, v_cache)


def attention_decode_paged(q, k_pool, v_pool, block_tables, kv_len,
                           scale: Optional[float] = None):
    """Single-token decode attention over one layer's paged KV pool.

    q: [B,1,Hq,D]; pools: [n_blocks, block_size, Hkv, D]; block_tables:
    [B, NB] int32; kv_len: [B] int32 valid logical length."""
    out = paged_decode_attention(q[:, 0], k_pool, v_pool, block_tables,
                                 kv_len.to(torch.int32), scale=scale)
    return out[:, None].to(q.dtype)


# ----------------------------------------------------------------- init ----
def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, scale: Optional[float] = None
               ) -> torch.Tensor:
    """N(0, scale^2) weights on the generator's device, scale 1/sqrt(d_in)
    by default, drawn in float32 and cast (the JAX initializer's shapes
    and scales; the draws themselves differ between the frameworks)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * scale).to(dtype)
