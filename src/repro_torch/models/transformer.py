"""Blocks of the port — the counterparts of ``repro.models.transformer``
for the dense family, the encoder-only family (hubert), the MoE family,
the attention-free SSM family (Mamba2), the hybrid (hymba: attention and
a Mamba2 mixer side by side) and the VLM (llama-3.2-vision):

  dense:  x += attn(norm1(x)); x += mlp(norm2(x))
  encoder: the dense block with non-causal attention (full-sequence
          only: the family has no decode)
  MoE:    x += attn(norm1(x)); x += moe_mlp(norm2(x)), the experts
          plain batched products (``models/moe.py``); ``block_full``
          returns the layer's load-balancing aux loss, the suffix and
          decode blocks drop it, as the reference's do
  SSM:    x += ssm_mixer(norm1(x))
  hybrid: x += 0.5 * (attn(norm1(x)) + ssm_mixer(norm1(x)));
          x += mlp(norm2(x))
  VLM:    units of (cross_attn_every - 1) dense blocks and one
          cross-attention block over the request's vision tokens:
          x += tanh(gate_attn) * cross_attn(norm1(x));
          x += tanh(gate_mlp) * mlp(norm2(x))

Block params are one layer's slice of the stacked ``[L, ...]`` tree.
Every projection of a dense or SSM block goes through ``lora.project``:
an adapter-bearing one is one fused ``lora_matmul`` kernel call, the
others a plain product.  Cross blocks carry no adapter and no RoPE;
their gates are float32 scalars, zero at init (every cross block starts
as the identity, as in JAX).  A one-token cross-attention (decode) runs
the ``decode_attention`` kernel over the vision K/V.
With ``adapter_idx`` [B] (multi-tenant serving), ``lora`` is one layer's
slot stack and each adapter projection is one ``segmented_lora_matmul``
call over every sequence's own slot.
Decode writes the new token's K/V (an SSM layer: its conv tail and
state; a hybrid layer: both) into the caller's cache tensors IN PLACE
(the JAX blocks return new caches); the returned caches are the same
tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import lora as lora_lib
from repro_torch.models import mamba2
from repro_torch.models.layers import (
    apply_rope, attention_blockwise, attention_decode, attention_decode_paged,
    attention_dense, attention_prefix_suffix, dense_init, rms_norm,
)
from repro_torch.models.moe import init_moe, moe_mlp


# a cross block's leaves the JAX init makes float32 whatever the params'
# dtype (``convert.py`` keeps them so)
CROSS_FLOAT32_LEAVES = ("gate_attn", "gate_mlp")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# --------------------------------------------------------------- params ----
def init_attn(gen: torch.Generator, cfg: ModelConfig,
              cross: bool = False) -> Dict:
    """q/k/v/o projections (plus the config's QKV bias and q/k norms,
    which a cross-attention block does not take)."""
    d, h = cfg.d_model, cfg.head_dim
    dtype = _dtype(cfg.param_dtype)
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * h, dtype),
        "wk": dense_init(gen, d, cfg.n_kv_heads * h, dtype),
        "wv": dense_init(gen, d, cfg.n_kv_heads * h, dtype),
        "wo": dense_init(gen, cfg.n_heads * h, d, dtype,
                         scale=1.0 / math.sqrt(cfg.n_heads * h)),
    }
    dev = gen.device
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((cfg.n_heads * h,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads * h,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads * h,), dtype=dtype, device=dev)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((h,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((h,), dtype=dtype, device=dev)
    return p


def init_mlp(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    dtype = _dtype(cfg.param_dtype)
    return {"wg": dense_init(gen, d, f, dtype),
            "wu": dense_init(gen, d, f, dtype),
            "wd": dense_init(gen, f, d, dtype)}


def init_block(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    dtype = _dtype(cfg.param_dtype)
    dev = gen.device
    p: Dict[str, Any] = {"ln1": torch.ones((cfg.d_model,), dtype=dtype,
                                           device=dev)}
    if cfg.family is Family.SSM:
        p["ssm"] = mamba2.init_ssm(gen, cfg)
        return p
    p["attn"] = init_attn(gen, cfg)
    if cfg.family is Family.HYBRID:
        p["ssm"] = mamba2.init_ssm(gen, cfg)
    if cfg.d_ff > 0:
        p["ln2"] = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
        if cfg.family is Family.MOE:
            p["moe"] = init_moe(gen, cfg)
        else:
            p["mlp"] = init_mlp(gen, cfg)
    return p


def init_cross_block(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """Cross-attention block (VLM): gated cross-attention + MLP, both
    gates float32 zeros."""
    dtype = _dtype(cfg.param_dtype)
    dev = gen.device
    ones = torch.ones((cfg.d_model,), dtype=dtype, device=dev)
    return {
        "ln1": ones,
        "attn": init_attn(gen, cfg, cross=True),
        "gate_attn": torch.zeros((), dtype=torch.float32, device=dev),
        "ln2": ones.clone(),
        "mlp": init_mlp(gen, cfg),
        "gate_mlp": torch.zeros((), dtype=torch.float32, device=dev),
    }


# ------------------------------------------------------------- attention ---
def _proj_qkv(p, x, cfg: ModelConfig, lora, adapter_idx=None):
    sc = cfg.lora.scaling
    q = lora_lib.project(x, p["wq"], lora.get("q") if lora else None, sc,
                         adapter_idx)
    k = lora_lib.project(x, p["wk"], lora.get("k") if lora else None, sc,
                         adapter_idx)
    v = lora_lib.project(x, p["wv"], lora.get("v") if lora else None, sc,
                         adapter_idx)
    if "bq" in p:                      # bias after the LoRA bypass
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    b, s = x.shape[0], x.shape[1]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _out_proj(p, o, cfg: ModelConfig, lora, adapter_idx=None):
    return lora_lib.project(o, p["wo"], lora.get("o") if lora else None,
                            cfg.lora.scaling, adapter_idx)


def use_dense_prefill(cfg: ModelConfig, s: int) -> bool:
    """Whether full-sequence attention at length ``s`` takes the dense
    (full score matrix) path — the JAX package's rule."""
    return cfg.attn_impl == "dense" or (
        cfg.attn_impl == "auto" and s * s <= 1024 * 1024
        and not cfg.unroll_attn_blocks)


def attn_full(p, x, cfg: ModelConfig, rope_cs, lora=None,
              block_kv: int = 512, skip_masked_blocks: bool = False,
              adapter_idx=None
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (training / prefill): the dense path up
    to ``s*s <= 1M`` (``use_dense_prefill``), the blockwise online
    softmax past it (on the card, the ``flash_attention`` kernels).
    Returns (out, (k, v)) so prefill can stash the KV cache."""
    q, k, v = _proj_qkv(p, x, cfg, lora, adapter_idx)
    if rope_cs is not None:
        cos, sin = rope_cs
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    causal = not cfg.encoder_only
    s = x.shape[1]
    if use_dense_prefill(cfg, s):
        o = attention_dense(q, k, v, causal=causal,
                            window=cfg.sliding_window)
    else:
        o = attention_blockwise(q, k, v, causal=causal,
                                window=cfg.sliding_window,
                                block_kv=block_kv,
                                skip_masked_blocks=skip_masked_blocks
                                and causal)
    o = o.reshape(x.shape[0], s, cfg.n_heads * cfg.head_dim)
    return _out_proj(p, o, cfg, lora, adapter_idx), (k, v)


def attn_prefill_suffix(p, x, cfg: ModelConfig, prefix_kv, prefix_len,
                        rope_cs, lora=None, adapter_idx=None):
    """Ragged suffix-prefill attention for one layer: the queries are the
    uncached suffix tokens (absolute positions ``prefix_len + i``, RoPE
    tables per row), the keys the cached prefix K/V ``prefix_kv`` (each
    ``[B, Pp, Hkv, Dh]``, gathered from the cache) plus the suffix's
    own.  Always the dense formulation (``use_dense_prefill`` gates the
    features that call it).  Returns (out, (k_suf, v_suf)) for the
    runtime to write into the suffix's cache rows."""
    q, k, v = _proj_qkv(p, x, cfg, lora, adapter_idx)
    if rope_cs is not None:
        cos, sin = rope_cs
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    k_pre, v_pre = prefix_kv
    o = attention_prefix_suffix(q, k_pre, v_pre, k, v, prefix_len,
                                window=cfg.sliding_window)
    o = o.reshape(x.shape[0], x.shape[1], cfg.n_heads * cfg.head_dim)
    return _out_proj(p, o, cfg, lora, adapter_idx), (k, v)


def attn_decode(p, x, cfg: ModelConfig, cache_kv, pos, rope_cs, lora=None,
                adapter_idx=None):
    """One-token attention against a contiguous KV cache, ragged slots.

    cache_kv: (k_cache, v_cache) [B,S,Hkv,Dh]; pos: [B] int per-sequence
    positions of the new token.  Sliding-window archs keep a ring buffer
    of window size (writes wrap at S).  The new K/V are written into the
    caches in place.  Returns (out, caches)."""
    k_cache, v_cache = cache_kv
    cache_len = k_cache.shape[1]
    q, k, v = _proj_qkv(p, x, cfg, lora, adapter_idx)
    if rope_cs is not None:
        cos, sin = rope_cs  # [B, 1, Dh/2]
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    wpos = torch.remainder(pos, cache_len) if cfg.sliding_window > 0 \
        else pos
    rows = torch.arange(x.shape[0], device=x.device)
    wpos = wpos.long()
    k_cache[rows, wpos] = k[:, 0].to(k_cache.dtype)
    v_cache[rows, wpos] = v[:, 0].to(v_cache.dtype)
    kv_len = torch.clamp(pos + 1, max=cache_len)
    o = attention_decode(q, k_cache, v_cache, kv_len)
    o = o.reshape(x.shape[0], 1, cfg.n_heads * cfg.head_dim)
    return _out_proj(p, o, cfg, lora, adapter_idx), (k_cache, v_cache)


def attn_decode_paged(p, x, cfg: ModelConfig, pool_kv, rope_cs,
                      block_tables, write_block, write_off, kv_len,
                      lora=None, adapter_idx=None):
    """One-token attention against one layer's paged KV block pool.

    pool_kv: (k_pool, v_pool) [n_blocks, block_size, Hkv, Dh];
    block_tables: [B, NB] int32; write_block/write_off: [B] pool block id
    and in-block offset of each sequence's new K/V; kv_len: [B] valid
    logical length AFTER the write.  The write lands in the pools in
    place, before the attention reads them (inactive slots all write
    scratch block 0, where the duplicate writes are harmless).  Returns
    (out, pools)."""
    k_pool, v_pool = pool_kv
    q, k, v = _proj_qkv(p, x, cfg, lora, adapter_idx)
    if rope_cs is not None:
        cos, sin = rope_cs
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    k_pool[write_block, write_off] = k[:, 0].to(k_pool.dtype)
    v_pool[write_block, write_off] = v[:, 0].to(v_pool.dtype)
    o = attention_decode_paged(q, k_pool, v_pool, block_tables, kv_len)
    o = o.reshape(x.shape[0], 1, cfg.n_heads * cfg.head_dim)
    return _out_proj(p, o, cfg, lora, adapter_idx), (k_pool, v_pool)


def vision_kv(p, vis: torch.Tensor, cfg: ModelConfig):
    """Project vision embeddings [B, T, d_model] to the cross K/V, each
    [B, T, Hkv, Dh]: once per request at prefill, cached for decode."""
    b, t = vis.shape[0], vis.shape[1]
    k = (vis @ p["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = (vis @ p["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    return k, v


def cross_attn(p, x, vkv, cfg: ModelConfig, kv_len=None):
    """Cross-attention over the vision K/V ``vkv`` (no RoPE, no cache
    write: vision tokens are static per request).  One query per
    sequence (decode) runs ``decode_attention`` over the head-major
    views of the K/V, with ``kv_len`` [B] int32 (default: all T valid);
    longer queries (prefill) the dense non-causal attention, as JAX runs
    every length."""
    b, s = x.shape[0], x.shape[1]
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k, v = vkv
    if s == 1:
        if kv_len is None:
            kv_len = torch.full((b,), k.shape[1], dtype=torch.int32,
                                device=k.device)
        o = decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                             kv_len)[:, None]
    else:
        o = attention_dense(q, k, v, causal=False)
    return o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]


# ----------------------------------------------------------------- blocks --
def _mlp_out(bp, h, cfg: ModelConfig, lora, adapter_idx=None):
    """(MLP or MoE output, the MoE's aux loss; None for an MLP, which
    makes no aux tensor)."""
    if "moe" in bp:
        return moe_mlp(bp["moe"], h, cfg)
    sc = cfg.lora.scaling
    mlp = bp["mlp"]
    g = lora_lib.project(h, mlp["wg"], lora.get("gate") if lora else None,
                         sc, adapter_idx)
    u = lora_lib.project(h, mlp["wu"], lora.get("up") if lora else None, sc,
                         adapter_idx)
    hidden = F.silu(g) * u
    return lora_lib.project(hidden, mlp["wd"],
                            lora.get("down") if lora else None, sc,
                            adapter_idx), None


def block_full(bp, x, cfg: ModelConfig, rope_cs, lora=None,
               block_kv: int = 512, skip_masked_blocks: bool = False,
               adapter_idx=None):
    """Full-sequence block (prefill, training).  Returns (x, (k, v), aux),
    or for an SSM layer (x, {"conv", "state"}, aux): the conv tail and
    final state prefill hands to decode; a hybrid layer (x, {"kv": (k,
    v), "ssm": {"conv", "state"}}, aux).  ``aux`` is an MoE layer's
    load-balancing loss (float32 scalar), None for every other layer."""
    h = rms_norm(x, bp["ln1"])
    if cfg.family is Family.SSM:
        y, ssm_cache = mamba2.ssm_mixer(bp["ssm"], h, cfg, lora=lora)
        return x + y, ssm_cache, None
    attn_out, kv = attn_full(bp["attn"], h, cfg, rope_cs, lora=lora,
                             block_kv=block_kv,
                             skip_masked_blocks=skip_masked_blocks,
                             adapter_idx=adapter_idx)
    cache = kv
    if cfg.family is Family.HYBRID:
        ssm_out, ssm_cache = mamba2.ssm_mixer(bp["ssm"], h, cfg, lora=lora)
        attn_out = 0.5 * (attn_out + ssm_out)
        cache = {"kv": kv, "ssm": ssm_cache}
    x = x + attn_out
    aux = None
    if cfg.d_ff > 0:
        y, aux = _mlp_out(bp, rms_norm(x, bp["ln2"]), cfg, lora, adapter_idx)
        x = x + y
    return x, cache, aux


def block_prefill_suffix(bp, x, cfg: ModelConfig, prefix_kv, prefix_len,
                         rope_cs, lora=None, adapter_idx=None):
    """Suffix-prefill block (attention-only stacks): the prefix caching
    and chunked prefill programs.  Returns (x, (k_suf, v_suf))."""
    attn_out, kv = attn_prefill_suffix(bp["attn"], rms_norm(x, bp["ln1"]),
                                       cfg, prefix_kv, prefix_len, rope_cs,
                                       lora=lora, adapter_idx=adapter_idx)
    x = x + attn_out
    if cfg.d_ff > 0:
        x = x + _mlp_out(bp, rms_norm(x, bp["ln2"]), cfg, lora,
                         adapter_idx)[0]       # the aux is dropped
    return x, kv


def block_decode(bp, x, cfg: ModelConfig, caches, pos, rope_cs, lora=None,
                 adapter_idx=None):
    """One-token block.  caches: {"kv": (k, v)} of this layer, an SSM
    layer's {"ssm": {"conv", "state"}}, or a hybrid layer's both
    (updated in place).  Returns (x, caches)."""
    h = rms_norm(x, bp["ln1"])

    def ssm_step():
        ssm = caches["ssm"]
        y, new = mamba2.ssm_mixer(bp["ssm"], h, cfg, cache=ssm, lora=lora)
        ssm["conv"].copy_(new["conv"])
        ssm["state"].copy_(new["state"])
        return y

    if cfg.family is Family.SSM:
        return x + ssm_step(), caches
    attn_out, _ = attn_decode(bp["attn"], h, cfg, caches["kv"], pos, rope_cs,
                              lora=lora, adapter_idx=adapter_idx)
    if cfg.family is Family.HYBRID:
        attn_out = 0.5 * (attn_out + ssm_step())
    x = x + attn_out
    if cfg.d_ff > 0:
        x = x + _mlp_out(bp, rms_norm(x, bp["ln2"]), cfg, lora,
                         adapter_idx)[0]       # the aux is dropped
    return x, caches


def block_decode_paged(bp, x, cfg: ModelConfig, pool_kv, rope_cs,
                       block_tables, write_block, write_off, kv_len,
                       lora=None, adapter_idx=None):
    """One-token block against one layer's paged KV pool (updated in
    place).  Returns (x, pools)."""
    attn_out, pool_kv = attn_decode_paged(
        bp["attn"], rms_norm(x, bp["ln1"]), cfg, pool_kv, rope_cs,
        block_tables, write_block, write_off, kv_len, lora=lora,
        adapter_idx=adapter_idx)
    x = x + attn_out
    if cfg.d_ff > 0:
        x = x + _mlp_out(bp, rms_norm(x, bp["ln2"]), cfg, lora,
                         adapter_idx)[0]       # the aux is dropped
    return x, pool_kv


def cross_block(cp, x, vkv, cfg: ModelConfig, kv_len=None):
    """The VLM's gated cross-attention block; ``kv_len`` reaches the
    decode kernel (``cross_attn``)."""
    ga = torch.tanh(cp["gate_attn"]).to(x.dtype)   # f32 gate, carry dtype
    x = x + ga * cross_attn(cp["attn"], rms_norm(x, cp["ln1"]), vkv, cfg,
                            kv_len)
    y, _ = _mlp_out(cp, rms_norm(x, cp["ln2"]), cfg, None)
    return x + torch.tanh(cp["gate_mlp"]).to(x.dtype) * y
