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

On a device mesh (dense and MoE stacks; ``Model`` builds a ``MeshPlan``
under ``sharding_context``, ``NO_PLAN`` outside one) the same blocks run
on each rank's blocks of the weights and caches: q/k/v and the MLP's
gate/up column-parallel, o and down row-parallel with an all-reduce
over the heads' (ff's) axis, weight dims cut along the rows' axis
(FSDP) gathered before use.  Every projection goes through
``lora.project_sharded`` and every reshard through ``collectives``,
which are ``lora.project`` and the identity under ``NO_PLAN``.  Attention runs on the rank's heads (dense up to
1,024 tokens, ``flash_attention`` past them) or, where the rule table
cuts the cache's sequence (``kv_seq``, no sliding window),
``attention_decode_seqsharded``.  Tables that move heads to the query
sequence (``q_seq``) are refused (a later slice of the mesh).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.models import collectives as col
from repro_torch.models import lora as lora_lib
from repro_torch.models import mamba2
from repro_torch.models.layers import (
    apply_rope, attention_blockwise, attention_decode, attention_decode_paged,
    attention_decode_seqsharded, attention_dense, attention_prefix_suffix,
    dense_init, rms_norm,
)
from repro_torch.models.moe import init_moe, moe_mlp
from repro_torch.models.sharding import _filter_spec, batch_spec, param_spec


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


# ------------------------------------------------------------- the mesh ---
_QUEUED = "queued for a later slice of the mesh (ROADMAP.md)"


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Where one call's tensors lie on the mesh, as axis tuples (empty:
    whole on every rank): ``rows`` the activations' rows (the batch),
    ``heads`` the attention's query heads, ``kv_batch`` / ``kv_seq`` /
    ``kv_heads`` the KV cache's dims.  Rows are whole up to 1,024 tokens
    a call (so decode keeps every weight block resident: its projections
    sum partial products, as the reference's ``moe_decode_shardmap``
    does at the same bound), cut along the rule table's batch axes past
    them (FSDP weight gathers)."""
    cfg: Any
    mesh: Any
    rules: Any
    rows: Tuple[str, ...]
    heads: Tuple[str, ...]
    kv_batch: Tuple[str, ...]
    kv_seq: Tuple[str, ...]
    kv_heads: Tuple[str, ...]

    def spec(self, path: str, shape) -> tuple:
        """The spec of the parameter at ``path`` (every dim whole outside
        a mesh)."""
        if self.mesh is None:
            return (None,) * len(shape)
        return param_spec(path, tuple(shape), self.cfg, self.mesh,
                          self.rules)

    def wspec(self, path: str, shape) -> tuple:
        """The spec of one layer's weight at ``blocks/<path>``."""
        return self.spec("blocks/" + path, (1,) + tuple(shape))[1:]


# outside a mesh: every tensor whole, every collective the identity
NO_PLAN = MeshPlan(None, None, None, (), (), (), (), ())


def mesh_plan(cfg: ModelConfig, mesh, rules, batch: int,
              tokens: int) -> MeshPlan:
    """The plan of a call of ``batch`` sequences, ``tokens`` in all.  The
    caches' sequence is taken to divide the ``kv_seq`` axes (``Model.
    init_caches`` refuses a length that does not)."""

    def cut(entry, dim):
        return col.axes_of(_filter_spec((entry,), mesh, (dim,))[0], mesh)

    if col.axes_of(rules.q_seq, mesh):
        raise NotImplementedError(
            f"{cfg.name}: a rule table that moves attention from the heads "
            f"to the query sequence (q_seq; {cfg.n_heads} heads on a "
            f"{mesh.shape} mesh): {_QUEUED}")
    spec = batch_spec("kv/0", (cfg.n_layers, batch, mesh.size,
                               cfg.n_kv_heads, cfg.head_dim), mesh, rules)
    kv_batch, kv_seq, kv_heads = (col.axes_of(e, mesh) for e in spec[1:4])
    if kv_seq and (cfg.sliding_window > 0 or kv_heads):
        raise NotImplementedError(
            f"{cfg.name}: a cache cut along its sequence with a sliding-"
            f"window ring or with its heads cut too: {_QUEUED}")
    rows = () if tokens <= 1024 else cut(rules.batch, batch)
    heads = cut(rules.heads, cfg.n_heads)
    tp = set(heads) | set(kv_seq) | set(kv_heads)
    for name in ("ff", "vocab", "experts", "expert_ff"):
        tp |= set(col.axes_of(getattr(rules, name), mesh))
    if tp & (set(rows) | set(kv_batch)):
        raise NotImplementedError(
            f"{cfg.name}: rows cut along an axis that also cuts heads, "
            f"ff, vocab or experts ({rules}): {_QUEUED}")
    return MeshPlan(cfg, mesh, rules, rows, heads, kv_batch, kv_seq,
                    kv_heads)


def _psum_many(ys, axes):
    """``lora.psum_rounded`` of projections that share their rows, in one
    all-reduce."""
    if not col.axes_of(axes):
        return ys
    return [y.to(ys[0].dtype) for y in col.psum_many(
        [y.float() for y in ys], axes)]


def _kv_for_heads(t: torch.Tensor, have, plan: MeshPlan) -> torch.Tensor:
    """The KV heads ``[..., Hkv_l, Dh]`` (cut along ``have``) that this
    rank's query heads read."""
    if have == plan.heads:
        return t
    if have:
        raise NotImplementedError(
            f"KV heads cut along {have}, query heads along {plan.heads}: "
            f"{_QUEUED}")
    cfg = plan.cfg
    hq_l = cfg.n_heads // col.axis_size(plan.heads)
    g = cfg.n_heads // cfg.n_kv_heads
    if hq_l % g and g % hq_l:
        raise NotImplementedError(
            f"{hq_l} query heads a rank in groups of {g}: {_QUEUED}")
    first = col.axis_index(plan.heads) * hq_l // g
    return t[:, :, first:first + max(1, hq_l // g)]


def _kv_attn_axes(cfg: ModelConfig, plan: MeshPlan):
    """The cut of the K/V heads a prefill computes: the query heads' axis
    where the KV heads divide it, else whole."""
    n = col.axis_size(plan.heads)
    return plan.heads if cfg.n_kv_heads % n == 0 else ()


# ------------------------------------------------------------- attention ---
def _proj_qkv(p, x, cfg: ModelConfig, lora, adapter_idx=None,
              plan: MeshPlan = NO_PLAN, q_want=(), kv_want=()):
    """q/k/v [B, S, heads, Dh], column-parallel on a mesh: the heads cut
    along ``q_want`` (q) or ``kv_want`` (k, v).  The three partial sums
    meet in one all-reduce, and where all three are gathered whole, in
    one all-gather."""
    hd = cfg.head_dim
    ys, y_axes = [], []
    for name, n in (("q", cfg.n_heads), ("k", cfg.n_kv_heads),
                    ("v", cfg.n_kv_heads)):
        y, k_rest, y_ax = lora_lib.project_sharded(
            x, p["w" + name], plan.wspec(f"attn/w{name}", (cfg.d_model,
                                                            n * hd)),
            lora.get(name) if lora else None, cfg.lora.scaling,
            rows=plan.rows, reduce=False, adapter_idx=adapter_idx)
        ys.append(y)
        y_axes.append((k_rest, y_ax))
    if len(set(y_axes)) == 1:
        ys = _psum_many(ys, y_axes[0][0])
    else:
        ys = [lora_lib.psum_rounded(y, k) for y, (k, _) in zip(ys, y_axes)]
    out = []
    for y, (_, y_ax), name, n in zip(ys, y_axes, "qkv",
                                     (cfg.n_heads, cfg.n_kv_heads,
                                      cfg.n_kv_heads)):
        if "b" + name in p:             # bias after the LoRA bypass
            bias_have = plan.wspec(f"attn/b{name}", (n * hd,))
            y = y + col.reshard_dim(p["b" + name], 0, bias_have[0], y_ax)
        out.append(y)
    wants = (q_want, kv_want, kv_want)
    if all(ax for _, ax in y_axes) and not any(wants) \
            and len(set(y_axes)) == 1:
        out = col.gather_last_many(out, y_axes[0][1])
    else:
        out = [col.reshard_dim(y, -1, ax, w)
               for y, (_, ax), w in zip(out, y_axes, wants)]
    q, k, v = (y.reshape(x.shape[0], x.shape[1], -1, hd) for y in out)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _out_proj(p, o, cfg: ModelConfig, lora, adapter_idx=None,
              plan: MeshPlan = NO_PLAN, o_axes=()):
    """o [B, S, H * Dh] (on a mesh: heads cut along ``o_axes``) @ wo,
    row-parallel; the result whole on every rank of its rows."""
    y, y_ax = lora_lib.project_sharded(
        o, p["wo"], plan.wspec("attn/wo", (cfg.n_heads * cfg.head_dim,
                                           cfg.d_model)),
        lora.get("o") if lora else None, cfg.lora.scaling, x_axes=o_axes,
        rows=plan.rows, adapter_idx=adapter_idx)
    return col.reshard_dim(y, -1, y_ax, ())


def use_dense_prefill(cfg: ModelConfig, s: int) -> bool:
    """Whether full-sequence attention at length ``s`` takes the dense
    (full score matrix) path — the JAX package's rule."""
    return cfg.attn_impl == "dense" or (
        cfg.attn_impl == "auto" and s * s <= 1024 * 1024
        and not cfg.unroll_attn_blocks)


def attn_full(p, x, cfg: ModelConfig, rope_cs, lora=None,
              block_kv: int = 512, skip_masked_blocks: bool = False,
              adapter_idx=None, plan: MeshPlan = NO_PLAN
              ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention (training / prefill): the dense path up
    to ``s*s <= 1M`` (``use_dense_prefill``), the blockwise online
    softmax past it (on the card, the ``flash_attention`` kernels).
    Returns (out, (k, v)) so prefill can stash the KV cache.  On a mesh
    x holds the rows ``plan.rows`` keeps and attention runs on this
    rank's heads over its cache rows; (k, v) come in the cache's batch
    and head cut, every position."""
    kv_ax = _kv_attn_axes(cfg, plan)
    q, k, v = _proj_qkv(p, x, cfg, lora, adapter_idx, plan, plan.heads,
                        kv_ax)
    if rope_cs is not None:
        cos, sin = rope_cs
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    q, k, v = (col.reshard_dim(t, 0, plan.rows, plan.kv_batch)
               for t in (q, k, v))
    kq, vq = _kv_for_heads(k, kv_ax, plan), _kv_for_heads(v, kv_ax, plan)
    causal = not cfg.encoder_only
    s = x.shape[1]
    if use_dense_prefill(cfg, s):
        o = attention_dense(q, kq, vq, causal=causal,
                            window=cfg.sliding_window)
    else:
        o = attention_blockwise(q, kq, vq, causal=causal,
                                window=cfg.sliding_window,
                                block_kv=block_kv,
                                skip_masked_blocks=skip_masked_blocks
                                and causal)
    o = col.reshard_dim(o.reshape(o.shape[0], s, -1), 0, plan.kv_batch,
                        plan.rows)
    out = _out_proj(p, o, cfg, lora, adapter_idx, plan, plan.heads)
    return out, tuple(col.reshard_dim(t, 2, kv_ax, plan.kv_heads)
                      for t in (k, v))


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
                adapter_idx=None, plan: MeshPlan = NO_PLAN):
    """One-token attention against a contiguous KV cache, ragged slots.

    cache_kv: (k_cache, v_cache) [B,S,Hkv,Dh]; pos: [B] int per-sequence
    positions of the new token.  Sliding-window archs keep a ring buffer
    of window size (writes wrap at S).  The new K/V are written into the
    caches in place.  Returns (out, caches).

    On a mesh x and pos hold the rows ``plan.rows`` keeps and the caches
    are this rank's block.  Where the cache's sequence is cut
    (``plan.kv_seq``) every rank takes all heads through
    ``attention_decode_seqsharded`` (the reference's ``use_sharded``);
    otherwise its own heads through the paged kernel."""
    k_cache, v_cache = cache_kv
    seq = bool(plan.kv_seq)
    q, k, v = _proj_qkv(p, x, cfg, lora, adapter_idx, plan,
                        () if seq else plan.heads,
                        () if seq else plan.kv_heads)
    if rope_cs is not None:
        cos, sin = rope_cs  # [B, 1, Dh/2]
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    q, k, v, pos = (col.reshard_dim(t, 0, plan.rows, plan.kv_batch)
                    for t in (q, k, v, pos))
    if seq:
        o, _ = attention_decode_seqsharded(q, k, v, k_cache, v_cache, pos,
                                           plan.kv_seq)
    else:
        cache_len = k_cache.shape[1]
        wpos = torch.remainder(pos, cache_len) if cfg.sliding_window > 0 \
            else pos
        rows = torch.arange(q.shape[0], device=q.device)
        wpos = wpos.long()
        k_cache[rows, wpos] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, wpos] = v[:, 0].to(v_cache.dtype)
        kv_len = torch.clamp(pos + 1, max=cache_len)
        o = attention_decode(q, _kv_for_heads(k_cache, plan.kv_heads, plan),
                             _kv_for_heads(v_cache, plan.kv_heads, plan),
                             kv_len)
    o = col.reshard_dim(o.reshape(o.shape[0], 1, -1), 0, plan.kv_batch,
                        plan.rows)
    return _out_proj(p, o, cfg, lora, adapter_idx, plan,
                     () if seq else plan.heads), (k_cache, v_cache)


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
def _mlp_out(bp, h, cfg: ModelConfig, lora, adapter_idx=None,
             plan: MeshPlan = NO_PLAN):
    """(MLP or MoE output, the MoE's aux loss; None for an MLP, which
    makes no aux tensor).  On a mesh gate/up are column-parallel over
    ff and down row-parallel; an MoE layer takes ``moe_mlp``'s mesh path
    on every row."""
    if "moe" in bp:
        y, aux = moe_mlp(bp["moe"], col.all_gather(h, plan.rows, 0), cfg)
        return col.local_slice(y, plan.rows, 0), aux
    sc = cfg.lora.scaling
    mlp = bp["mlp"]
    d, f = cfg.d_model, cfg.d_ff
    g, k_g, g_ax = lora_lib.project_sharded(
        h, mlp["wg"], plan.wspec("mlp/wg", (d, f)),
        lora.get("gate") if lora else None, sc, rows=plan.rows,
        reduce=False, adapter_idx=adapter_idx)
    u, k_u, u_ax = lora_lib.project_sharded(
        h, mlp["wu"], plan.wspec("mlp/wu", (d, f)),
        lora.get("up") if lora else None, sc, rows=plan.rows, reduce=False,
        adapter_idx=adapter_idx)
    if k_g == k_u:                      # both partial sums in one
        g, u = _psum_many([g, u], k_g)
    else:
        g, u = lora_lib.psum_rounded(g, k_g), lora_lib.psum_rounded(u, k_u)
    hidden = F.silu(g) * col.reshard_dim(u, -1, u_ax, g_ax)
    y, y_ax = lora_lib.project_sharded(
        hidden, mlp["wd"], plan.wspec("mlp/wd", (f, d)),
        lora.get("down") if lora else None, sc, x_axes=g_ax, rows=plan.rows,
        adapter_idx=adapter_idx)
    return col.reshard_dim(y, -1, y_ax, ()), None


def block_full(bp, x, cfg: ModelConfig, rope_cs, lora=None,
               block_kv: int = 512, skip_masked_blocks: bool = False,
               adapter_idx=None, plan: MeshPlan = NO_PLAN):
    """Full-sequence block (prefill, training).  Returns (x, (k, v), aux),
    or for an SSM layer (x, {"conv", "state"}, aux): the conv tail and
    final state prefill hands to decode; a hybrid layer (x, {"kv": (k,
    v), "ssm": {"conv", "state"}}, aux).  ``aux`` is an MoE layer's
    load-balancing loss (float32 scalar), None for every other layer.
    ``plan``: the mesh's (attention-only stacks)."""
    h = rms_norm(x, bp["ln1"])
    if cfg.family is Family.SSM:
        y, ssm_cache = mamba2.ssm_mixer(bp["ssm"], h, cfg, lora=lora)
        return x + y, ssm_cache, None
    attn_out, kv = attn_full(bp["attn"], h, cfg, rope_cs, lora=lora,
                             block_kv=block_kv,
                             skip_masked_blocks=skip_masked_blocks,
                             adapter_idx=adapter_idx, plan=plan)
    cache = kv
    if cfg.family is Family.HYBRID:
        ssm_out, ssm_cache = mamba2.ssm_mixer(bp["ssm"], h, cfg, lora=lora)
        attn_out = 0.5 * (attn_out + ssm_out)
        cache = {"kv": kv, "ssm": ssm_cache}
    x = x + attn_out
    aux = None
    if cfg.d_ff > 0:
        y, aux = _mlp_out(bp, rms_norm(x, bp["ln2"]), cfg, lora, adapter_idx,
                          plan)
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
                 adapter_idx=None, plan: MeshPlan = NO_PLAN):
    """One-token block.  caches: {"kv": (k, v)} of this layer, an SSM
    layer's {"ssm": {"conv", "state"}}, or a hybrid layer's both
    (updated in place).  ``plan``: the mesh's (attention-only stacks).
    Returns (x, caches)."""
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
                              lora=lora, adapter_idx=adapter_idx, plan=plan)
    if cfg.family is Family.HYBRID:
        attn_out = 0.5 * (attn_out + ssm_step())
    x = x + attn_out
    if cfg.d_ff > 0:
        x = x + _mlp_out(bp, rms_norm(x, bp["ln2"]), cfg, lora,
                         adapter_idx, plan)[0]  # the aux is dropped
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
