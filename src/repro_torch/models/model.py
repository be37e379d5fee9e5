"""The port's model: one ``Model`` per (ModelConfig, device) with the
serving surface of ``repro.models.model.Model`` for the dense family,
the MoE family (moonshot, grok-1), the attention-free SSM family
(Mamba2), the hybrid (hymba), the encoder-only family (hubert) and the
VLM (llama-3.2-vision):

  init(generator) -> params              init_lora(generator) -> adapters
  forward_loss(params, lora, batch)      (training objective), logits
  prefill_ragged(params, lora, batch, prompt_lens) -> (logits, caches)
  prefill(params, lora, batch)           exact length (SSM stacks)
  decode_step / decode_step_paged        (one token per sequence)

The serving methods take ``adapter_idx`` [B] int32: ``lora`` is then a
stacked multi-tenant tree (leaves ``[L, A, din, r]``) and each sequence
applies its own slot (< 0: the base model alone).
  init_caches / init_paged_caches        write_prefill_slots / _blocks
  write_prefill_slot                     one request's row (SSM waves)
  prefill_ragged_suffix / _continue      a suffix (or chunk) over a cached
                                         prefix: paged / contiguous
  write_prefill_rows, copy_blocks        a chunk's rows; copy-on-write

An SSM stack's caches are ``{"ssm": {"conv", "state"}}`` per slot (the
conv tail and the SSD state, fixed size whatever the prompt); a hybrid
stack's add ``{"kv": (k, v)}``, a ring of ``min(seq, window)`` rows per
slot; the ragged prefill and the paged layout are attention-only, as in
JAX.

A VLM stack is ``units`` of ``per`` dense blocks and one cross block
(``cross_attn_every = per + 1``): ``params["blocks"]`` ``[units, per,
...]``, ``params["cross"]`` ``[units, ...]``, the LoRA tree ``[units,
per, ...]``; its batches carry ``batch["vision"]`` [B, T, d_model] (the
stub frontend's patch embeddings) and its caches add ``cross_kv``, the
vision K/V of each unit ``[units, B, T, Hkv, Dh]``, made at prefill and
read by every decode step.  As in JAX, a VLM stack has no paged caches
and no cache-slot writes (the caller copies a prefill's caches into its
decode caches), and its decode serves one adapter.

An encoder stack (``cfg.encoder_only``) reads ``batch["embeds"]`` [B, S,
d_model] (the stub audio frontend's frame embeddings, cast to
``cfg.dtype``) in place of token embeddings when the batch carries them,
attends non-causally, and serves through ``hidden_states`` / ``logits``
(``Engine.encoder_serve_step``) and trains through ``forward_loss``.
It has no decode: the cache, prefill and decode methods raise.

On a device mesh (``models/sharding.py::sharding_context``; dense and MoE
stacks, serving only) each rank holds its blocks of the params
(``init_sharded``, or ``launch.mesh.shard_tree``) and caches
(``init_caches``, local shapes), while ``prefill_ragged`` and
``decode_step`` take every sequence's tokens and positions and return
every sequence's full-vocab logits on every rank: the embedding and the
head are vocab-parallel (a masked lookup and an all-reduce; a product
and an all-gather).  Training, the paged and suffix programs,
multi-tenant decode and the SSM, hybrid, VLM and encoder stacks raise
``NotImplementedError`` there (later slices of the mesh).

Params are nested dicts of tensors in the JAX layout (stacked ``[L, ...]``
block leaves, ``[in, out]`` matrices), so ``convert.py`` loads a JAX tree
leaf for leaf.  The layer stack is a Python loop over per-layer views of
the stacked leaves.  Cache writes land in the caller's cache tensors in
place (the JAX methods return new trees); the returned caches are the
same tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import Family, ModelConfig
from repro_torch.models import collectives as col
from repro_torch.models import lora as lora_lib
from repro_torch.models import mamba2
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import dense_init, rms_norm, rope_tables
from repro_torch.models.sharding import (
    MeshSharding, _leading, _map_paths, batch_spec, current_mesh,
    current_rules, param_spec,
)
from repro_torch.tree import tree_leaves, tree_map


# ------------------------------------------------------------------ loss ---
def _chunk_ce(h, head, y, m):
    logits = (h @ head).float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return ((logz - ll) * m).sum(), m.sum()


def chunked_ce_loss(hidden: torch.Tensor, head: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor,
                    chunk: int = 512) -> Tuple[torch.Tensor, Dict]:
    """Cross-entropy over a vocab head without keeping ``[B,S,V]`` f32
    logits alive: sequence chunks of ``chunk`` (plus the remainder), each
    under a non-reentrant ``torch.utils.checkpoint``, so its logits are
    freed after the forward and rematerialised in the backward (the JAX
    version scans chunks under ``jax.checkpoint``)."""
    s = hidden.shape[1]
    chunk = min(chunk, s)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, chunk):
        sl = slice(lo, min(lo + chunk, s))
        l_, c_ = checkpoint(_chunk_ce, hidden[:, sl], head, labels[:, sl],
                            mask[:, sl], use_reentrant=False)
        tot, cnt = tot + l_, cnt + c_
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss, {"loss_sum": tot, "token_count": cnt}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  Asking for CUDA on a machine
    without a usable card raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels")
    return dev


def _layer(tree, i: int):
    """Layer ``i``'s view of a stacked ``[L, ...]`` tree (None stays)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _draw_stacked(draw, lead: Tuple[int, ...], keep=None):
    """``prod(lead)`` trees from ``draw()``, in order, written into stacks
    of leading dims ``lead`` allocated once: the stacks and one layer's
    draw are alive together, never every layer's draw beside them.
    ``keep(path, leaf)``, where given, cuts each drawn leaf (at its path
    in the drawn tree) to what the stack holds."""
    cut = (lambda tree: _map_paths(keep, tree)) if keep else (lambda t: t)
    tree = cut(draw())
    out = tree_map(lambda t: torch.empty(lead + t.shape, dtype=t.dtype,
                                         device=t.device), tree)
    for i, idx in enumerate(np.ndindex(*lead)):
        if i:
            tree = cut(draw())
        tree_map(lambda dst, src: dst[idx].copy_(src), out, tree)
        tree = None                    # freed before the next draw
    return out


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _cache_leaves(caches) -> list:
    """A cache tree's tensors in order: K/V as its ``(k, v)`` pair, an
    SSM stack's ``{"conv", "state"}``."""
    return [t for v in caches.values()
            for t in (v if isinstance(v, tuple) else tree_leaves(v))]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    # --------------------------------------------------------------- init --
    def init(self, generator: torch.Generator, keep=None) -> Dict:
        """Random weights with the JAX initializer's shapes and scales,
        drawn from ``generator`` (which must live on ``self.device``).
        ``keep(path, leaf)`` (``init_sharded``) cuts each leaf as it is
        drawn, a stacked one layer by layer."""
        cfg = self.cfg
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        keep = keep or (lambda path, t: t)
        dtype = getattr(torch, cfg.param_dtype)
        params: Dict[str, Any] = {}
        params["embed"] = keep("embed", dense_init(
            generator, cfg.vocab_size, cfg.d_model, dtype, scale=1.0))
        if cfg.family is Family.VLM:
            units, per = self._vlm_shape()
            params["blocks"] = _draw_stacked(
                lambda: tfm.init_block(generator, cfg), (units, per),
                lambda path, t: keep("blocks/" + path, t))
            params["cross"] = _draw_stacked(
                lambda: tfm.init_cross_block(generator, cfg), (units,),
                lambda path, t: keep("cross/" + path, t))
        else:
            params["blocks"] = _draw_stacked(
                lambda: tfm.init_block(generator, cfg), (cfg.n_layers,),
                lambda path, t: keep("blocks/" + path, t))
        params["final_norm"] = keep("final_norm", torch.ones(
            (cfg.d_model,), dtype=dtype, device=generator.device))
        params["lm_head"] = keep("lm_head", dense_init(
            generator, cfg.d_model, cfg.vocab_size, dtype))
        return mamba2.pad_storage(params)

    def init_sharded(self, generator: torch.Generator, mesh,
                     rules) -> Dict:
        """This rank's blocks of ``init``'s weights on ``mesh`` under
        ``rules`` (as ``sharding.param_shardings`` cuts them): every
        leaf is drawn whole from ``generator``, as ``init`` draws it (so
        the blocks are those of the unsharded model from the same seed),
        cut, and the draw freed.  The ranks draw one after another, so
        one rank's whole layer is alive at a time."""
        import torch.distributed as dist

        cfg = self.cfg
        self._mesh_family("sharded weights")

        def keep(path, t):
            lead = _leading(path, cfg)     # the stacked dims, drawn apart
            spec = param_spec(path, (1,) * lead + tuple(t.shape), cfg, mesh,
                              rules)[lead:]
            for d, e in enumerate(spec):
                t = col.local_slice(t, e, d, mesh)
            return t.clone()

        params = None
        for r in range(mesh.size):
            if mesh.rank == r:
                params = self.init(generator, keep)
                if self.device.type == "cuda":
                    # the whole draws' blocks, cached by this process's
                    # allocator, back to the card for the next rank's
                    torch.cuda.empty_cache()
            dist.barrier()
        return params

    def init_lora(self, generator: torch.Generator) -> Dict:
        """One adapter, stacked ``[L, ...]`` (a VLM: ``[units, per, ...]``
        over its dense blocks; cross blocks take none)."""
        if self.cfg.family is Family.VLM:
            units, per = self._vlm_shape()
            tree = lora_lib.init_lora(generator, self.cfg, units * per)
            return tree_map(lambda t: t.reshape((units, per) + t.shape[1:]),
                            tree)
        return lora_lib.init_lora(generator, self.cfg, self.cfg.n_layers)

    def _vlm_shape(self) -> Tuple[int, int]:
        """(units, dense blocks per unit) of a VLM stack."""
        cfg = self.cfg
        return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1

    # ------------------------------------------------------------ forward --
    def _mesh_family(self, what: str) -> None:
        if self.cfg.family not in (Family.DENSE, Family.MOE):
            raise NotImplementedError(
                f"{self.cfg.name}: {what} of a {self.cfg.family.value} stack "
                f"on a mesh: {tfm._QUEUED}")

    def _no_mesh(self, what: str) -> None:
        if current_mesh() is not None:
            raise NotImplementedError(f"{self.cfg.name}: {what} on a mesh"
                                      f": {tfm._QUEUED}")

    def _mesh_plan(self, batch, adapter_idx=None) -> tfm.MeshPlan:
        """The ``MeshPlan`` of a call over ``batch["tokens"]`` under
        ``sharding_context``, ``NO_PLAN`` outside one."""
        mesh = current_mesh()
        if mesh is None:
            return tfm.NO_PLAN
        self._mesh_family("serving")
        if adapter_idx is not None:
            raise NotImplementedError(
                f"{self.cfg.name}: multi-tenant (per-row adapter) serving "
                f"on a mesh: {tfm._QUEUED}")
        tokens = batch["tokens"]
        return tfm.mesh_plan(self.cfg, mesh, current_rules(),
                             tokens.shape[0], tokens.numel())

    def _embed(self, params, batch, plan=tfm.NO_PLAN) -> torch.Tensor:
        """Token embeddings [B, S, D] (an encoder's ``embeds`` where the
        batch carries them).  On a mesh a vocab-parallel lookup of every
        sequence's tokens: each rank reads the rows of its vocab block
        (zeros elsewhere), the vocab ranks sum them, the ``w_embed``
        ranks' columns are gathered; the rows ``plan.rows`` keeps."""
        cfg = self.cfg
        if cfg.encoder_only and "embeds" in batch:
            return batch["embeds"].to(getattr(torch, cfg.dtype))
        tokens = batch["tokens"]
        v_ax, d_ax = (col.axes_of(e) for e in plan.spec(
            "embed", (cfg.vocab_size, cfg.d_model)))
        early = not set(d_ax) & set(plan.rows)
        if early:                  # the column gather stays within rows
            tokens = col.local_slice(tokens, plan.rows, 0)
        if v_ax:
            vl = cfg.vocab_size // col.axis_size(v_ax)
            idx = tokens.long() - col.axis_index(v_ax) * vl
            inside = (idx >= 0) & (idx < vl)
            e = params["embed"][idx.clamp(0, vl - 1)]
            e = col.psum(torch.where(inside[..., None], e,
                                     torch.zeros_like(e)), v_ax)
        else:
            e = params["embed"][tokens]
        e = col.all_gather(e, d_ax, -1)
        return e if early else col.local_slice(e, plan.rows, 0)

    def _head(self, params, hidden, plan=tfm.NO_PLAN) -> torch.Tensor:
        """Normed ``hidden`` [B, S, D] @ ``lm_head``.  On a mesh
        vocab-parallel: hidden holds the rows of ``plan.rows``, and every
        sequence's full-vocab logits [B, S, V] come out on every rank
        (the rows gathered, the contraction's partials summed over
        ``w_embed``'s axes, the vocab blocks gathered)."""
        cfg = self.cfg
        h = col.all_gather(hidden, plan.rows, 0)
        y, y_ax = lora_lib.project_sharded(
            h, params["lm_head"], plan.spec("lm_head", (cfg.d_model,
                                                        cfg.vocab_size)),
            None, 0.0)
        return col.all_gather(y, y_ax, -1)

    def _no_decode(self, what: str) -> None:
        if not self.cfg.has_decode:
            raise NotImplementedError(
                f"{self.cfg.name}: encoder-only, no {what} (it serves "
                "through Engine.encoder_serve_step)")

    def hidden_states(self, params, lora, batch, *,
                      collect_caches: bool = False, block_kv: int = 512,
                      skip_masked_blocks: bool = False, adapter_idx=None,
                      return_aux: bool = False):
        """Full-sequence forward.  Returns (hidden, caches | None) with
        caches ``{"kv": (k, v)}``, each ``[L, B, S, Hkv, Dh]``, or for an
        SSM stack ``{"ssm": {"conv": [L, B, W-1, C], "state": [L, B, H,
        P, N]}}``, or for a hybrid stack both; with ``return_aux``
        (hidden, caches, aux): the MoE layers' load-balancing losses
        summed over the layers, None for a stack without MoE layers.
        ``block_kv`` and ``skip_masked_blocks`` reach the blockwise
        attention of sequences past the dense limit; ``adapter_idx`` [B]
        selects each row's slot of a stacked ``lora`` tree.  On a mesh
        the hidden rows ``plan.rows`` keeps, and K/V ``[L, B_kv, S,
        Hkv_l, Dh]`` in the caches' batch and head cut, every
        position."""
        cfg = self.cfg
        plan = self._mesh_plan(batch, adapter_idx)
        x = self._embed(params, batch, plan)
        s = x.shape[1]
        rope_cs = rope_tables(torch.arange(s, device=x.device),
                              cfg.head_dim, cfg.rope_theta) \
            if cfg.has_attention else None
        if cfg.family is Family.VLM:
            out = self._vlm_hidden_states(
                params, lora, batch, x, rope_cs,
                collect_caches=collect_caches, block_kv=block_kv,
                skip_masked_blocks=skip_masked_blocks,
                adapter_idx=adapter_idx)
            return out + (None,) if return_aux else out
        per_layer = []
        aux = None
        for i in range(cfg.n_layers):
            x, cache, layer_aux = tfm.block_full(
                _layer(params["blocks"], i), x, cfg, rope_cs,
                lora=_layer(lora, i), block_kv=block_kv,
                skip_masked_blocks=skip_masked_blocks,
                adapter_idx=adapter_idx, plan=plan)
            if layer_aux is not None:
                aux = layer_aux if aux is None else aux + layer_aux
            if collect_caches:
                per_layer.append(cache)
        caches = None
        if collect_caches and cfg.family is Family.HYBRID:
            caches = {"kv": tuple(torch.stack(t) for t in zip(
                *(c["kv"] for c in per_layer))),
                "ssm": _stack([c["ssm"] for c in per_layer])}
        elif collect_caches and cfg.has_ssm:
            caches = {"ssm": _stack(per_layer)}
        elif collect_caches:
            caches = {"kv": tuple(torch.stack(t) for t in zip(*per_layer))}
        hidden = rms_norm(x, params["final_norm"])
        return (hidden, caches, aux) if return_aux else (hidden, caches)

    def _vlm_hidden_states(self, params, lora, batch, x, rope_cs, *,
                           collect_caches, block_kv, skip_masked_blocks,
                           adapter_idx):
        """The VLM's forward: each unit's dense blocks, then its cross
        block over the unit's projection of ``batch["vision"]`` (cast to
        the carry dtype).  Caches: ``kv`` ``[units, per, B, S, Hkv, Dh]``
        and ``cross_kv`` ``[units, B, T, Hkv, Dh]`` per K/V."""
        cfg = self.cfg
        vis = batch["vision"].to(x.dtype)
        units, per = self._vlm_shape()
        kvs, cross_kv = [], []
        for u in range(units):
            blocks, ulora = _layer(params["blocks"], u), _layer(lora, u)
            for j in range(per):
                x, kv, _ = tfm.block_full(
                    _layer(blocks, j), x, cfg, rope_cs,
                    lora=_layer(ulora, j), block_kv=block_kv,
                    skip_masked_blocks=skip_masked_blocks,
                    adapter_idx=adapter_idx)
                if collect_caches:
                    kvs.append(kv)
            cp = _layer(params["cross"], u)
            vkv = tfm.vision_kv(cp["attn"], vis, cfg)
            x = tfm.cross_block(cp, x, vkv, cfg)
            if collect_caches:
                cross_kv.append(vkv)
        caches = None
        if collect_caches:
            caches = {
                "kv": tuple(torch.stack(t).unflatten(0, (units, per))
                            for t in zip(*kvs)),
                "cross_kv": tuple(torch.stack(t) for t in zip(*cross_kv))}
        return rms_norm(x, params["final_norm"]), caches

    # --------------------------------------------------------------- loss --
    def forward_loss(self, params, lora, batch, *, ce_chunk: int = 512,
                     block_kv: int = 512, skip_masked_blocks: bool = False):
        """Training objective: chunked next-token CE plus 0.01 x the
        auxiliary loss (the MoE layers' load-balancing losses summed;
        zero for the other families).  Returns (total, metrics
        ``ce_loss``, ``aux_loss``, ``loss_sum``, ``token_count``)."""
        self._no_mesh("training (sequence-parallel activations, sharded "
                      "gradients and optimizer state)")
        hidden, _, aux = self.hidden_states(
            params, lora, batch, block_kv=block_kv,
            skip_masked_blocks=skip_masked_blocks, return_aux=True)
        loss, metrics = chunked_ce_loss(
            hidden, params["lm_head"], batch["labels"],
            batch["mask"].float(), chunk=ce_chunk)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
        metrics["aux_loss"] = aux
        metrics["ce_loss"] = loss
        return loss + 0.01 * aux, metrics

    def logits(self, params, lora, batch, *, block_kv: int = 512,
               skip_masked_blocks: bool = False) -> torch.Tensor:
        """Full-vocab logits for the whole sequence (small inputs only)."""
        hidden, _ = self.hidden_states(
            params, lora, batch, block_kv=block_kv,
            skip_masked_blocks=skip_masked_blocks)
        return self._head(params, hidden, self._mesh_plan(batch))

    # ------------------------------------------------------------- caches --
    def _cache_dtype(self, dtype) -> torch.dtype:
        return dtype or getattr(torch, self.cfg.kv_cache_dtype
                                or self.cfg.dtype)

    def init_caches(self, batch: int, seq: int, dtype=None) -> Dict:
        """Contiguous KV caches ``[L, batch, S, Hkv, Dh]`` per K/V
        (sliding-window archs keep a ring of window size); an SSM stack's
        ``{"ssm": {"conv", "state"}}`` instead (conv tail in the cache
        dtype, state float32, whatever ``seq``); a hybrid stack's both;
        a VLM's ``kv`` ``[units, per, batch, S, Hkv, Dh]`` and
        ``cross_kv`` ``[units, batch, T, Hkv, Dh]``."""
        cfg = self.cfg
        self._no_decode("decode caches")
        if current_mesh() is not None:
            return self._init_caches_mesh(batch, seq, dtype)
        if cfg.family is Family.VLM:
            units, per = self._vlm_shape()
            dt = self._cache_dtype(dtype)
            kv = (units, per, batch, seq, cfg.n_kv_heads, cfg.head_dim)
            cross = (units, batch, cfg.vision_tokens, cfg.n_kv_heads,
                     cfg.head_dim)
            return {"kv": tuple(torch.zeros(kv, dtype=dt, device=self.device)
                                for _ in range(2)),
                    "cross_kv": tuple(torch.zeros(cross, dtype=dt,
                                                  device=self.device)
                                      for _ in range(2))}
        dt = self._cache_dtype(dtype)
        caches: Dict[str, Any] = {}
        if cfg.has_attention:
            kv_seq = seq if cfg.sliding_window == 0 \
                else min(seq, cfg.sliding_window)
            shape = (cfg.n_layers, batch, kv_seq, cfg.n_kv_heads,
                     cfg.head_dim)
            caches["kv"] = (torch.zeros(shape, dtype=dt, device=self.device),
                            torch.zeros(shape, dtype=dt, device=self.device))
        if cfg.has_ssm:
            caches["ssm"] = mamba2.init_ssm_cache(
                cfg, batch, dt, self.device, stacked=cfg.n_layers)
        return caches

    def _init_caches_mesh(self, batch: int, seq: int, dtype) -> Dict:
        """This rank's blocks of the ``[L, batch, seq, Hkv, Dh]`` caches,
        cut as ``sharding.batch_shardings`` says; each K/V tensor
        carries the whole shape as ``mesh_whole``.  ``seq`` must divide
        the ``kv_seq`` axes (the layout of every later call rests on it)."""
        cfg = self.cfg
        self._mesh_family("decode caches")
        mesh, rules = current_mesh(), current_rules()
        n_seq = col.axis_size(rules.kv_seq)
        if cfg.sliding_window > 0 and n_seq > 1 or seq % n_seq:
            raise NotImplementedError(
                f"{cfg.name}: a cache of {seq} positions (window "
                f"{cfg.sliding_window}) on a kv_seq axis of {n_seq} "
                f"ranks: {tfm._QUEUED}")
        whole = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
        shape = MeshSharding(mesh, batch_spec("kv/0", whole, mesh, rules)) \
            .local_shape(whole)
        dt = self._cache_dtype(dtype)
        kv = tuple(torch.zeros(shape, dtype=dt, device=self.device)
                   for _ in range(2))
        for t in kv:
            t.mesh_whole = whole
        return {"kv": kv}

    def init_paged_caches(self, n_blocks: int, block_size: int,
                          dtype=None) -> Dict:
        """Global paged KV pool ``[L, n_blocks, block_size, Hkv, Dh]``
        per K/V; block 0 is the runtime's scratch block."""
        cfg = self.cfg
        self._no_mesh("the paged KV pool")
        self._no_decode("paged KV caches")
        self._attention_only("paged KV caches")
        self._no_vlm("paged KV caches")
        shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
                 cfg.head_dim)
        dt = self._cache_dtype(dtype)
        return {"kv": (torch.zeros(shape, dtype=dt, device=self.device),
                       torch.zeros(shape, dtype=dt, device=self.device))}

    def _no_vlm(self, what: str) -> None:
        if self.cfg.family is Family.VLM:
            raise NotImplementedError(
                f"{self.cfg.name}: {what} are not defined for a VLM stack "
                "(units-leading cache layout, per-request vision K/V), as "
                "in the reference; use prefill and decode_step")

    def _attention_only(self, what: str) -> None:
        if self.cfg.has_ssm:
            raise NotImplementedError(
                f"{self.cfg.name}: {what} need an attention-only stack (SSM "
                "state threads through pads and is per slot, not per "
                "block)")

    # -------------------------------------------------------------- prefill -
    def prefill(self, params, lora, batch):
        """Prefill full (exact-length) prompts: (logits at the last
        position [B,1,V], caches as ``hidden_states`` collects them) —
        the SSM stacks' prefill, one request at a time in the batcher; a
        VLM's caches include ``cross_kv``."""
        self._no_decode("prefill")
        self._no_mesh("exact-length prefill")
        hidden, caches = self.hidden_states(params, lora, batch,
                                            collect_caches=True)
        return hidden[:, -1:] @ params["lm_head"], caches

    def prefill_ragged(self, params, lora, batch, prompt_lens, *,
                       block_kv: int = 512,
                       skip_masked_blocks: bool = False, adapter_idx=None):
        """Prefill right-padded ragged prompts in one batch.  Returns
        (logits at each row's last real token [B,1,V], {"kv": (k, v)}
        with k, v ``[L, B, P, Hkv, Dh]``; a VLM's ``kv`` and ``cross_kv``
        as ``hidden_states`` collects them).  Causal masking keeps pad
        tokens out of every real position's K/V."""
        self._no_decode("prefill")
        self._attention_only("ragged (padded) prefills")
        hidden, caches = self.hidden_states(
            params, lora, batch, collect_caches=True, block_kv=block_kv,
            skip_masked_blocks=skip_masked_blocks, adapter_idx=adapter_idx)
        plan = self._mesh_plan(batch)
        lens = col.local_slice(torch.as_tensor(
            prompt_lens, device=hidden.device).long(), plan.rows, 0)
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        last = hidden[rows, lens - 1][:, None]
        return self._head(params, last, plan), caches

    # ---------------------------------------------------------- slot ops ---
    def write_prefill_slot(self, pool_caches, prefill_caches, slot: int,
                           src: int = 0):
        """Copy sequence ``src`` of a prefill's caches (``[L, B, ...]``:
        an SSM stack's conv tail and SSD state, the same shape whatever
        the prompt; a hybrid's prompt K/V too, into the first rows of the
        slot's ring) into row ``slot`` of ``pool_caches``, in place: the
        batcher gathers a wave's exact-length prefills with it."""
        self._no_vlm("cache-slot writes")
        self._no_mesh("single cache-slot writes")
        for pool, pre in zip(_cache_leaves(pool_caches),
                             _cache_leaves(prefill_caches)):
            rows = tuple(slice(0, d) for d in pre.shape[2:])
            pool[(slice(None), slot) + rows].copy_(pre[:, src])
        return pool_caches

    def write_prefill_slots(self, pool_caches, prefill_caches,
                            slots: Sequence[int]):
        """Scatter a whole prefill wave into its contiguous decode slots
        in one indexed write per cache leaf (K/V, or an SSM stack's conv
        tail and state).  ``slots`` [W] holds host-side slot ids; rows
        with an id outside ``[0, n_slots)`` are dropped (requests that
        finished at admission) — filtered on the host, as an out-of-range
        index on the card is a device assert.  K/V rows past the prompt
        are zeroed, as the JAX scatter pads them."""
        self._no_vlm("cache-slot writes")
        if current_mesh() is not None:
            return self._write_prefill_slots_mesh(pool_caches,
                                                  prefill_caches, slots)
        slots = np.asarray(slots, np.int64)
        pools, pres = _cache_leaves(pool_caches), _cache_leaves(prefill_caches)
        keep = np.nonzero((slots >= 0) & (slots < pools[0].shape[1]))[0]
        if not keep.size:
            return pool_caches
        dst = torch.as_tensor(slots[keep], device=self.device)
        src = torch.as_tensor(keep, device=self.device)
        for pool, pre in zip(pools, pres):
            p = pre.shape[2]
            # every row kept (in order): no gathered copy of the wave
            rows = pre if keep.size == pre.shape[1] else pre[:, src]
            pool[:, dst, :p] = rows.to(pool.dtype)
            pool[:, dst, p:] = 0
        return pool_caches

    def _write_prefill_slots_mesh(self, pool_caches, prefill_caches, slots):
        """``write_prefill_slots`` on the mesh: each rank writes the wave
        rows it holds (``prefill_ragged``'s K/V, cut as the caches' batch
        and heads) into its block of the slots, the positions of its
        sequence block only.  The wave and the pool must cut their batch
        alike, so no row crosses ranks."""
        cfg = self.cfg
        mesh, rules = current_mesh(), current_rules()
        k_pool = pool_caches["kv"][0]
        whole = getattr(k_pool, "mesh_whole", None)
        if whole is None:
            raise ValueError("write_prefill_slots on a mesh takes caches "
                             "from init_caches under the same mesh")
        slots = np.asarray(slots, np.int64)
        spec = batch_spec("kv/0", whole, mesh, rules)
        wave = batch_spec("kv/0", (cfg.n_layers, slots.size, mesh.size,
                                   cfg.n_kv_heads, cfg.head_dim), mesh, rules)
        p_ax, s_ax = col.axes_of(spec[1]), col.axes_of(spec[2])
        if col.axes_of(wave[1]) != p_ax:
            raise NotImplementedError(
                f"a wave of {slots.size} rows and a pool of {whole[1]} slots "
                f"cut apart on the mesh: {tfm._QUEUED}")
        nl, s_loc = k_pool.shape[1], k_pool.shape[2]
        first = col.axis_index(p_ax) * nl
        mine = col.local_slice(torch.as_tensor(slots), p_ax, 0).numpy()
        keep = np.nonzero((mine >= 0) & (mine < whole[1]))[0]
        if not keep.size:
            return pool_caches
        local = mine[keep] - first
        if ((local < 0) | (local >= nl)).any():
            raise NotImplementedError(
                f"wave rows whose slots lie on other ranks: {tfm._QUEUED}")
        start = col.axis_index(s_ax) * s_loc
        dst = torch.as_tensor(local, device=self.device)
        src = torch.as_tensor(keep, device=self.device)
        for pool, pre in zip(pool_caches["kv"], prefill_caches["kv"]):
            part = pre[:, src, start:start + s_loc]
            n = part.shape[2]
            pool[:, dst, :n] = part.to(pool.dtype)
            pool[:, dst, n:] = 0
        return pool_caches

    def write_prefill_blocks(self, pool_caches, prefill_caches,
                             wave_tables):
        """Scatter a whole prefill wave's K/V into freshly allocated pool
        blocks in one indexed write per K/V leaf.  ``wave_tables``
        [W, NBP] (host-side ids) maps wave row j's logical blocks to pool
        blocks; entries outside ``[0, n_blocks)`` (the runtime uses
        ``n_blocks`` for unused entries) are dropped on the host."""
        self._no_mesh("paged prefill writes")
        tables = np.asarray(wave_tables, np.int64)
        nbp = tables.shape[1]
        ids = tables.reshape(-1)
        n_blocks = pool_caches["kv"][0].shape[1]
        keep = np.nonzero((ids >= 0) & (ids < n_blocks))[0]
        if not keep.size:
            return pool_caches
        for pool, pre in zip(pool_caches["kv"], prefill_caches["kv"]):
            nl, w, p = pre.shape[0], pre.shape[1], pre.shape[2]
            bs = pool.shape[2]
            if p > nbp * bs:
                raise ValueError(f"prefill len {p} exceeds wave table "
                                 f"coverage {nbp * bs}")
            if p < nbp * bs:
                pre = F.pad(pre, (0, 0, 0, 0, 0, nbp * bs - p))
            vals = pre.reshape(nl, w * nbp, bs, *pre.shape[3:])
            dst = torch.as_tensor(ids[keep], device=pool.device)
            src = torch.as_tensor(keep, device=pool.device)
            pool[:, dst] = vals[:, src].to(pool.dtype)
        return pool_caches

    def write_prefill_rows(self, pool_caches, prefill_caches, slots,
                           offsets, lens):
        """Scatter one chunk wave's K/V into contiguous slot caches at
        each row's resume offset, one indexed write per K/V leaf.
        ``slots``/``offsets``/``lens`` [W] (host-side): row j's chunk
        K/V ``[L, W, C, Hkv, Dh]`` lands at cache rows ``offsets[j] ..
        offsets[j] + lens[j] - 1`` of slot ``slots[j]``.  Pad positions
        past ``lens[j]``, rows past the cache and slot ids outside
        ``[0, n_slots)`` are dropped on the host (the JAX scatter drops
        them by index; on the card an out-of-range index is a device
        assert)."""
        self._no_vlm("cache-slot writes")
        self._no_mesh("chunked prefill writes")
        slots = np.asarray(slots, np.int64)
        offsets = np.asarray(offsets, np.int64)
        lens = np.asarray(lens, np.int64)
        pools, pres = pool_caches["kv"], prefill_caches["kv"]
        n_slots, s = pools[0].shape[1], pools[0].shape[2]
        c = pres[0].shape[2]
        rows, cols = np.nonzero(np.arange(c)[None, :] < lens[:, None])
        pos = offsets[rows] + cols
        keep = (slots[rows] >= 0) & (slots[rows] < n_slots) & (pos < s)
        if not keep.any():
            return pool_caches
        dev = pools[0].device
        dst_slot = torch.as_tensor(slots[rows[keep]], device=dev)
        dst_pos = torch.as_tensor(pos[keep], device=dev)
        src_row = torch.as_tensor(rows[keep], device=dev)
        src_col = torch.as_tensor(cols[keep], device=dev)
        for pool, pre in zip(pools, pres):
            pool[:, dst_slot, dst_pos] = \
                pre[:, src_row, src_col].to(pool.dtype)
        return pool_caches

    @staticmethod
    def _pool_ids(paged_caches, ids, what: str) -> np.ndarray:
        """Host-side block ids, each inside the pool: the JAX programs
        pad ids and drop or clamp the pads, while an out-of-range index
        on the card is a device assert, so the port takes exact lists."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        n_blocks = paged_caches["kv"][0].shape[1]
        if ((ids < 0) | (ids >= n_blocks)).any():
            raise ValueError(f"{what}: ids {ids.tolist()} outside the pool "
                             f"of {n_blocks} blocks")
        return ids

    def copy_blocks(self, paged_caches, src_ids, dst_ids):
        """Copy-on-write: pool blocks ``dst := src`` (host-side ids), one
        gather and one indexed write per K/V leaf.  The runtime batches a
        tick's copies into one call."""
        src = self._pool_ids(paged_caches, src_ids, "copy_blocks")
        dst = self._pool_ids(paged_caches, dst_ids, "copy_blocks")
        if src.shape != dst.shape:
            raise ValueError(f"copy_blocks: {src.size} sources, "
                             f"{dst.size} destinations")
        if not src.size:
            return paged_caches
        for pool in paged_caches["kv"]:
            src_t = torch.as_tensor(src, device=pool.device)
            dst_t = torch.as_tensor(dst, device=pool.device)
            pool[:, dst_t] = pool[:, src_t]   # gathered before the write
        return paged_caches

    def gather_blocks(self, paged_caches, ids):
        """Preemption swap-out, device half: pool blocks ``ids`` (host-side,
        exact) in ONE indexed gather per K/V leaf, ``{"kv": (k, v)}`` with
        k, v ``[L, len(ids), block_size, Hkv, Dh]`` on the pool's device
        in its dtype; the runtime copies them to host memory."""
        ids = self._pool_ids(paged_caches, ids, "gather_blocks")
        k, v = (pool[:, torch.as_tensor(ids, device=pool.device)]
                for pool in paged_caches["kv"])
        return {"kv": (k, v)}

    def scatter_blocks(self, paged_caches, ids, host_kv):
        """Preemption swap-in: land host-side block contents ``host_kv``
        (k, v ``[L, len(ids), block_size, Hkv, Dh]``, any device) in the
        fresh pool blocks ``ids`` (host-side, exact): one copy to the
        pool's device and ONE indexed write per K/V leaf, in place."""
        ids = self._pool_ids(paged_caches, ids, "scatter_blocks")
        for pool, vals in zip(paged_caches["kv"], host_kv):
            if vals.shape[1] != ids.size:
                raise ValueError(f"scatter_blocks: {vals.shape[1]} blocks "
                                 f"of contents for {ids.size} ids")
            if ids.size:
                pool[:, torch.as_tensor(ids, device=pool.device)] = \
                    vals.to(pool.device).to(pool.dtype)
        return paged_caches

    # ------------------------------------------------------- suffix prefill -
    def _suffix_prefill(self, params, lora, batch, suffix_lens, prefix_lens,
                        gather, adapter_idx):
        """The loop of ``prefill_ragged_suffix`` / ``_continue``: each
        layer attends its suffix rows over ``gather(layer)``, that
        layer's prefix K/V (gathered inside the loop, so a wave never
        holds every layer's copy of the prefixes)."""
        cfg = self.cfg
        self._no_decode("prefill")
        self._attention_only("suffix prefills")
        self._no_vlm("suffix prefills")
        self._no_mesh("suffix prefills")
        tokens = batch["tokens"]
        dev = tokens.device
        x = params["embed"][tokens]
        plen = torch.as_tensor(prefix_lens, device=dev).long()
        positions = plen[:, None] + torch.arange(tokens.shape[1], device=dev)
        rope_cs = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        kvs = []
        for i in range(cfg.n_layers):
            x, kv = tfm.block_prefill_suffix(
                _layer(params["blocks"], i), x, cfg, gather(i), plen,
                rope_cs, lora=_layer(lora, i), adapter_idx=adapter_idx)
            kvs.append(kv)
        hidden = rms_norm(x, params["final_norm"])
        lens = torch.as_tensor(suffix_lens, device=dev).long()
        rows = torch.arange(hidden.shape[0], device=dev)
        last = hidden[rows, lens - 1][:, None]
        return last @ params["lm_head"], \
            {"kv": tuple(torch.stack(t) for t in zip(*kvs))}

    def prefill_ragged_suffix(self, params, lora, batch, suffix_lens,
                              prefix_lens, caches, prefix_tables,
                              adapter_idx=None):
        """Prefill only the uncached suffix of each prompt over the paged
        pool (prefix caching; chunked prefill, paged).

        ``batch["tokens"]`` [W, SufPad] holds each row's right-padded
        suffix (absolute positions ``prefix_lens[w] + i``);
        ``prefix_tables`` [W, NBpre] names the pool blocks holding each
        row's block-aligned prefix (scratch block 0 past it: those lanes
        are masked).  The prefix K/V are gathered from ``caches`` layer
        by layer.  Returns (logits at each row's last real suffix token
        [W,1,V], {"kv": suffix K/V [L, W, SufPad, Hkv, Dh]}) for
        ``write_prefill_blocks``."""
        k_all, v_all = caches["kv"]
        tables = torch.as_tensor(prefix_tables, dtype=torch.long,
                                 device=k_all.device)
        w, nbpre = tables.shape
        bs = k_all.shape[2]

        def gather(i):
            return tuple(pool[i][tables].reshape(w, nbpre * bs,
                                                 *pool.shape[3:])
                         for pool in (k_all, v_all))

        return self._suffix_prefill(params, lora, batch, suffix_lens,
                                    prefix_lens, gather, adapter_idx)

    def prefill_ragged_continue(self, params, lora, batch, suffix_lens,
                                prefix_lens, caches, slot_ids,
                                adapter_idx=None):
        """Chunked prefill over CONTIGUOUS slot caches: one chunk per row,
        attending over the K/V the slot's earlier chunks wrote (cache rows
        ``0 .. prefix_lens[w] - 1`` of slot ``slot_ids[w]``; later rows are
        stale and masked).  Returns (logits at each row's last real chunk
        token [W,1,V], {"kv": chunk K/V [L, W, CPad, Hkv, Dh]}) for
        ``write_prefill_rows``."""
        k_all, v_all = caches["kv"]
        slots = torch.as_tensor(slot_ids, dtype=torch.long,
                                device=k_all.device)

        def gather(i):
            return k_all[i][slots], v_all[i][slots]

        return self._suffix_prefill(params, lora, batch, suffix_lens,
                                    prefix_lens, gather, adapter_idx)

    # --------------------------------------------------------------- decode -
    def _positions(self, pos, batch: int) -> torch.Tensor:
        pos = torch.as_tensor(pos, device=self.device)
        return pos.expand(batch) if pos.dim() == 0 else pos

    def _logits(self, params, x, plan=tfm.NO_PLAN):
        return self._head(params, rms_norm(x, params["final_norm"]), plan)

    def decode_step(self, params, lora, caches, token, pos,
                    adapter_idx=None):
        """One decode step over contiguous caches.  token: [B,1] int;
        pos: [B] (or scalar) int positions of the new tokens.  Returns
        (logits [B,1,V], caches updated in place).  An SSM stack ignores
        ``pos``: its state carries the position.  A VLM stack reads each
        unit's ``cross_kv`` and serves one adapter (``adapter_idx``
        raises).  On a mesh every sequence's token and position in,
        every sequence's logits out, this rank's caches written in
        place."""
        cfg = self.cfg
        self._no_decode("decode step")
        pos = self._positions(pos, token.shape[0])
        plan = self._mesh_plan({"tokens": token}, adapter_idx)
        if plan.mesh is not None:
            whole = getattr(caches["kv"][0], "mesh_whole", None)
            if whole is None or whole[1] != token.shape[0]:
                raise ValueError(
                    f"decode_step on a mesh takes the caches of init_caches("
                    f"{token.shape[0]}, ...) under the same mesh")
        x = self._embed(params, {"tokens": token}, plan)
        pos = col.local_slice(pos, plan.rows, 0)
        rope_cs = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta) \
            if cfg.has_attention else None
        if cfg.family is Family.VLM:
            if adapter_idx is not None:
                raise NotImplementedError(
                    f"{cfg.name}: per-row adapters in VLM decode (the "
                    "reference's VLM decode serves one adapter)")
            return self._vlm_decode(params, lora, caches, x, pos, rope_cs)
        for i in range(cfg.n_layers):
            layer = {}
            if cfg.has_attention:
                layer["kv"] = (caches["kv"][0][i], caches["kv"][1][i])
            if cfg.has_ssm:
                layer["ssm"] = _layer(caches["ssm"], i)
            x, _ = tfm.block_decode(_layer(params["blocks"], i), x, cfg,
                                    layer, pos, rope_cs,
                                    lora=_layer(lora, i),
                                    adapter_idx=adapter_idx, plan=plan)
        return self._logits(params, x, plan), caches

    def _vlm_decode(self, params, lora, caches, x, pos, rope_cs):
        """The VLM's decode: each unit's dense blocks over their
        contiguous caches (the paged kernel through identity tables),
        then its cross block over the unit's ``cross_kv`` through
        ``decode_attention``, every vision row valid."""
        cfg = self.cfg
        units, per = self._vlm_shape()
        k_all, v_all = caches["kv"]
        ck, cv = caches["cross_kv"]
        cross_len = torch.full((x.shape[0],), ck.shape[2], dtype=torch.int32,
                               device=x.device)
        for u in range(units):
            blocks, ulora = _layer(params["blocks"], u), _layer(lora, u)
            for j in range(per):
                x, _ = tfm.block_decode(
                    _layer(blocks, j), x, cfg, {"kv": (k_all[u, j],
                                                       v_all[u, j])},
                    pos, rope_cs, lora=_layer(ulora, j))
            x = tfm.cross_block(_layer(params["cross"], u), x,
                                (ck[u], cv[u]), cfg, kv_len=cross_len)
        return self._logits(params, x), caches

    def decode_step_paged(self, params, lora, caches, token, pos,
                          block_tables, *, ring_len: int = 0,
                          adapter_idx=None):
        """One decode step over the paged KV pool.  token: [B,1] int;
        pos: [B] int absolute positions; block_tables: [B, NB] int32 on
        the model's device (entries past a sequence's live blocks point
        at scratch block 0; rows may be a strided view).  ``ring_len`` is
        the logical cache length of sliding-window archs (writes wrap
        there); 0 means the table covers the whole budget.  Write block,
        offset and kv_len are computed on the device.  Returns
        (logits [B,1,V], caches updated in place)."""
        cfg = self.cfg
        self._no_decode("decode step")
        self._attention_only("paged decode steps")
        self._no_vlm("paged decode steps")
        self._no_mesh("paged decode steps")
        k_all, v_all = caches["kv"]
        bs = k_all.shape[2]
        pos = self._positions(pos, token.shape[0])
        rl = ring_len if ring_len else block_tables.shape[1] * bs
        wpos = torch.remainder(pos, rl)
        kv_len = torch.clamp(pos + 1, max=rl).to(torch.int32)
        write_block = torch.gather(block_tables, 1,
                                   (wpos // bs)[:, None].long())[:, 0]
        write_block = write_block.long()
        write_off = torch.remainder(wpos, bs).long()
        x = params["embed"][token]
        rope_cs = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
        for i in range(cfg.n_layers):
            x, _ = tfm.block_decode_paged(
                _layer(params["blocks"], i), x, cfg, (k_all[i], v_all[i]),
                rope_cs, block_tables, write_block, write_off, kv_len,
                lora=_layer(lora, i), adapter_idx=adapter_idx)
        return self._logits(params, x), caches


def build(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg, resolve_device(device))
