"""Step functions of the port — ``repro.core.engine``: serving steps, the
LoRA train step, and the paper's core mechanism, ``combined_step``: one
LoRA train step AND one decode batch over ONE shared copy of the base
weights (CoLLM's model sharing).

PyTorch runs eagerly, so a combined step is the decode followed by the
train step, both reading the same ``params`` tensors (frozen, never
cloned).  The decode reads the pre-update adapter: the optimizer returns
new LoRA tensors and leaves the ones decode read untouched, so the
within-step snapshot isolation of the fused JAX program holds by
construction.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, build
from repro_torch.optim.adamw import AdamW, AdamWState, global_norm
from repro_torch.tree import tree_leaves, tree_map


def _rows(batch: Dict, n: int) -> Dict:
    return {k: v[:n] for k, v in batch.items()}


def _lead(batch: Dict) -> torch.Tensor:
    """The tensor whose leading dims are the batch's (rows, sequence):
    ``tokens``, or an encoder batch's ``embeds``."""
    return batch["tokens"] if "tokens" in batch else batch["embeds"]


@dataclasses.dataclass(frozen=True)
class Engine:
    """Step factory for one architecture on one device."""
    model: Model
    optimizer: AdamW = AdamW()

    # ----------------------------------------------------------- training --
    def loss_and_grads(self, params: Any, lora: Any, batch: Dict, *,
                       ce_chunk: int = 512, skip_masked_blocks: bool = False
                       ) -> Tuple[torch.Tensor, Dict, Any]:
        """Forward loss and its gradient in the LoRA leaves only (the base
        weights are frozen: PEFT).  Returns (loss, metrics, grads) with
        grads a tree like ``lora``, detached."""
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), lora)
        with torch.enable_grad():
            loss, metrics = self.model.forward_loss(
                params, leaves, batch, ce_chunk=ce_chunk,
                skip_masked_blocks=skip_masked_blocks)
            flat = tree_leaves(leaves)
            gflat = torch.autograd.grad(loss, flat)
        it = iter(gflat)
        grads = tree_map(lambda _: next(it), leaves)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def train_step(self, params: Any, lora: Any, opt_state: AdamWState,
                   batch: Dict, *, skip_masked_blocks: bool = False,
                   ce_chunk: int = 512, grad_accum: int = 1,
                   train_tokens: int = 0
                   ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        """LoRA-only gradient step.  ``grad_accum`` > 1 splits the batch
        into that many microbatches run one after another, gradients
        accumulated in float32; the mean per-microbatch |g|^2 feeds the
        noise-scale estimator.  ``train_tokens`` > 0 caps the step at
        about that many tokens by keeping whole leading rows.  Returns
        (new lora, new optimizer state, metrics ``loss``, ``ce_loss``,
        ``aux_loss`` (the MoE layers' load-balancing loss, zero for the
        other families; with ``grad_accum`` > 1 only ``ce_loss``, as in
        the reference), ``grad_norm``, ``lr``, ``micro_grad_sqnorm``,
        ``grad_sqnorm``).
        ``skip_masked_blocks`` reaches the blockwise attention of
        sequences past the dense limit."""
        if train_tokens > 0:
            b, s = _lead(batch).shape[:2]
            rows = max(1, min(b, train_tokens // max(s, 1)))
            if rows < b:
                batch = _rows(batch, rows)
                if grad_accum > 1 and rows % grad_accum:
                    grad_accum = 1
        if grad_accum <= 1:
            loss, metrics, grads = self.loss_and_grads(
                params, lora, batch, ce_chunk=ce_chunk,
                skip_masked_blocks=skip_masked_blocks)
            micro_sqnorm = global_norm(grads) ** 2
        else:
            n = _lead(batch).shape[0] // grad_accum
            grads = tree_map(lambda t: torch.zeros(
                t.shape, dtype=torch.float32, device=t.device), lora)
            loss = torch.zeros((), dtype=torch.float32,
                               device=_lead(batch).device)
            micro_sqnorm = torch.zeros_like(loss)
            for i in range(grad_accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l_, _, g = self.loss_and_grads(
                    params, lora, mb, ce_chunk=ce_chunk,
                    skip_masked_blocks=skip_masked_blocks)
                grads = tree_map(lambda acc, gi: acc + gi.float() / grad_accum,
                                 grads, g)
                loss = loss + l_ / grad_accum
                micro_sqnorm = micro_sqnorm + global_norm(g) ** 2 / grad_accum
            metrics = {"ce_loss": loss}
        new_lora, new_opt, opt_metrics = self.optimizer.update(
            grads, opt_state, lora)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        metrics["micro_grad_sqnorm"] = micro_sqnorm
        metrics["grad_sqnorm"] = torch.square(metrics["grad_norm"])
        return new_lora, new_opt, metrics

    # ------------------------------------------------------------ serving --
    @torch.no_grad()
    def prefill_step(self, params: Any, lora: Any, batch: Any
                     ) -> Tuple[torch.Tensor, Any]:
        """Prefill full-length prompts: (last-token logits, caches).  SSM
        stacks take the exact-length ``Model.prefill``; a VLM batch
        carries ``batch["vision"]`` and its caches ``cross_kv``."""
        if self.model.cfg.has_ssm:
            return self.model.prefill(params, lora, batch)
        tokens = batch["tokens"]
        lens = torch.full((tokens.shape[0],), tokens.shape[1],
                          device=tokens.device)
        return self.model.prefill_ragged(params, lora, batch, lens)

    @torch.no_grad()
    def decode_step(self, params: Any, lora: Any, caches: Any,
                    token: torch.Tensor, pos: torch.Tensor
                    ) -> Tuple[torch.Tensor, Any]:
        return self.model.decode_step(params, lora, caches, token, pos)

    @torch.no_grad()
    def encoder_serve_step(self, params: Any, lora: Any, batch: Dict
                           ) -> torch.Tensor:
        """Encoder-only serving: frame classification of whole sequences,
        ``hidden @ lm_head`` [B, S, V] over ``batch["embeds"]`` [B, S,
        d_model]."""
        hidden, _ = self.model.hidden_states(params, lora, batch)
        return hidden @ params["lm_head"]

    # ------------------------------------------------- the paper's fusion --
    def combined_step(self, params: Any, lora: Any, opt_state: AdamWState,
                      train_batch: Dict, caches: Any, token: torch.Tensor,
                      pos: torch.Tensor, *, serve_lora: Any = None,
                      grad_accum: int = 1, train_tokens: int = 0,
                      serve_adapter_idx: Any = None):
        """LoRA train step + decode batch over the same base weights.  The
        logits come from the pre-update adapter; with ``serve_lora`` given
        decode reads it and only ``lora`` (the shadow tree) is trained.
        ``serve_adapter_idx`` [B] makes ``serve_lora`` a stacked
        multi-tenant tree read per row (the registry's decode wave).
        Returns (new lora, new state, logits, caches, metrics)."""
        with torch.no_grad():
            logits, caches = self.model.decode_step(
                params, lora if serve_lora is None else serve_lora, caches,
                token, pos, adapter_idx=serve_adapter_idx)
        new_lora, new_opt, metrics = self.train_step(
            params, lora, opt_state, train_batch, grad_accum=grad_accum,
            train_tokens=train_tokens)
        return new_lora, new_opt, logits, caches, metrics

    def combined_step_paged(self, params: Any, lora: Any,
                            opt_state: AdamWState, train_batch: Dict,
                            caches: Any, token: torch.Tensor,
                            pos: torch.Tensor, block_tables: torch.Tensor,
                            *, ring_len: int = 0, serve_lora: Any = None,
                            grad_accum: int = 1, train_tokens: int = 0,
                            serve_adapter_idx: Any = None):
        """``combined_step`` over the paged KV pool (same snapshot
        semantics, ``serve_lora`` shadow split and ``serve_adapter_idx``
        multi-tenant rows)."""
        with torch.no_grad():
            logits, caches = self.model.decode_step_paged(
                params, lora if serve_lora is None else serve_lora, caches,
                token, pos, block_tables, ring_len=ring_len,
                adapter_idx=serve_adapter_idx)
        new_lora, new_opt, metrics = self.train_step(
            params, lora, opt_state, train_batch, grad_accum=grad_accum,
            train_tokens=train_tokens)
        return new_lora, new_opt, logits, caches, metrics

    def combined_prefill_step(self, params: Any, lora: Any,
                              opt_state: AdamWState, train_batch: Dict,
                              infer_batch: Any):
        """Train step + prefill of full-length prompts (the co-located
        inference work is prompt processing rather than decode)."""
        logits, caches = self.prefill_step(params, lora, infer_batch)
        new_lora, new_opt, metrics = self.train_step(
            params, lora, opt_state, train_batch)
        return new_lora, new_opt, logits, caches, metrics


def make_engine(cfg: ModelConfig, lr: float = 1e-4,
                weight_decay: float = 0.0, device="cuda") -> Engine:
    return Engine(model=build(cfg, device),
                  optimizer=AdamW(lr=lr, weight_decay=weight_decay))
