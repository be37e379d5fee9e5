"""Serving driver of the port: a continuous-batching decode runtime over
one model replica (``repro.launch.serve``'s single-batcher path).

Prompts run through a real ragged prefill, finished sequences are
evicted and new requests admitted mid-flight, and every decode tick runs
the paged-decode-attention kernel in every layer, over either cache
layout; every LoRA projection runs the fused lora_matmul kernel.
``--combined`` co-trains the LoRA adapter on every tick (one fused train
step per decode tick, over the same base weights).  ``--adapters N``
serves N tenants from one registry: requests are tagged ``tenant{i % N}``
round-robin and every wave mixes them through the segmented_lora_matmul
kernel.  ``--arch mamba2-780m`` serves the attention-free Mamba2 stack
(contiguous caches: a conv tail and an SSD state per slot): each prompt
prefills at its exact length through the ssd_scan kernel in every layer,
and ``--paged`` and ``--adapters`` raise for it, as in the reference.
Weights are random, drawn from ``--seed``.  The multi-replica
fabric and the batcher's other optional features are not ported yet
(see ROADMAP.md).

Usage (on a machine with an NVIDIA Hopper card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --requests 16 --prompt-len 32 --gen 16
  ... --paged --block-size 16 --n-blocks 64   # paged KV cache
  ... --combined --train-batch 4              # co-train the adapter
  ... --adapters 3 [--combined]               # multi-tenant LoRA serving
  ... --arch mamba2-780m                      # Mamba2 (SSM), contiguous
  ... --smoke --device cpu [--combined]       # reduced config on the CPU
                                              # (plain PyTorch versions)
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.engine import make_engine
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.runtime.fabric import make_tenant_adapters
from repro_torch.runtime.serving_loop import (
    AdapterRegistry, ContinuousBatcher, GenRequest, refuse_vlm,
)


def run_serving(arch: str, *, smoke: bool = True, n_requests: int = 16,
                prompt_len: int = 32, gen_tokens: int = 16,
                batch_size: int = 8, combined: bool = False,
                train_batch: int = 4, seed: int = 0, paged: bool = False,
                block_size: int = 16, n_blocks: int = 0,
                temperature: float = 0.0, top_k: int = 0,
                top_p: float = 1.0, n_adapters: int = 0,
                adapter_slots: int = 0, device="cuda",
                verbose: bool = True) -> dict:
    """Serve ``n_requests`` synthetic prompts on a ``batch_size``-slot
    continuous batcher on ``device``; returns throughput and counts,
    each request's tokens, (paged) the allocator's end state, and
    (``combined``) the loss of the train step each tick co-ran on a
    fresh ``train_batch`` x ``prompt_len`` synthetic batch.

    ``n_adapters > 0`` registers that many tenants (``make_tenant_adapters``)
    on an ``AdapterRegistry`` of ``adapter_slots`` device slots (default:
    one per tenant) and tags requests round-robin; the output then
    carries the registry's counters and each request's tenant.  In
    combined mode training steps tenant 0's tree in place while decode
    reads the registry's copies."""
    cfg = get_config(arch)
    refuse_vlm(cfg)                    # before building a model for it
    if smoke:
        cfg = cfg.scaled()
    engine = make_engine(cfg, lr=3e-3, device=device)
    model = engine.model
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = model.init(gen)
    registry = None
    if n_adapters > 0:
        tenants = make_tenant_adapters(model, n_adapters, seed=seed + 1)
        registry = AdapterRegistry(model,
                                   capacity=adapter_slots or n_adapters)
        for t, tree in enumerate(tenants):
            registry.register(f"tenant{t}", tree)
        lora = tenants[0]
    else:
        lora = model.init_lora(gen)
    data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size,
                            seq_len=prompt_len, seed=seed)
    batcher = ContinuousBatcher(
        engine, params, lora, n_slots=batch_size,
        max_seq=prompt_len + gen_tokens, prompt_pad=prompt_len,
        opt_state=engine.optimizer.init(lora), paged=paged,
        block_size=block_size, n_blocks=n_blocks or None,
        adapters=registry)
    prompts = data.sample_tokens(n_requests)[:, :prompt_len]
    requests = [GenRequest(request_id=i, prompt=prompts[i],
                           max_new_tokens=gen_tokens,
                           adapter_id=f"tenant{i % n_adapters}"
                           if n_adapters > 0 else None,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p, seed=seed + i)
                for i in range(n_requests)]

    def train_fn():
        return data.batch(train_batch)

    stats = batcher.run(requests, train_data_fn=train_fn if combined
                        else None)
    per_req = [r.finished_at for r in requests
               if r.finished_at is not None]
    out = {
        "finished": stats.finished,
        "tokens_generated": stats.generated_tokens,
        "prefill_tokens": stats.prefill_tokens,
        "decode_steps": stats.decode_steps,
        "prefill_waves": batcher.prefill_waves,
        "train_steps": stats.train_steps,
        "train_losses": batcher.train_losses,
        "wall_s": stats.wall_time,
        "mean_completion_s": float(np.mean(per_req)) if per_req else 0.0,
        "throughput_tok_s": stats.throughput(),
        # per request, seconds on the run's clock (the batcher's stamps)
        "ttft_s": list(stats.ttft),
        "tpot_s": list(stats.tpot),
        "cache_bytes": batcher.cache_bytes(),
        "tokens": [list(r.tokens) for r in requests],
    }
    if paged:
        out["peak_used_blocks"] = batcher.allocator.peak_used
        out["pool_blocks"] = batcher.allocator.capacity
        out["blocks_used_at_end"] = batcher.allocator.n_used
        out["blocks_reserved_at_end"] = batcher.allocator.reserved
    if registry is not None:
        out["adapter_ids"] = [r.adapter_id for r in requests]
        out["adapter_requests"] = dict(stats.adapter_requests)
        out["adapter_hits"] = registry.hits
        out["adapter_loads"] = registry.loads
        out["adapter_evictions"] = registry.evictions
        out["adapter_refs_at_end"] = {
            a: registry.refcount(a) for a in registry.registered()}
    if verbose:
        print(f"served {stats.finished}/{n_requests} requests, "
              f"{stats.generated_tokens} tokens in {stats.decode_steps} "
              f"decode steps, {out['throughput_tok_s']:.1f} tok/s on "
              f"{model.device}"
              + (f" (sampled, T={temperature:g})" if temperature > 0
                 else "")
              + (f"; co-trained {stats.train_steps} fused steps "
                 f"(loss {batcher.train_losses[0]:.3f} -> "
                 f"{batcher.train_losses[-1]:.3f})"
                 if batcher.train_losses else "")
              + (f"; {n_adapters} tenants "
                 f"{dict(sorted(stats.adapter_requests.items()))}"
                 if registry is not None else ""))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced config (2 layers, d_model 128, "
                         "float32) instead of the published one")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--combined", action="store_true",
                    help="co-train the LoRA adapter on every tick")
    ap.add_argument("--train-batch", type=int, default=4,
                    help="co-running train batch (--combined)")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="paged pool size (0 = full worst case)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy, the default)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest logits (0 = all)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = no filter)")
    ap.add_argument("--adapters", type=int, default=0,
                    help="multi-tenant LoRA: register N tenants and tag "
                         "requests round-robin (0 = one adapter)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args()
    run_serving(args.arch, smoke=args.smoke, n_requests=args.requests,
                prompt_len=args.prompt_len, gen_tokens=args.gen,
                batch_size=args.batch, combined=args.combined,
                train_batch=args.train_batch, paged=args.paged,
                block_size=args.block_size, n_blocks=args.n_blocks,
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, n_adapters=args.adapters, seed=args.seed,
                device=args.device)


if __name__ == "__main__":
    main()
