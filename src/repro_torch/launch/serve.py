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
kernel.  ``--prefix-cache`` (with ``--paged``) shares identical prompt
prefixes copy-on-write across requests, per tenant; ``--chunked-prefill
N`` prefills prompts N tokens a tick beside the decode wave; ``--tpot-
target S`` budgets each tick for a decode TPOT of S seconds (decode
first, then prefill chunks, then a full, half or skipped train step).
``--oversubscribe W`` (with ``--paged``) reserves only near-term blocks
against a W-fraction watermark of the pool and preempts a slot when the
pool runs out: its private blocks swap to host memory, or with
``--no-swap`` are dropped and re-prefilled on restore.
``--arch mamba2-780m`` serves the attention-free Mamba2 stack
(contiguous caches: a conv tail and an SSD state per slot): each prompt
prefills at its exact length through the ssd_scan kernel in every layer,
and ``--paged``, ``--adapters`` and ``--chunked-prefill`` raise for it,
as in the reference.  ``--arch hymba-1.5b`` serves the hybrid the same
way, its sliding-window K/V in a ring per slot beside the SSM caches.
With ``--combined`` either co-trains through the ssd_scan backward
kernel.  ``--arch moonshot-v1-16b-a3b`` and ``--arch grok-1-314b`` serve
the MoE stacks through every path a dense stack takes (paged,
contiguous, tenants, co-training): each MLP routes its tokens top-k over
the experts with a per-expert capacity, every decode slot included (a
free slot's token takes capacity, as in the reference), and a wave
of more than 512 tokens must be a whole number of 512-token groups (the
reference asserts; the port raises).  Weights are random, drawn from
``--seed``.

``--replicas N`` (N > 1) serves the same trace through the multi-replica
fabric instead (``runtime/fabric.py``): one ``ClusterController`` routes
dispatcher subflows across N live replicas that share one device copy of
the base weights, with placement by pool headroom, prefix-cache and
adapter affinity; the summary folds per-replica and cluster-total
``ServeStats``.  ``--combined --replicas N`` runs the paper's
co-execution: the launcher cohorts the replicas into federated LoRA
rounds over the same fabric, each replica training a shadow adapter one
fused step per tick while decode reads the published one, and FedAvg
publishes the merged adapter at round boundaries (``--rounds``,
``--steps-per-round``, ``--train-pool``).  ``--chaos`` arms a seeded
fault schedule (crashes, stalls, admission OOMs, NaN rounds) against
the pool and prints the failover and retry counters.

Usage (on a machine with an NVIDIA Hopper card):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --requests 16 --prompt-len 32 --gen 16
  ... --paged --block-size 16 --n-blocks 64   # paged KV cache
  ... --paged --prefix-cache                  # copy-on-write prefix sharing
  ... --chunked-prefill 256 [--tpot-target 0.1]   # chunks, tick budget
  ... --paged --n-blocks 160 --oversubscribe 1.0 [--no-swap]  # preemption
  ... --combined --train-batch 4              # co-train the adapter
  ... --adapters 3 [--combined]               # multi-tenant LoRA serving
  ... --arch mamba2-780m [--combined]         # Mamba2 (SSM), contiguous
  ... --arch hymba-1.5b [--combined]          # hybrid: window ring + SSM
  ... --arch moonshot-v1-16b-a3b [--paged]    # MoE (64 experts, top 6)
  ... --replicas 2 --paged                    # dispatcher-routed pool
  ... --replicas 2 --combined --rounds 2      # FL rounds over the pool
  ... --replicas 2 --adapters 4               # tenants across replicas
  ... --replicas 2 --chaos --chaos-crashes 1  # seeded fault injection
  ... --smoke --device cpu [--combined]       # reduced config on the CPU
                                              # (plain PyTorch versions)
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.engine import make_engine
from repro_torch.data.synthetic import SyntheticDataset
from repro_torch.runtime.fabric import make_tenant_adapters
from repro_torch.runtime.serving_loop import (
    AdapterRegistry, ContinuousBatcher, GenRequest, refuse_vlm,
)


def _make_injector(n_replicas: int, chaos: dict):
    """Build a seeded FaultInjector over the fabric's replica ids from
    the --chaos-* knobs."""
    from repro_torch.runtime.fault import FaultInjector
    plan = FaultInjector.random_plan(
        [f"r{i}" for i in range(n_replicas)],
        seed=chaos.get("seed", 0),
        horizon=chaos.get("horizon", 5.0),
        n_crashes=chaos.get("crashes", 1),
        n_stalls=chaos.get("stalls", 1),
        n_ooms=chaos.get("ooms", 0),
        n_nan_rounds=chaos.get("nan_rounds", 0))
    return FaultInjector(plan)


def _print_fault_telemetry(out: dict) -> None:
    ft = out.get("fault_tolerance")
    if not ft:
        return
    print(f"  chaos: {len(ft['injected'])} faults injected, "
          f"{ft['failovers']} failovers, {ft['quarantines']} quarantines, "
          f"{ft['retried_requests']} retries, "
          f"{ft['rejected_requests']} rejected, "
          f"{ft['nan_publishes_blocked']} NaN publishes blocked; "
          f"{out.get('failed_requests', 0)} requests failed")


def _exit_unserved(out: dict) -> None:
    """Exit non-zero, with every contained pump exception's traceback on
    stderr, when the fabric left a request incomplete or failed: the
    fabric contains a replica's exception as a failover and runs on, so
    a kernel that fails on every replica would otherwise end in an
    ordinary summary."""
    bad = out.get("incomplete_requests", 0) + out.get("failed_requests", 0)
    if not bad:
        return
    for now, rid, tb in out["fault_tolerance"]["pump_errors"]:
        print(f"{rid} at {now:.3f} s: {tb}", file=sys.stderr)
    sys.exit(f"fabric: {out.get('incomplete_requests', 0)} requests "
             f"incomplete, {out.get('failed_requests', 0)} failed")


def run_serving(arch: str, *, smoke: bool = True, n_requests: int = 16,
                prompt_len: int = 32, gen_tokens: int = 16,
                batch_size: int = 8, combined: bool = False,
                train_batch: int = 4, seed: int = 0, paged: bool = False,
                block_size: int = 16, n_blocks: int = 0,
                prefix_cache: bool = False, prefill_chunk: int = 0,
                tpot_target: float = 0.0, oversubscribe: float = 0.0,
                swap: bool = True, temperature: float = 0.0, top_k: int = 0,
                top_p: float = 1.0, n_adapters: int = 0,
                adapter_slots: int = 0, device="cuda",
                verbose: bool = True) -> dict:
    """Serve ``n_requests`` synthetic prompts on a ``batch_size``-slot
    continuous batcher on ``device``; returns throughput and counts,
    each request's tokens, (paged) the allocator's end state, and
    (``combined``) the loss of the train step each tick co-ran on a
    fresh ``train_batch`` x ``prompt_len`` synthetic batch, with the rows
    each trained tick took (``tpot_target`` may halve or skip a step).
    ``prefix_cache``, ``prefill_chunk``, ``tpot_target``,
    ``oversubscribe`` and ``swap`` reach the batcher; the output then
    carries the cache's, the budget's and the preemption counters.

    ``n_adapters > 0`` registers that many tenants (``make_tenant_adapters``)
    on an ``AdapterRegistry`` of ``adapter_slots`` device slots (default:
    one per tenant) and tags requests round-robin; the output then
    carries the registry's counters and each request's tenant.  In
    combined mode training steps tenant 0's tree in place while decode
    reads the registry's copies."""
    cfg = get_config(arch)
    if not cfg.has_decode:             # the reference's assert, its words
        raise AssertionError(f"{arch} is encoder-only; no decode serving")
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
        prefix_cache=prefix_cache, adapters=registry,
        prefill_chunk=prefill_chunk, tpot_target=tpot_target,
        oversubscribe=oversubscribe, swap=swap)
    prompts = data.sample_tokens(n_requests)[:, :prompt_len]
    requests = [GenRequest(request_id=i, prompt=prompts[i],
                           max_new_tokens=gen_tokens,
                           adapter_id=f"tenant{i % n_adapters}"
                           if n_adapters > 0 else None,
                           temperature=temperature, top_k=top_k,
                           top_p=top_p, seed=seed + i)
                for i in range(n_requests)]

    train_rows = []     # rows of each trained tick

    def note_trained():
        if batcher.last_tick_trained:
            train_rows.append(batcher.last_tick_train_rows)

    def train_fn():
        note_trained()  # the tick before this one
        return data.batch(train_batch)

    stats = batcher.run(requests, train_data_fn=train_fn if combined
                        else None)
    note_trained()
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
        "train_rows": train_rows,
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
    if oversubscribe > 0:
        out.update(preemptions=stats.preemptions,
                   swap_out_blocks=stats.swap_out_blocks,
                   swap_in_blocks=stats.swap_in_blocks,
                   reprefill_tokens=stats.reprefill_tokens)
    if prefix_cache:
        out["cached_prefix_tokens"] = stats.cached_prefix_tokens
        out["prefix_cache_hits"] = batcher.prefix_cache.hits
    if tpot_target > 0:
        out.update(budget_ticks=stats.budget_ticks,
                   budget_spent_s=stats.budget_spent_s,
                   budget_target_s=stats.budget_target_s,
                   train_skipped_ticks=stats.train_skipped_ticks)
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
              + (f"; {stats.cached_prefix_tokens} prompt tokens served "
                 "from the prefix cache" if prefix_cache else "")
              + (f"; budget {stats.budget_spent_s:.3f} of "
                 f"{stats.budget_target_s:.3f} s, "
                 f"{stats.train_skipped_ticks} train steps skipped"
                 if tpot_target > 0 else "")
              + (f"; co-trained {stats.train_steps} fused steps "
                 f"(loss {batcher.train_losses[0]:.3f} -> "
                 f"{batcher.train_losses[-1]:.3f})"
                 if batcher.train_losses else "")
              + (f"; {n_adapters} tenants "
                 f"{dict(sorted(stats.adapter_requests.items()))}"
                 if registry is not None else "")
              + (f"; {stats.preemptions} preemptions "
                 f"({stats.swap_out_blocks} blocks swapped, "
                 f"{stats.reprefill_tokens} tokens re-prefilled)"
                 if oversubscribe > 0 else ""))
    return out


def _fabric_requests(cfg, n_requests: int, prompt_len: int,
                     gen_tokens: int, seed: int, n_adapters: int,
                     temperature: float, top_k: int, top_p: float):
    """The fabric's trace: ``n_requests`` synthetic prompts on the
    model's stream, all arriving at 0, tagged round-robin by tenant."""
    from repro_torch.core.interfaces import Request
    data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size,
                            seq_len=prompt_len, seed=seed)
    prompts = data.sample_tokens(n_requests)[:, :prompt_len]
    return [Request(request_id=i, stream_id=cfg.name, arrival=0.0,
                    deadline=1e9, tokens=gen_tokens,
                    prompt=prompts[i].astype(np.int32),
                    adapter_id=f"tenant{i % n_adapters}"
                    if n_adapters > 0 else None,
                    temperature=temperature, top_k=top_k,
                    top_p=top_p, seed=seed + i)
            for i in range(n_requests)]


def run_multi_replica_serving(
        arch: str, *, n_replicas: int = 2, smoke: bool = True,
        n_requests: int = 16, prompt_len: int = 32, gen_tokens: int = 16,
        batch_size: int = 4, seed: int = 0, paged: bool = False,
        block_size: int = 16, n_blocks: int = 0,
        prefix_cache: bool = False, temperature: float = 0.0,
        top_k: int = 0, top_p: float = 1.0, n_adapters: int = 0,
        prefill_chunk: int = 0, tpot_target: float = 0.0,
        oversubscribe: float = 0.0, swap: bool = True,
        chaos: dict = None, device="cuda", verbose: bool = True) -> dict:
    """Serve ``n_requests`` prompts through the dispatcher-routed
    multi-replica fabric on ``device``; returns the aggregate cluster
    summary.  ``n_adapters > 0`` registers that many LoRA tenants on
    every replica and tags requests round-robin, exercising
    adapter-affinity routing and the segmented LoRA kernel.  ``chaos``
    (a dict of seed/horizon/crashes/stalls/ooms/nan_rounds) arms a
    seeded ``FaultInjector`` against the pool."""
    from repro_torch.runtime.fabric import FabricConfig, build_fabric

    fcfg = FabricConfig(prefill_chunk=prefill_chunk,
                        tpot_target=tpot_target,
                        oversubscribe=oversubscribe, swap=swap)
    injector = _make_injector(n_replicas, chaos) if chaos else None
    fabric, cfg = build_fabric(
        arch, n_replicas, smoke=smoke, n_slots=batch_size,
        prompt_len=prompt_len, gen_tokens=gen_tokens, paged=paged,
        block_size=block_size, n_blocks=n_blocks or None,
        prefix_cache=prefix_cache, seed=seed, n_adapters=n_adapters,
        cfg=fcfg, injector=injector, device=device)
    requests = _fabric_requests(cfg, n_requests, prompt_len, gen_tokens,
                                seed, n_adapters, temperature, top_k,
                                top_p)
    out = fabric.run(requests)
    out["completed"] = sum(1 for r in requests
                           if r.completed_at is not None)
    if verbose:
        c = out["cluster"]
        print(f"fabric served {out['completed']}/{n_requests} requests "
              f"on {c['n_replicas']} replicas: "
              f"{c['generated_tokens']} tokens, "
              f"aggregate {c['throughput_sum_tok_s']:.1f} tok/s "
              f"({c['throughput_wall_tok_s']:.1f} on the shared device)")
        if n_adapters > 0 and c.get("adapters"):
            parts = ", ".join(f"{aid}: {a['requests']}"
                              for aid, a in c["adapters"].items())
            routed = sum(d["adapter_routed"]
                         for d in out["dispatchers"].values())
            print(f"  tenants ({routed} adapter-affinity routed): "
                  f"{parts}")
        for rid, row in out["replicas"].items():
            print(f"  {rid}: {row['finished']} finished, "
                  f"{row['generated_tokens']} tokens, "
                  f"{row['throughput_tok_s']:.1f} tok/s")
        if chaos:
            _print_fault_telemetry(out)
    return out


def run_combined_fabric_serving(
        arch: str, *, n_replicas: int = 2, smoke: bool = True,
        n_requests: int = 16, prompt_len: int = 32, gen_tokens: int = 16,
        batch_size: int = 4, seed: int = 0, paged: bool = False,
        block_size: int = 16, n_blocks: int = 0,
        prefix_cache: bool = False, train_batch: int = 4,
        rounds: int = 2, steps_per_round: int = 4, train_pool: int = 8,
        temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
        n_adapters: int = 0, timeout: float = 300.0,
        prefill_chunk: int = 0, tpot_target: float = 0.0,
        oversubscribe: float = 0.0, swap: bool = True,
        chaos: dict = None, device="cuda", verbose: bool = True) -> dict:
    """Live co-execution: serve the trace through the multi-replica
    fabric WHILE the launcher drives incremental FL train sessions over
    the same replicas.  ``train_pool`` fixes the fine-tuning corpus to
    that many batches cycled epoch-style (finite finetuning set; loss
    falls visibly across rounds), 0 streams fresh batches.  Returns the
    aggregate cluster summary plus the launcher's per-round
    loss/version history."""
    from repro_torch.runtime.fabric import FabricConfig, build_fabric

    fcfg = FabricConfig(
        enable_finetuning=True, train_batch=train_batch,
        bootstrap_steps=steps_per_round, steps_per_round=steps_per_round,
        min_cohort=min(2, n_replicas),
        prefill_chunk=prefill_chunk, tpot_target=tpot_target,
        oversubscribe=oversubscribe, swap=swap)
    injector = _make_injector(n_replicas, chaos) if chaos else None
    fabric, cfg = build_fabric(
        arch, n_replicas, smoke=smoke, n_slots=batch_size,
        prompt_len=prompt_len, gen_tokens=gen_tokens, paged=paged,
        block_size=block_size, n_blocks=n_blocks or None,
        prefix_cache=prefix_cache, seed=seed, train_pool=train_pool,
        n_adapters=n_adapters, cfg=fcfg, injector=injector,
        device=device)
    requests = _fabric_requests(cfg, n_requests, prompt_len, gen_tokens,
                                seed, n_adapters, temperature, top_k,
                                top_p)
    out = fabric.run(requests, min_rounds=rounds, timeout=timeout)
    out["completed"] = sum(1 for r in requests
                           if r.completed_at is not None)
    if verbose:
        c = out["cluster"]
        print(f"combined fabric served {out['completed']}/{n_requests} "
              f"requests on {c['n_replicas']} replicas while completing "
              f"{out['fl_rounds']} FL rounds: {c['generated_tokens']} "
              f"tokens, aggregate {c['throughput_sum_tok_s']:.1f} tok/s, "
              f"{c['train_steps']} fused train steps")
        for r in out["rounds"]:
            print(f"  round {r['round']}: avg member loss "
                  f"{r['avg_loss']:.4f} -> published v{r['version']} "
                  f"({r['members']} members)")
        if n_adapters > 0 and c.get("adapters"):
            for aid, a in c["adapters"].items():
                print(f"  {aid}: {a['requests']} requests, "
                      f"version {a['version_min']}..{a['version_max']}")
        for rid, row in out["replicas"].items():
            tl = row["train_loss"]
            print(f"  {rid}: v{row['adapter_version']}, "
                  f"{row['finished']} finished, "
                  f"{row['throughput_tok_s']:.1f} tok/s"
                  + (f", train CE {tl:.4f}" if tl is not None else ""))
        if chaos:
            _print_fault_telemetry(out)
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
    ap.add_argument("--replicas", type=int, default=1,
                    help="live replicas; > 1 routes the trace through "
                         "the dispatcher-backed multi-replica fabric")
    ap.add_argument("--combined", action="store_true",
                    help="co-train the LoRA adapter on every tick")
    ap.add_argument("--train-batch", type=int, default=4,
                    help="co-running train batch (--combined)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="FL rounds to drive in --combined --replicas "
                         "mode (best effort, bounded by the timeout)")
    ap.add_argument("--steps-per-round", type=int, default=4,
                    help="fused train steps per FL round in --combined "
                         "--replicas mode")
    ap.add_argument("--train-pool", type=int, default=8,
                    help="fixed fine-tuning corpus of that many batches, "
                         "cycled epoch-style, in --combined --replicas "
                         "mode (0 = fresh batches every step)")
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="paged pool size (0 = full worst case)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share identical prompt prefixes copy-on-write "
                         "over the paged pool (requires --paged)")
    ap.add_argument("--chunked-prefill", type=int, default=0,
                    help="prefill chunk in tokens (0 = monolithic "
                         "prefill); > 0 prefills each prompt in chunks "
                         "beside the decode ticks (paged mode rounds it "
                         "up to a block multiple)")
    ap.add_argument("--tpot-target", type=float, default=0.0,
                    help="decode TPOT target in seconds per token (0 = "
                         "no tick budget); > 0 budgets each tick: decode "
                         "first, then prefill chunks in deadline-slack "
                         "order, then a full, half or skipped train step")
    ap.add_argument("--oversubscribe", type=float, default=0.0,
                    help="oversubscribed KV pool watermark in (0, 1] (0 = "
                         "worst-case reservations, no preemption); > 0 "
                         "reserves only near-term need against that "
                         "fraction of the pool and preempts on exhaustion "
                         "(victims swap to host or drop and re-prefill); "
                         "requires --paged")
    ap.add_argument("--no-swap", dest="swap", action="store_false",
                    help="no host swap for preempted requests: every "
                         "victim drops its private KV and re-prefills on "
                         "restore (--oversubscribe only)")
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
    ap.add_argument("--chaos", action="store_true",
                    help="arm seeded fault injection against the fabric "
                         "(requires --replicas > 1)")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed for the chaos schedule")
    ap.add_argument("--chaos-horizon", type=float, default=5.0,
                    help="fault schedule horizon in seconds")
    ap.add_argument("--chaos-crashes", type=int, default=1,
                    help="replica crashes to schedule")
    ap.add_argument("--chaos-stalls", type=int, default=1,
                    help="straggler stalls to schedule")
    ap.add_argument("--chaos-ooms", type=int, default=0,
                    help="admission OOMs to schedule")
    ap.add_argument("--chaos-nan-rounds", type=int, default=0,
                    help="NaN-poisoned train rounds to schedule "
                         "(combined mode)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args()
    if args.prefix_cache and not args.paged:
        ap.error("--prefix-cache requires --paged (sharing rides on "
                 "pool block aliasing)")
    if args.oversubscribe and not args.paged:
        ap.error("--oversubscribe requires --paged (preemption swaps "
                 "pool blocks)")
    if args.chaos and args.replicas < 2:
        ap.error("--chaos requires --replicas > 1 (fault tolerance is "
                 "a property of the pool)")
    chaos = None
    if args.chaos:
        chaos = {"seed": args.chaos_seed, "horizon": args.chaos_horizon,
                 "crashes": args.chaos_crashes,
                 "stalls": args.chaos_stalls, "ooms": args.chaos_ooms,
                 "nan_rounds": args.chaos_nan_rounds}
    if args.replicas > 1:
        common = dict(
            n_replicas=args.replicas, smoke=args.smoke,
            n_requests=args.requests, prompt_len=args.prompt_len,
            gen_tokens=args.gen, batch_size=args.batch, paged=args.paged,
            block_size=args.block_size, n_blocks=args.n_blocks,
            prefix_cache=args.prefix_cache, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p, n_adapters=args.adapters,
            prefill_chunk=args.chunked_prefill,
            tpot_target=args.tpot_target,
            oversubscribe=args.oversubscribe, swap=args.swap,
            seed=args.seed, chaos=chaos, device=args.device)
        if args.combined:
            # the full co-execution path: launcher-driven incremental
            # train sessions over the live fabric
            out = run_combined_fabric_serving(
                args.arch, train_batch=args.train_batch,
                rounds=args.rounds, steps_per_round=args.steps_per_round,
                train_pool=args.train_pool, **common)
        else:
            out = run_multi_replica_serving(args.arch, **common)
        _exit_unserved(out)
        return
    run_serving(args.arch, smoke=args.smoke, n_requests=args.requests,
                prompt_len=args.prompt_len, gen_tokens=args.gen,
                batch_size=args.batch, combined=args.combined,
                train_batch=args.train_batch, paged=args.paged,
                block_size=args.block_size, n_blocks=args.n_blocks,
                prefix_cache=args.prefix_cache,
                prefill_chunk=args.chunked_prefill,
                tpot_target=args.tpot_target,
                oversubscribe=args.oversubscribe, swap=args.swap,
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, n_adapters=args.adapters, seed=args.seed,
                device=args.device)


if __name__ == "__main__":
    main()
