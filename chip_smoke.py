#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA Hopper card.

  python3 chip_smoke.py             every phase, then the result lines
  python3 chip_smoke.py PHASE ...   bring-up: the named phases alone
                                    (after device and build), no result
  python3 chip_smoke.py --ab DIR    A/B of the kernels' times: the
                                    package of the checkout at DIR (the
                                    parent commit, unpacked) and this one
                                    in turn, parent, change, change,
                                    parent, each in a process of its own
                                    (``--time-kernels SRC`` is one turn)

Phases, each printing JSON lines:
  device      the card (``nvidia-smi`` name and power limit), TF32 off;
  build       nvcc builds every kernel under ``src/repro_torch/csrc``,
              one process per source, all started together;
  kernel      paged_decode_attention against its plain PyTorch version,
              float32 and bfloat16, at the serving shape and ten more
              (long context, GQA, pool blocks of 128 and 256 rows, the
              serve tick after 2,048-token prompts paged in blocks of 16
              and contiguous as identity-table blocks of 32, identity-
              table blocks of 1, 2 and 8 rows, and tables that alias the
              same 48 prefix blocks, as the prefix cache makes them);
  kernel_lora lora_matmul at the decode, train, prefill, long train and
              long prefill shapes of qwen1.5-0.5b, two ragged shapes
              (M 1000 and 5), mamba2-780m's ssm_in / ssm_out at
              decode and a 2,048-token prefill, and the decode q/o and
              k/v projections of llama-3.2-vision-90b and llama3-8b,
              the training CLI's batches (qwen 4 x 128, llama3-8b 8 x 64),
              and (bf16) the rows of every M > 16 wave the serve, prefix,
              chunked and budget runs give it (qwen's suffix wave 8 x 224
              and chunk wave 8 x 256, llama3-8b's 8 x 992 and 8 x 224
              waves), plus its backward (dX, dA, dB of
              LoRAMatmulFn against autograd of the plain version) at the
              train shapes and the decode shape;
  kernel_flash flash_attention forward and backward against the plain
              version (dense f32 softmax, autograd of it) at the prefill
              waves of qwen1.5-0.5b (8 x 2,048 and 8 x 4,096) and
              llama3-8b (8 x 2,048, GQA 4:1 with head_dim 128), the
              train batches (qwen 4 x 2,048, llama3-8b 1 x 2,048), ragged
              lengths 1,000 and 2,049 and a 512-token window; the
              backward twice (dK, dV bitwise, dQ within one bf16 ulp);
              achieved TFLOP/s;
  kernel_seg  segmented_lora_matmul against its plain version at the
              multi-tenant decode (1, 4 and 8 slots) and prefill waves of
              qwen1.5-0.5b, its 4-tenant suffix wave (8 x 224), a ragged
              shape and llama3-8b's decode; in bf16
              each row bitwise lora_matmul of its own slot (B = 0 for -1
              rows) and no leak from 1e6 in an unused slot;
  kernel_ssd  ssd_scan against its plain version (the reference's chunked
              SSD at chunk 256) at mamba2-780m's prefill (H 48, P 64,
              N 128) of 32, 992, 1,000, 2,048 and 4,096 tokens, two
              requests of 512 from a random state and hymba-1.5b's heads
              (H 50, N 16), x float32 and bfloat16 as a strided view like
              the mixer's; 2,048 tokens and the two requests again with
              dt and a as the mixer makes them, so that the state
              carried from one chunk to the next shows in y; a CUDA
              input that requires grad must raise;
  kernel_decode decode_attention against its plain version at the VLM's
              cross-attention decode (8 slots, 64 heads / 8 KV, head_dim
              128, 1,601 vision tokens, K/V the transposed view of the
              [B, T, Hkv, D] projection), the same with ragged lengths and
              an empty row (exactly zero), and tests/test_kernels.py's
              three shapes; SDPA is the library time.
              Every kernel phase but the flash one also calls each
              kernel twice on the same inputs (bitwise equal, or the
              phase fails) and times the wrapper's host microseconds per
              call (``host_us``: checks, allocation, launch).
              Every kernel phase reports the worst error, kernel / plain
              / library time (CUDA events, median of REPS or FLASH_REPS,
              L2 flushed before each) and the least time the card could
              take (bytes over 3.35 TB/s, operations over the dtype's
              peak rate, whichever is larger);
  reference   the port on the card against the port on the CPU (plain
              versions) at a reduced float32 config: decode logits, one
              train step's loss, LoRA gradients and updated adapter;
              full-width logits finite and of the right shape, and a
              full-width combined_step_paged whose logits equal a
              decode_step_paged with the pre-update adapter; mamba2 at
              its reduced float32 size: prefill logits and SSM caches,
              five decode steps' logits; the VLM at a reduced float32
              size (2 units, 37 vision tokens, gates at 0.5): prefill
              logits, cross_kv, five decode steps' logits and
              decode_attention once per unit per step; the batcher's
              greedy tokens on the card and the CPU (reduced float32):
              a repeated-prefix trace with the prefix cache off, on and
              on chunked, six prompts chunked (paged 8 and 12, contiguous
              8 and 10) and monolithic, a 16-token window whose ring
              wrap copies shared blocks, and tests/test_preemption.py's
              traces oversubscribed (swap under REPRO_SANITIZE=1, drop,
              chunked, shared prefixes) beside an unbounded pool, every
              run of a trace equal, every oversubscribed run preempting;
  reference_blockwise  the same at a reduced float32 config forced onto
              the blockwise path (prefill logits and caches, one train
              step, the flash launches they make), and at full width in
              bf16 on 992 tokens each of the 24 layers' attention on the
              blockwise against the dense path, same input;
  serve       qwen1.5-0.5b at full width (24 layers, d_model 1024, bf16,
              random weights from a seed) through ``run_serving``, 16
              requests on 8 slots: paged and contiguous with 32-token
              prompts, 992-token prompts paged (blocks of 16 and of 128)
              and contiguous, 2,048-token prompts paged and contiguous,
              4,096-token prompts paged; then llama3-8b at full width,
              paged, 2,048-token prompts.  Every request finishes, the
              allocator drains, all layouts of one traffic emit the same
              tokens, and the launches are exactly as derived: the decode
              kernel once per layer per decode step, lora_matmul once per
              adapter projection per prefill wave and decode step,
              flash_attention once per layer per prefill wave past 1,024
              tokens and never below; TTFT and TPOT p50 / p99 per run;
  serve_prefix  prefix caching at full width: qwen1.5-0.5b paged, 16
              requests on 8 slots, two families sharing a 768-token prefix
              with tails of 32 to 224 tokens, 32 tokens each, cache off,
              on, and on with 4 tenants (identical prompts to different
              tenants); llama3-8b (GQA 4:1) cache off and on.  Every
              request finishes, the allocator drains, the cache hits,
              launches as derived, first logits on vs off within 2e-2
              (bf16, qwen and llama3-8b), no block aliased across
              tenants; prefill tokens computed and cached, wave times,
              TTFT / TPOT p50 / p99;
  serve_chunked  the 992 + 32 traffic paged and contiguous, prefill_chunk
              256 against monolithic: final-chunk logits within 2e-2 of the
              monolithic prefill's, launches as derived, TTFT / TPOT;
  serve_oversub  KV-pool oversubscription at full width: a 62-block chain
              of qwen's bf16 pool swapped to host and back onto fresh ids
              (moved blocks bitwise, paged_decode_attention over the
              remapped table bitwise its output over the original, swap
              GB/s each way), then 16 requests of 256 + 256 tokens on 8
              slots, paged in blocks of 16: qwen on a pool of 256 blocks
              (every slot fits) and of 160 (admission holds 5 slots), on
              160 at oversubscribe 1.0 with swap (again under
              REPRO_SANITIZE=1: no report, host ms a tick it adds) and
              without (drop and re-prefill), llama3-8b on 160 with swap;
              every request finishes, the allocator drains, the
              oversubscribed runs preempt, launches as derived; tok/s,
              TTFT / TPOT, peak blocks, preemptions, blocks swapped each
              way, tokens re-prefilled, what ``_SwapCost`` chose, swap ms
              per block and GB/s;
  static      ``static_batch_serve`` (batches of 8) against the batcher (8
              contiguous slots), qwen 32 + 16, without and with an EOS id
              that fires: the same EOS rule, launches as derived, tok/s;
  serve_ssm   mamba2-780m at full width (48 layers, d_model 1536, bf16),
              16 requests on 8 contiguous slots at 32+16, 992+32 and
              2,048+32 tokens: every request finishes, ssd_scan once per
              layer per request (SSD_LAUNCHES launches a call),
              lora_matmul once per adapter projection
              per prefill call and decode step, no attention kernel;
  serve_vlm   llama-3.2-vision-90b at published width (d_model 8192, 64
              heads / 8 KV, d_ff 28672, bf16), depth cut to 4 whole units
              (20 of 100 layers), gates at 0.5, through Engine.prefill_step
              and decode_step (the batcher refuses VLM stacks, as in the
              reference): 16 requests on 8 slots in two waves of 32-token
              prompts with their own random vision inputs, 16 tokens each;
              launches exactly as derived, and one unit's cross-attention
              at decode through the kernel against the dense path (bf16,
              2e-2);
  combined    the same servers co-training the adapter on every tick
              (``run_serving(combined=True)``, train batch 4 x prompt
              length; llama3-8b 1 x prompt length): qwen paged and
              contiguous 32+16, paged 992+32 and 2,048+32, llama3-8b paged
              2,048+32; one train step per tick with finite losses, and
              launches exactly as derived (lora_matmul: forward, then dX
              of every projection but layer 0's q/k/v; flash_attention:
              one forward per layer per prefill wave and train step, three
              backward launches per layer per train step, past 1,024
              tokens only);
  serve_adapters  multi-tenant serving at full width (4 tenants tagged
              round-robin; qwen paged and contiguous 32+16, paged 992+32 and
              2,048+32, 6 tenants on 4 device slots, co-training paged
              32+16, llama3-8b paged 32+16): every request finishes, refs
              and blocks return, launches exactly as derived
              (segmented_lora_matmul once per adapter projection per wave
              and step, lora_matmul only in the train step), tenant 0
              (b = 0) emits the single-adapter run's tokens;
  budget      co-training under a 0.1 s TPOT target, paged, 32 + 16 (4 x
              32 train rows) and 992 + 32 in chunks of 256 (4 x 992),
              through run_serving; the host ms of drawing one train
              batch (run_serving draws one every tick); train steps,
              rows per trained tick,
              skipped ticks, spend over target, TPOT, beside the combined
              phase's unbudgeted runs; every request finishes, every loss
              finite;
  mixed_solo  one wave of base and three tenants against each of them
              served alone as the single adapter on the same prompts: the
              same greedy tokens (each request in a wave of its own is
              read out beside it);
  fabric_reference  the live fabric (``runtime/fabric.py``) at the
              reduced float32 config: 2 replicas of 2 paged slots emit the
              greedy tokens of one batcher on the card and of the same
              fabric on the CPU (weights copied across), and with r1
              failed over at tick 3 the never-failed run's;
  fabric      (l-a) ``run_multi_replica_serving`` at full width: 2
              replicas of 4 paged slots over one device copy of the
              weights, 16 requests of 32 + 16, beside one batcher of 8
              slots; (l-b) the same with r1 failed over at tick 6;
              fabric and per-replica tok/s, busy shares, TTFT / TPOT, host
              ms of ``ServingFabric.tick`` and its ``ClusterController.
              tick`` share, peak memory against the weights and pools;
  fabric_combined  (l-c) ``run_combined_fabric_serving``: 2 replicas, 2
              FL rounds of 4 fused steps on a fixed pool of 4 batches,
              FedAvg and publish at the boundaries: versions >= 2 on
              both, round CE falls, every decode inside a round reads the
              published tree (bitwise at the round's end);
  fabric_chaos  (l-d) the same over 3 replicas under ``--chaos``, one
              crash and one NaN round from the seeded schedule: the NaN
              publish refused with the served tree bitwise unchanged, one
              failover for the crash, no quarantine;
  fabric_adapters  (l-e) ``run_multi_replica_serving(n_adapters=4)``:
              segmented_lora_matmul on every wave and tick, the tenant
              rollup sums to the requests finished.
              In every fabric phase the port's ``fabric.warm_up`` warms
              the replicas' shapes inside the entry point, before the
              fabric's clock starts (its seconds are printed); every
              request completes with its whole budget, every replica's
              pool ends all-free, failovers and quarantines equal the
              injected faults (the health monitor's record is printed),
              the launches are exactly as derived from the replicas'
              counts (eval probes and the train steps' microbatches
              included), and every lora_matmul / segmented_lora_matmul
              launch shape, dX included, is one that kernel_lora or
              kernel_seg held against the plain version;
  train       ten full-width train steps on one fixed 4 x 256 batch: the
              loss falls, 189 lora_matmul launches per step;
  train_cli   the training CLI (``launch/train.py``): (a)
              ``train_from_weights`` on one reduced float32 weight set on
              the card and the CPU, 15 steps with a checkpoint every 5,
              then 25 with a NaN injected at step 12 (rolled back to 10
              on both; losses within 1e-5 relative, adapters within
              2e-4); (a2) tests/test_drivers.py's check on the card (the
              reduced qwen, 30 steps of 8 x 32: held-out CE falls); (b)
              ``run_training`` at full width, qwen1.5-0.5b bf16, 4 x 256,
              20 steps, checkpoints every 10: CE on the last batch trained
              on below the initial adapter's (held-out CE reported: 20
              steps do not teach a chain over 151,936 tokens),
              lora_matmul launches exactly
              20 x 189, no flash_attention launch; host ms a step, the
              share of the loop's loss pulls, checkpoint save / wait
              seconds, peak memory; (c) ``restore=True`` to 30 steps from
              (b)'s directory: resumes at 20, runs 10, the restored tree
              bitwise (b)'s with AdamW step 20; a card checkpoint
              restored onto the CPU and a CPU one onto the card bitwise;
              (d) 4 x 2,048, 3 steps: flash_attention forward and
              backward launches as derived; (e) ``python -m
              repro_torch.launch.train --full`` in subprocesses with
              PYTHONHASHSEED pinned, 10 steps, then ``--restore`` to 15;
              the manifest's codec as this machine has it; (f) llama3-8b,
              the CLI's default arch and batch (8 x 64), 5 steps; (g)
              ``DataPipeline`` on the card yields the sample function's
              batches in order, bitwise; every lora_matmul launch shape
              of (b)-(f), dX included, one that kernel_lora checked;
  experiment  ``run_experiment`` for the five policies at
              tests/test_experiment.py's short configuration (6
              replicas, 420 s simulated, seed 3) and those tests'
              checks; printed with ``"simulated": true`` (the simulator's
              arithmetic, no card time);
  tick        where a full-width tick's time goes (serve ticks at 32-,
              992- and 2,048-token prompts, combined ticks with a 4 x 32
              and a 4 x 2,048 train batch, a serve tick of 4 tenants at 32
              tokens, mamba2-780m decode ticks after 32- and 2,048-token
              prompts, a VLM decode tick; one full, one suffix and one
              chunk prefill wave at serve_prefix's shapes): host wall per
              tick or wave, and under torch.profiler the device time,
              each kernel's share and the kernels launched;
  seconds     each phase's wall seconds and the total since the build
              began (the run must end within 1,200 s);
  kernels     one line over all ported kernels.
Bring-up only, when named: ``splits`` times decode_attention and the
lora_matmul decode path over a range of split counts (what their split
plans rest on), beside a streaming-read yardstick; ``budget_seeded`` runs
the budget phase's traffic with the train cost priced first by a warm
idle train tick (a policy the runtime does not have).
The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that.  Without a CUDA device, or without the rest of the repository, it
exits non-zero and prints no result.
"""
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

# ``--time-kernels SRC`` (a child of ``--ab``) times the package under SRC
SRC = (sys.argv[2] if sys.argv[1:2] == ["--time-kernels"]
       else os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))
sys.path.insert(0, SRC)

HBM_BYTES_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
PEAK_OPS_S = {torch.float32: 67e12,    # f32 outside the tensor cores
              torch.bfloat16: 989e12}  # dense bf16 tensor cores
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
REPS = 60
ARCH = "qwen1.5-0.5b"
N_LORA = 96         # adapter projections per forward: 24 layers x q/k/v/o
N_LORA_BWD = 93     # their dX in the backward, but layer 0's q/k/v
LORA_SCALING = 2.0  # alpha / r = 32 / 16
# kernel vs plain, relative to the plain output's largest magnitude:
# float32 sums over K <= 2816 in another order; in bfloat16 both round
# x @ A and the output to bf16, at most one ulp apart (2^-8..2^-7)
LORA_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}
# (name, M, K, N, r): qwen1.5-0.5b's q/k/v/o at each caller's M; between
# them they take the bf16 decode path and both tile widths of the M > 16
# path; then mamba2-780m's ssm_in (N = 6448: no multiple of 64) and
# ssm_out at decode (8 slots) and at a 2,048-token prefill (forward only);
# then the decode projections of llama-3.2-vision-90b's dense blocks and of
# llama3-8b (q/o: N = K; k/v: N = 8 KV heads x 128), and qwen's at 16
# slots (the decode path's second fragment of 8 rows); then, bf16 only
# (LORA_BF16_ONLY), the M > 16 calls of the serve and combined runs the
# rows above lack: qwen's 4 x 2,048 train batch and 8 x 2,048 prefill
# wave, llama3-8b's 2,048-row train batch and prefill (q/o and k/v), and
# the VLM's 8 x 32 prefill wave at its q/o; then the suffix programs'
# waves (serve_prefix, serve_chunked, budget): qwen's suffix wave (8 x
# 224 over the cached prefix) and chunk wave (8 x 256), llama3-8b's full
# wave (8 x 992) and suffix wave (q/o and k/v each); then the fabric's
# (traffic (l)): a replica's decode at 4 slots, its prefill waves of 1 and
# 3 requests of 32 (2 are the train microbatch's M, 4 the "train" row's)
# and the combined rounds' train microbatch (2 x 32 rows: train batch 4
# in grad_accum 2), whose backward runs too; then the training CLI's
# (train_cli phase) batches of 4 x 128 (qwen) and 8 x 64 (llama3-8b, the
# CLI's default arch and batch: q/o and k/v), with their backward
LORA_SHAPES = [("decode", 8, 1024, 1024, 16),          # 8 slots
               ("train", 128, 1024, 1024, 16),         # 4 x 32 tokens
               ("prefill", 256, 1024, 1024, 16),       # 8 x 32 prompt
               ("train_256", 1024, 1024, 1024, 16),    # 4 x 256 tokens
               ("train_long", 3968, 1024, 1024, 16),   # 4 x 992
               ("prefill_long", 7936, 1024, 1024, 16), # 8 x 992
               ("ragged", 1000, 1000, 2816, 16),       # no tile multiple
               ("ragged_decode", 5, 1000, 2816, 16),   # the same, M <= 16
               ("ssm_in_decode", 8, 1536, 6448, 16),
               ("ssm_in_prefill", 2048, 1536, 6448, 16),
               ("ssm_out_decode", 8, 3072, 1536, 16),
               ("ssm_out_prefill", 2048, 3072, 1536, 16),
               ("vlm_decode_qo", 8, 8192, 8192, 16),
               ("vlm_decode_kv", 8, 8192, 1024, 16),
               ("llama_decode_qo", 8, 4096, 4096, 16),
               ("llama_decode_kv", 8, 4096, 1024, 16),
               ("decode_m16", 16, 1024, 1024, 16),
               ("train_2048", 8192, 1024, 1024, 16),
               ("prefill_2048", 16384, 1024, 1024, 16),
               ("train_llama_qo", 2048, 4096, 4096, 16),
               ("train_llama_kv", 2048, 4096, 1024, 16),
               ("vlm_prefill_qo", 256, 8192, 8192, 16),
               ("suffix_1792", 1792, 1024, 1024, 16),
               ("chunk_2048", 2048, 1024, 1024, 16),
               ("llama_prefill_qo", 7936, 4096, 4096, 16),
               ("llama_prefill_kv", 7936, 4096, 1024, 16),
               ("llama_suffix_qo", 1792, 4096, 4096, 16),
               ("llama_suffix_kv", 1792, 4096, 1024, 16),
               ("fabric_decode_4", 4, 1024, 1024, 16),
               ("fabric_prefill_32", 32, 1024, 1024, 16),
               ("fabric_prefill_96", 96, 1024, 1024, 16),
               ("train_micro", 64, 1024, 1024, 16),
               ("train_cli", 512, 1024, 1024, 16),
               ("train_llama_cli_qo", 512, 4096, 4096, 16),
               ("train_llama_cli_kv", 512, 4096, 1024, 16)]
LORA_BF16_ONLY = {"train_2048", "prefill_2048", "train_llama_qo",
                  "train_llama_kv", "vlm_prefill_qo", "suffix_1792",
                  "chunk_2048", "llama_prefill_qo", "llama_prefill_kv",
                  "llama_suffix_qo", "llama_suffix_kv", "train_cli",
                  "train_llama_cli_qo", "train_llama_cli_kv"}


def lora_has_backward(name):
    """Whether phase_kernel_lora also checks a LORA_SHAPES row's
    backward (dX, dA, dB): the train rows and the decode tile's."""
    return name.startswith("train") or name in ("decode", "decode_m16")


def lora_dtypes(name):
    """The dtypes a LORA_SHAPES row runs in: float32 serves the reduced
    configs only, so the full-width M > 16 rows are bf16 alone."""
    return ((torch.bfloat16,) if name in LORA_BF16_ONLY
            else (torch.float32, torch.bfloat16))


# flash_attention, causal: (name, B, H, Hkv, D, S, window) -- every
# shape the serve and combined phases give it: the prefill waves of
# qwen1.5-0.5b (8 x 2,048 and 8 x 4,096) and llama3-8b (GQA 4:1,
# head_dim 128), the co-training train batches (qwen 4 x 2,048, llama
# 1 x 2,048); then two ragged lengths and a sliding window
FLASH_SHAPES = [("qwen_prefill", 8, 16, 16, 64, 2048, 0),
                ("qwen_prefill_4096", 8, 16, 16, 64, 4096, 0),
                ("llama_prefill", 8, 32, 8, 128, 2048, 0),
                ("qwen_train", 4, 16, 16, 64, 2048, 0),
                ("llama_train", 1, 32, 8, 128, 2048, 0),
                ("ragged_1000", 8, 16, 16, 64, 1000, 0),
                ("ragged_2049", 4, 16, 16, 64, 2049, 0),
                ("window", 4, 16, 16, 64, 2048, 512)]
FLASH_REPS = 10
# backward launches: bf16 prep (delta, lse, zeroed dQ accumulator), the
# single pass, finish (dQ rounded; dK, dV slices summed); f32 delta,
# dK/dV, dQ
FLASH_BWD = 3
# dQ of two bf16 backwards on the same inputs, relative to its largest
# value: the single pass adds each KV tile's part into f32 in whatever
# order the blocks finish, so dQ may differ by f32 rounding, which can
# move a bf16 rounding by one ulp (2^-8 of the value) at most; dK and dV
# are summed in a fixed order and must be bitwise equal
FLASH_DQ_REPEAT_TOL = 2 ** -8


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ timing ------
_FLUSH = None


def device_ms(fn, reps=REPS):
    """Median device time of ``fn`` over ``reps`` runs: each run starts
    with a cold L2 (a 64 MB write) and behind a device spin long enough
    that the host enqueues the whole of ``fn`` before the start event
    fires."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(16 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        _FLUSH.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, n=100, batches=5):
    """Host microseconds per call of ``fn`` (the wrapper's checks, its
    allocations and the launch), the device left to run behind: ``n``
    calls enqueued back to back after a synchronize, the host clock
    around them; the least of ``batches`` such runs, as the host's cores
    are shared and a run's mean moves with its neighbours."""
    fn()
    best = math.inf
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / n * 1e6


def bitwise_repeat(fn, first):
    """A second call of ``fn`` on the same inputs equals ``first`` bit for
    bit (the split kernels sum their partials in a fixed order)."""
    again = fn()
    torch.cuda.synchronize()
    return bool(torch.equal(again, first))


# ------------------------------------------------- paged decode attention -
def attention_case(b, h, hkv, d, bs, nb, dtype, seed, lengths="ragged",
                   shared=0):
    """Inputs as the runtime builds them: shuffled non-scratch blocks for
    each sequence's live range, scratch block 0 past it; kv_len ragged,
    holding 1 and a full table, or (``"tick"``) as a decode tick finds them
    in the last 32 rows of the table (2,049 to 2,080 after 2,048-token
    prompts).  With ``shared`` > 0 every table starts with the same
    ``shared`` blocks (a prefix-cache hit's aliasing) and kv_len is ragged
    past them (one row past the prefix, and a full table, among them)."""
    n_blocks = 1 + shared + b * (nb - shared)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
    kp = torch.randn((n_blocks, bs, hkv, d), generator=g,
                     device="cuda").to(dtype)
    vp = torch.randn((n_blocks, bs, hkv, d), generator=g,
                     device="cuda").to(dtype)
    rng = np.random.default_rng(seed)
    if lengths == "tick":
        kv_len = rng.integers(nb * bs - 31, nb * bs + 1,
                              size=b).astype(np.int32)
    else:
        lo = shared * bs + 1
        kv_len = rng.integers(lo, nb * bs + 1, size=b).astype(np.int32)
        kv_len[0], kv_len[1] = lo, nb * bs
    perm = rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
    tables = np.zeros((b, nb), np.int32)
    tables[:, :shared] = perm[:shared]
    used = shared
    for i in range(b):
        live = -(-int(kv_len[i]) // bs)
        tables[i, shared:live] = perm[used:used + live - shared]
        used += live - shared
    return (q, kp, vp, torch.tensor(tables, device="cuda"),
            torch.tensor(kv_len, device="cuda"))


def attention_bound(q, kp, tables, kv_len):
    """Least time for one call: each distinct pool row that some sequence
    reads below its kv_len read once (a block several tables name, once),
    q read and out written once, live table entries and kv_len read once;
    4 FLOP per (query head, live row, channel) of every sequence."""
    b, h, d = q.shape
    bs, hkv = kp.shape[1], kp.shape[2]
    lens = kv_len.long()
    elt = q.element_size()
    live_blocks = int(((lens + bs - 1) // bs).sum())
    rows_of = {}        # pool block -> rows some sequence reads
    for tbl, n in zip(tables.cpu().tolist(), lens.cpu().tolist()):
        for j in range(-(-n // bs)):
            rows_of[tbl[j]] = max(rows_of.get(tbl[j], 0),
                                  min(bs, n - j * bs))
    nbytes = (2 * q.numel() * elt + 2 * sum(rows_of.values()) * hkv * d * elt
              + 4 * live_blocks + 4 * b)
    ops = 4 * int(lens.sum()) * h * d
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[q.dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


# paged_decode_attention: the serve tick after 32-token prompts (3 pool
# blocks of 16), 1k context, llama3-8b's GQA 4:1 at head_dim 128, pool
# blocks of 128 and 256 rows, the serve tick after 2,048-token prompts
# (2,048 + 32 rows paged in blocks of 16) and its contiguous layout (2,080
# rows as identity-table blocks of 32: two TMA loads a 64-row tile), both
# with a decode tick's lengths; then the identity-table blocks of 1, 2 and
# 8 rows that contiguous caches of other lengths give (TMA boxes of fewer
# than 8 rows; the VLM's self-attention, 8 query heads per KV head); last
# the prefix cache's aliasing: every table names the same 48 prefix blocks
# (768 rows), then 14 private blocks each, lengths ragged past the prefix
PAGED_SHAPES = [
    ("serve", dict(b=8, h=16, hkv=16, d=64, bs=16, nb=3)),
    ("long", dict(b=8, h=16, hkv=16, d=64, bs=16, nb=64)),
    ("gqa", dict(b=4, h=32, hkv=8, d=128, bs=16, nb=64)),
    ("bs128", dict(b=8, h=16, hkv=16, d=64, bs=128, nb=8)),
    ("bs256", dict(b=8, h=16, hkv=16, d=64, bs=256, nb=4)),
    ("serve_2048", dict(b=8, h=16, hkv=16, d=64, bs=16, nb=130,
                        lengths="tick")),
    ("bs32", dict(b=8, h=16, hkv=16, d=64, bs=32, nb=65, lengths="tick")),
    ("bs1_g4", dict(b=2, h=16, hkv=4, d=128, bs=1, nb=301)),
    ("bs2", dict(b=4, h=16, hkv=16, d=64, bs=2, nb=150)),
    ("bs8_g8", dict(b=2, h=64, hkv=8, d=128, bs=8, nb=40)),
    ("shared", dict(b=8, h=16, hkv=16, d=64, bs=16, nb=62, shared=48)),
]


def paged_row(pda, pda_ref, q, kp, vp, tables, kv_len):
    """One paged_decode_attention row: the kernel's output, and its worst
    error against the plain version, two calls bitwise equal, the
    wrapper's host us per call, kernel / plain / SDPA time, the bound."""
    out = pda(q, kp, vp, tables, kv_len)
    ref = pda_ref(q, kp, vp, tables, kv_len)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = TOL[q.dtype]
    ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
    # the library yardstick: SDPA over the gathered cache (gather and
    # head expansion outside the timed call)
    b, nb, bs = q.shape[0], tables.shape[1], kp.shape[1]
    g = q.shape[1] // kp.shape[2]
    idx = tables.long()
    k_log = kp[idx].reshape(b, nb * bs, *kp.shape[2:]).transpose(1, 2)
    v_log = vp[idx].reshape(b, nb * bs, *vp.shape[2:]).transpose(1, 2)
    k_log = k_log.repeat_interleave(g, dim=1).contiguous()
    v_log = v_log.repeat_interleave(g, dim=1).contiguous()
    mask = (torch.arange(nb * bs, device="cuda")[None, :]
            < kv_len[:, None])[:, None, None, :]
    q4 = q[:, :, None, :]

    def lib():
        return F.scaled_dot_product_attention(q4, k_log, v_log,
                                              attn_mask=mask)

    lib_err = float((lib()[:, :, 0].float() - ref.float()).abs().max())
    row = {
        "dtype": str(q.dtype).split(".")[-1],
        "max_abs_err": err, "tol": tol, "ok": bool(ok),
        "ms": device_ms(lambda: pda(q, kp, vp, tables, kv_len)),
        "plain_ms": device_ms(lambda: pda_ref(q, kp, vp, tables, kv_len)),
        "library_ms": device_ms(lib),
        "library_max_abs_err": lib_err,
        "host_us": host_us(lambda: pda(q, kp, vp, tables, kv_len)),
        "repeat_bitwise": bitwise_repeat(
            lambda: pda(q, kp, vp, tables, kv_len), out),
    }
    row["bound_ms"], row["bound_by"] = attention_bound(q, kp, tables, kv_len)
    row["bound_us"] = row["bound_ms"] * 1e3
    return out, row


def phase_kernel(pda, pda_ref):
    """paged_decode_attention against its plain version at PAGED_SHAPES,
    float32 and bfloat16 (``paged_row``)."""
    rows = {}
    for si, (name, shp) in enumerate(PAGED_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            _, row = paged_row(pda, pda_ref, *attention_case(
                **shp, dtype=dtype, seed=100 + si))
            row = {"shape": name, **shp, **row}
            emit("kernel", kernel="paged_decode_attention", **row)
            if not (row["ok"] and row["repeat_bitwise"]):
                raise AssertionError(
                    f"paged_decode_attention {name} {dtype}: kernel vs "
                    f"plain max abs err {row['max_abs_err']} beyond "
                    f"{row['tol']}, or two calls on the same inputs differ")
            rows[(name, dtype)] = row
    return rows


# ------------------------------------------------------------- lora -------
def lora_case(m, k, n, r, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda")
    w = torch.randn((k, n), generator=g, device="cuda") / k ** 0.5
    a = torch.randn((k, r), generator=g, device="cuda") / k ** 0.5
    b = torch.randn((r, n), generator=g, device="cuda") * 0.1
    return tuple(t.to(dtype) for t in (x, w, a, b))


def lora_bound(m, k, n, r, dtype):
    """Least time for one call: x, W, A, B read once, the output written
    once; 2 FLOP per multiply-add of x @ W, x @ A and (x @ A) @ B."""
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = (m * k + k * n + k * r + r * n + m * n) * elt
    ops = 2 * m * k * n + 2 * m * k * r + 2 * m * r * n
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def _rel_err(out, ref):
    return float((out.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def check_views(lm, lm_ref):
    """bf16 operands as views the wrapper takes but a contiguous tensor
    never gives: x a K slice of a wider buffer, W and B column slices
    (N = 1,020, no multiple of 8: the M > 16 kernel stores those rows
    itself, the row stride being no whole 16 bytes for a TMA store),
    forward and the backward's transposed views, at M 8 and 300."""
    for m in (8, 300):
        x, w, a, b = lora_case(m, 520, 1024, 16, torch.bfloat16, 290 + m)
        xv, wv, av, bv = x[:, :516], w[:516, :1020], a[:516], b[:, :1020]
        dy = torch.randn((m, 1024), device="cuda").to(torch.bfloat16)
        dyv = dy[:, :1020]
        errs = {
            "forward": _rel_err(lm(xv, wv, av, bv, LORA_SCALING),
                                lm_ref(xv, wv, av, bv, LORA_SCALING)),
            "dx": _rel_err(lm(dyv, wv.t(), bv.t(), av.t(), LORA_SCALING),
                           lm_ref(dyv, wv.t(), bv.t(), av.t(),
                                  LORA_SCALING))}
        emit("kernel_views", kernel="lora_matmul", M=m, K=516, N=1020,
             rel_tol=LORA_TOL[torch.bfloat16],
             **{f"{k}_rel_err": e for k, e in errs.items()})
        if max(errs.values()) > LORA_TOL[torch.bfloat16]:
            raise AssertionError(f"lora_matmul views at M {m}: {errs}")


def phase_kernel_lora(lm, lm_ref, fn_cls):
    """lora_matmul against its plain version at the main path's shapes,
    then its backward at the train shapes and at the decode shape (the
    transposed operands on the M <= 16 tile)."""
    rows = {}
    for si, (name, m, k, n, r) in enumerate(LORA_SHAPES):
        for dtype in lora_dtypes(name):
            x, w, a, b = lora_case(m, k, n, r, dtype, 200 + si)
            out = lm(x, w, a, b, LORA_SCALING)
            ref = lm_ref(x, w, a, b, LORA_SCALING)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            rel = _rel_err(out, ref)
            # the library yardstick: one product with the merged weight
            # (the merge is outside the timed call; the port never merges)
            merged = w + LORA_SCALING * (a @ b)
            row = {
                "shape": name, "M": m, "K": k, "N": n, "r": r,
                "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
                "rel_err": rel, "rel_tol": LORA_TOL[dtype],
                "ms": device_ms(lambda: lm(x, w, a, b, LORA_SCALING)),
                "plain_ms": device_ms(
                    lambda: lm_ref(x, w, a, b, LORA_SCALING)),
                "library_ms": device_ms(lambda: x @ merged),
                "base_only_ms": device_ms(lambda: x @ w),
                "host_us": host_us(lambda: lm(x, w, a, b, LORA_SCALING)),
                "repeat_bitwise": bitwise_repeat(
                    lambda: lm(x, w, a, b, LORA_SCALING), out),
            }
            row["bound_ms"], row["bound_by"] = lora_bound(m, k, n, r, dtype)
            emit("kernel", kernel="lora_matmul", **row)
            if not rel <= LORA_TOL[dtype]:
                raise AssertionError(
                    f"lora_matmul {name} {dtype}: kernel vs plain error "
                    f"{rel} of the largest output, beyond {LORA_TOL[dtype]}")
            if not row["repeat_bitwise"]:
                raise AssertionError(f"lora_matmul {name} {dtype}: two calls "
                                     "on the same inputs differ")
            rows[(name, dtype)] = row
    check_views(lm, lm_ref)
    for name, m, k, n, r in LORA_SHAPES:
        if not lora_has_backward(name):
            continue
        for dtype in lora_dtypes(name):
            x, w, a, b = lora_case(m, k, n, r, dtype, 300)
            dy = torch.randn((m, n), device="cuda").to(dtype)
            xk, ak, bk = (t.clone().requires_grad_() for t in (x, a, b))
            got = torch.autograd.grad(
                fn_cls.apply(xk, w, ak, bk, LORA_SCALING), (xk, ak, bk), dy)
            xr, ar, br = (t.clone().requires_grad_() for t in (x, a, b))
            want = torch.autograd.grad(
                lm_ref(xr, w, ar, br, LORA_SCALING), (xr, ar, br), dy)
            errs = {g: _rel_err(u, v)
                    for g, u, v in zip(("dx", "da", "db"), got, want)}
            # bf16: the kernel path rounds t = s dY B^T and x A to bf16
            # before the rank-r products, autograd of the plain version
            # only at the end: a bf16 ulp of those, as in the forward
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            emit("kernel_backward", kernel="lora_matmul", shape=name,
                 M=m, dtype=str(dtype).split(".")[-1], rel_tol=tol,
                 **{f"{g}_rel_err": e for g, e in errs.items()})
            if max(errs.values()) > tol:
                raise AssertionError(
                    f"LoRAMatmulFn {name} {dtype}: {errs} beyond {tol}")
    return rows


# --------------------------------------------------- segmented lora ------
# (name, M, K, N, r, slots, rows per sequence): qwen1.5-0.5b's q/k/v/o at
# decode (8 slots, one row each) with 1, 4 and 8 adapter slots, its
# prefill waves (8 sequences of 32, 992 and 2,048 tokens, a slot per
# sequence), a ragged shape with a slot per row, llama3-8b's decode
# projections (k/v: N 1024; q/o: N 4096), qwen's decode at 16 slots, and
# the 4-tenant suffix wave (8 x 224 over the cached prefix); then the
# 4-tenant fabric's (traffic (l)): a replica's decode at 4 slots and its
# prefill waves of 1 to 4 requests of 32
SEG_SHAPES = [("decode", 8, 1024, 1024, 16, 4, 1),
              ("decode_a1", 8, 1024, 1024, 16, 1, 1),
              ("decode_a8", 8, 1024, 1024, 16, 8, 1),
              ("prefill", 256, 1024, 1024, 16, 4, 32),
              ("prefill_992", 7936, 1024, 1024, 16, 4, 992),
              ("prefill_2048", 16384, 1024, 1024, 16, 4, 2048),
              ("ragged", 1000, 1000, 2816, 16, 4, 1),
              ("llama_decode_kv", 8, 4096, 1024, 16, 4, 1),
              ("llama_decode", 8, 4096, 4096, 16, 4, 1),
              ("decode_m16", 16, 1024, 1024, 16, 4, 1),
              ("suffix_224", 1792, 1024, 1024, 16, 4, 224),
              ("fabric_decode_4", 4, 1024, 1024, 16, 4, 1),
              ("fabric_prefill_32", 32, 1024, 1024, 16, 4, 32),
              ("fabric_prefill_64", 64, 1024, 1024, 16, 4, 32),
              ("fabric_prefill_96", 96, 1024, 1024, 16, 4, 32),
              ("fabric_prefill_128", 128, 1024, 1024, 16, 4, 32)]
SEG_REPS = 30


def seg_case(m, k, n, r, na, seq, dtype, seed):
    """Inputs as the registry and the model give them: stacks [NA, K, r]
    / [NA, r, N]; one slot per sequence of ``seq`` rows, drawn over every
    slot and -1, each present where the sequences allow."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda")
    w = torch.randn((k, n), generator=g, device="cuda") / k ** 0.5
    a = torch.randn((na, k, r), generator=g, device="cuda") / k ** 0.5
    b = torch.randn((na, r, n), generator=g, device="cuda") * 0.1
    ns = m // seq
    idx = np.random.default_rng(seed).integers(-1, na, ns).astype(np.int32)
    idx[:min(ns, na + 1)] = np.arange(-1, na)[:ns]
    return tuple(t.to(dtype) for t in (x, w, a, b)) + (
        torch.tensor(np.repeat(idx, seq), device="cuda"),)


def seg_bound(m, k, n, r, idx, dtype):
    """Least time for one call: x, W, the stacks of the slots the rows
    use, the row index read once, the output written once; 2 FLOP per
    multiply-add of x @ W and of each adapter row's own x @ A and
    (x @ A) @ B."""
    elt = torch.empty((), dtype=dtype).element_size()
    used = int(torch.unique(idx[idx >= 0]).numel())
    rows = int((idx >= 0).sum())
    nbytes = (m * k + k * n + used * (k * r + r * n) + m * n) * elt + 4 * m
    ops = 2 * m * k * n + 2 * rows * (k * r + r * n)
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_seg(seg, seg_ref, lm):
    """segmented_lora_matmul against its plain version at the main path's
    shapes, rows mixing every slot and -1 (error relative to the largest
    output).  In bf16 also: each row bitwise equal to lora_matmul with
    its own slot's A and B at the same M, each -1 row to lora_matmul with
    B = 0, and an output that does not move when a slot no row uses
    holds 1e6.  Times: kernel, plain version, lora_matmul of one adapter
    at the same M, and the base product alone (``torch.matmul``: no
    PyTorch call computes per-row adapters; the fused kernel cannot beat
    it)."""
    rows_out = {}
    for si, (name, m, k, n, r, na, seq) in enumerate(SEG_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, w, a, b, idx = seg_case(m, k, n, r, na, seq, dtype, 500 + si)
            out = seg(x, w, a, b, idx, LORA_SCALING)
            ref = seg_ref(x, w, a, b, idx, LORA_SCALING)
            torch.cuda.synchronize()
            rel = _rel_err(out, ref)
            row = {
                "shape": name, "M": m, "K": k, "N": n, "r": r, "slots": na,
                "rows_per_sequence": seq, "dtype": str(dtype).split(".")[-1],
                "max_abs_err": float((out.float() - ref.float()).abs().max()),
                "rel_err": rel, "rel_tol": LORA_TOL[dtype],
            }
            ok = rel <= LORA_TOL[dtype]
            if dtype == torch.bfloat16:
                # every row against lora_matmul of its own slot, same M
                same = True
                for sl in range(-1, na):
                    bs = b[sl] if sl >= 0 else torch.zeros_like(b[0])
                    one = lm(x, w, a[max(sl, 0)], bs, LORA_SCALING)
                    mask = idx == sl
                    same &= bool(torch.equal(out[mask], one[mask]))
                # a slot no row reads may hold anything finite
                idx2 = torch.where(idx == na - 1, -1, idx)
                clean = seg(x, w, a, b, idx2, LORA_SCALING)
                a2, b2 = a.clone(), b.clone()
                a2[na - 1], b2[na - 1] = 1e6, 1e6
                poisoned = seg(x, w, a2, b2, idx2, LORA_SCALING)
                no_leak = bool(torch.equal(poisoned, clean)
                               and torch.isfinite(poisoned).all())
                row.update(rows_bitwise_lora_matmul=same,
                           poison_1e6_no_leak=no_leak)
                ok = ok and same and no_leak
                del clean, poisoned, a2, b2
            row.update(
                ms=device_ms(lambda: seg(x, w, a, b, idx, LORA_SCALING),
                             SEG_REPS),
                plain_ms=device_ms(
                    lambda: seg_ref(x, w, a, b, idx, LORA_SCALING), SEG_REPS),
                lora_matmul_ms=device_ms(
                    lambda: lm(x, w, a[0], b[0], LORA_SCALING), SEG_REPS),
                library_ms=device_ms(lambda: x @ w, SEG_REPS),
                library="base-only torch.matmul (a floor: no PyTorch call "
                        "computes the per-row adapters)",
                host_us=host_us(lambda: seg(x, w, a, b, idx, LORA_SCALING)),
                repeat_bitwise=bitwise_repeat(
                    lambda: seg(x, w, a, b, idx, LORA_SCALING), out))
            ok = ok and row["repeat_bitwise"]
            row["bound_ms"], row["bound_by"] = seg_bound(m, k, n, r, idx,
                                                         dtype)
            emit("kernel", kernel="segmented_lora_matmul", **row)
            if not ok:
                raise AssertionError(
                    f"segmented_lora_matmul {name} {dtype}: error {rel} of "
                    f"the largest output (tolerance {LORA_TOL[dtype]}), "
                    f"bitwise rows {row.get('rows_bitwise_lora_matmul')}, "
                    f"poison {row.get('poison_1e6_no_leak')}, repeat "
                    f"bitwise {row['repeat_bitwise']}")
            rows_out[(name, dtype)] = row
            del x, w, a, b, idx, out, ref
            torch.cuda.empty_cache()
    return rows_out


# ------------------------------------------------------- flash attention --
def causal_pairs(s, window):
    """Allowed (query, key) pairs of one causal head of length s."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_bound(b, h, hkv, d, s, window, dtype, backward):
    """Least time for one call.  Forward: q, k, v read, o and the f32 lse
    written; 4 FLOP per allowed (query, key) pair and channel (q k^T and
    P V).  Backward: q, k, v, o, dO and lse read, dq, dk, dv written;
    10 FLOP per pair and channel (q k^T again, dP, dV, dQ, dK)."""
    elt = torch.empty((), dtype=dtype).element_size()
    q_elems, kv_elems = b * h * s * d, b * hkv * s * d
    if backward:
        nbytes = (3 * q_elems + 2 * kv_elems) * elt + 4 * b * h * s \
            + (q_elems + 2 * kv_elems) * elt
        ops = 10 * d * causal_pairs(s, window) * b * h
    else:
        nbytes = (2 * q_elems + 2 * kv_elems) * elt + 4 * b * h * s
        ops = 4 * d * causal_pairs(s, window) * b * h
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_flash(fa):
    """flash_attention forward and backward against their plain versions
    (the dense f32 softmax and autograd of it) at the main path's
    shapes, inputs in the model's [B, S, H, D] layout passed as
    [B, H, S, D] views as the model passes them.  Errors relative to the
    largest output or gradient.  The backward runs twice on the same
    inputs: dK and dV bitwise equal, dQ within FLASH_DQ_REPEAT_TOL.
    Times: kernel, plain version, and scaled_dot_product_attention
    (forward; for the backward, autograd of its output) as the library
    yardstick, never called by the port; achieved TFLOP/s (the bound's
    operations over the time) of kernel and library."""
    rows = {}
    for si, (name, b, h, hkv, d, s, w) in enumerate(FLASH_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(400 + si)

            def draw(heads):
                return torch.randn((b, s, heads, d), generator=g,
                                   device="cuda").to(dtype).transpose(1, 2)

            q, k, v, do = draw(h), draw(hkv), draw(hkv), draw(h)
            kw = dict(causal=True, window=w)
            o, lse = fa.flash_attention_fwd(q, k, v, **kw)
            out = o
            ref = fa.flash_attention_ref(q, k, v, **kw)
            got = fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
            again = fa.flash_attention_backward(q, k, v, o, lse, do, **kw)
            want = fa.flash_attention_grad_ref(q, k, v, do, **kw)
            torch.cuda.synchronize()
            repeat = {"dk_bitwise": bool(torch.equal(got[1], again[1])),
                      "dv_bitwise": bool(torch.equal(got[2], again[2])),
                      "dq_rel_diff": _rel_err(again[0], got[0])}
            del again
            tol = TOL[dtype]
            err = _rel_err(out, ref)
            gerr = {n: _rel_err(x, y)
                    for n, x, y in zip(("dq", "dk", "dv"), got, want)}
            # the library yardstick: SDPA on the same views
            if w:
                qpos = torch.arange(s, device="cuda")
                mask = (qpos[None, :] <= qpos[:, None]) \
                    & (qpos[:, None] - qpos[None, :] < w)
                lib_kw = dict(attn_mask=mask)
            else:
                lib_kw = dict(is_causal=True)

            def lib(q_, k_, v_):
                return F.scaled_dot_product_attention(
                    q_, k_, v_, enable_gqa=h != hkv, **lib_kw)

            lib_err = _rel_err(lib(q, k, v), ref)
            qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
            lib_out = lib(qs, ks, vs)
            row = {
                "shape": name, "B": b, "H": h, "Hkv": hkv, "D": d, "S": s,
                "window": w, "dtype": str(dtype).split(".")[-1],
                "rel_err": err, "rel_tol": tol,
                "max_abs_err": float((out.float() - ref.float()).abs().max()),
                **{f"{n}_rel_err": e for n, e in gerr.items()},
                "bwd_max_abs_err": max(float((x.float() - y.float()).abs()
                                             .max())
                                       for x, y in zip(got, want)),
                "library_rel_err": lib_err,
                "ms": device_ms(lambda: fa.flash_attention_fwd(q, k, v, **kw),
                                FLASH_REPS),
                "plain_ms": device_ms(
                    lambda: fa.flash_attention_ref(q, k, v, **kw),
                    FLASH_REPS),
                "library_ms": device_ms(lambda: lib(q, k, v), FLASH_REPS),
                "bwd_ms": device_ms(
                    lambda: fa.flash_attention_backward(q, k, v, o, lse, do,
                                                        **kw), FLASH_REPS),
                # the plain backward recomputes its forward under autograd
                "bwd_plain_ms": device_ms(
                    lambda: fa.flash_attention_grad_ref(q, k, v, do, **kw),
                    FLASH_REPS),
                "bwd_library_ms": device_ms(
                    lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do,
                                                retain_graph=True),
                    FLASH_REPS),
            }
            row["bound_ms"], row["bound_by"] = flash_bound(
                b, h, hkv, d, s, w, dtype, backward=False)
            row["bwd_bound_ms"], row["bwd_bound_by"] = flash_bound(
                b, h, hkv, d, s, w, dtype, backward=True)
            # achieved rate: the bound's operations over the kernel time
            ops = 4 * d * causal_pairs(s, w) * b * h
            row["tflops"] = ops / row["ms"] * 1e-9
            row["bwd_tflops"] = 2.5 * ops / row["bwd_ms"] * 1e-9
            row["library_tflops"] = ops / row["library_ms"] * 1e-9
            row["bwd_library_tflops"] = 2.5 * ops / row["bwd_library_ms"] \
                * 1e-9
            row.update(backward_twice=repeat,
                       dq_repeat_tol=FLASH_DQ_REPEAT_TOL)
            emit("kernel", kernel="flash_attention", **row)
            if not (err <= tol and max(gerr.values()) <= tol):
                raise AssertionError(
                    f"flash_attention {name} {dtype}: forward {err}, "
                    f"backward {gerr} of the largest value, beyond {tol}")
            if not (repeat["dk_bitwise"] and repeat["dv_bitwise"]
                    and repeat["dq_rel_diff"] <= FLASH_DQ_REPEAT_TOL):
                raise AssertionError(
                    f"flash_attention {name} {dtype}: two backwards on the "
                    f"same inputs differ: {repeat}")
            rows[(name, dtype)] = row
            del q, k, v, do, out, ref, o, lse, got, want, qs, ks, vs, lib_out
            torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------- ssd scan ---
# (name, B, S, H, P, N, random init_state, inputs): mamba2-780m's prefill
# (one request, 48 heads of P = 64, N = 128) at the serve runs' prompt
# lengths and 4,096, a length that is no multiple of any chunk, two
# requests continuing from a state, and hymba-1.5b's heads (H = 50,
# N = 16), with ``tests/test_kernels.py``'s distributions; then two of
# them with dt and a as the mixer makes them, where a chunk's decay
# leaves the state carried into the next one visible (with the test
# distributions it decays by about e^-50 over one 64-row chunk)
SSD_SHAPES = [("mamba_32", 1, 32, 48, 64, 128, False, "test"),
              ("mamba_992", 1, 992, 48, 64, 128, False, "test"),
              ("mamba_2048", 1, 2048, 48, 64, 128, False, "test"),
              ("mamba_4096", 1, 4096, 48, 64, 128, False, "test"),
              ("ragged_1000", 1, 1000, 48, 64, 128, False, "test"),
              ("init_b2_512", 2, 512, 48, 64, 128, True, "test"),
              ("hymba_2048", 1, 2048, 50, 64, 16, False, "test"),
              ("mixer_2048", 1, 2048, 48, 64, 128, False, "mixer"),
              ("mixer_init_b2_512", 2, 512, 48, 64, 128, True, "mixer")]
SSD_CHUNK = 256     # the plain version's chunk (mamba2-780m's ssm_chunk)
SSD_TOL_Y = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
SSD_TOL_STATE = 1e-4
SSD_REPS = 10
# ssd_scan launches per call: the prep pass (C B^T once per chunk), then
# the chunk-parallel scan
SSD_LAUNCHES = 2


def ssd_case(b, s, h, p, n, init, dtype, seed, inputs="test"):
    """Inputs as the mixer gives them: x and B/C slices of one conv output
    ``[B, S, H*P + 2N]`` in x's dtype (x a strided view, B and C cast to
    float32: a copy in bf16, the view itself in float32).  ``"test"``:
    dt = softplus of a normal, a = -exp(0.3 * normal), the distributions
    of ``tests/test_kernels.py::test_ssd_scan``; ``"mixer"``: dt =
    softplus(normal + dt_bias) and a = -exp(A_log) as ``mamba2.init_ssm``
    sets them (dt_bias = log(expm1(0.01)), A_log = log(linspace(1, 16)))."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    di = h * p
    conv = torch.randn((b, s, di + 2 * n), generator=g, device="cuda")
    conv[..., di:] *= 0.3
    conv = conv.to(dtype)
    x = conv[..., :di].reshape(b, s, h, p)
    bm = conv[..., di:di + n].float()
    cm = conv[..., di + n:].float()
    z = torch.randn((b, s, h), generator=g, device="cuda")
    if inputs == "mixer":
        dt = F.softplus(z + math.log(math.expm1(0.01)))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
    else:
        dt = F.softplus(z)
        a = -torch.exp(torch.randn((h,), generator=g, device="cuda") * 0.3)
    st = torch.randn((b, h, p, n), generator=g, device="cuda") if init \
        else None
    return x, dt, a, bm, cm, st


def ssd_bound(b, s, h, p, n, init, dtype, chunk=SSD_CHUNK):
    """Least time for one call: x, dt, a, B, C (and the initial state)
    read once, y and the final state written once; the float32 operations
    of the chunked form at the reference's chunk (2 FLOP per multiply-add):
    C B^T over each chunk's causal (i >= j) pairs once per (batch, chunk),
    as the single B/C group shares it across heads, and per head the
    scores' product with x over those pairs, C state^T and the state
    update in full."""
    elt = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * b * s * h * p * elt + 4 * (b * s * h + h + 2 * b * s * n) \
        + 4 * b * h * p * n * (2 if init else 1)
    shared = per_head = 0
    for lo in range(0, s, chunk):
        r = min(chunk, s - lo)
        pairs = r * (r + 1) // 2
        shared += 2 * pairs * n
        per_head += 2 * pairs * p + 4 * r * p * n
    ops = b * shared + b * h * per_head
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[torch.float32]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_ssd(ssd):
    """ssd_scan against its plain version (``ssd_chunked``'s arithmetic at
    the reference's chunk of 256) at the prefill shapes, x in float32 and
    bfloat16: y and the final state relative to their largest values.
    Times: kernel, plain version; no PyTorch call computes an SSD scan.
    A CUDA call with an input that requires grad must raise."""
    rows = {}
    for si, (name, b, s, h, p, n, init, inputs) in enumerate(SSD_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a, bm, cm, st = ssd_case(b, s, h, p, n, init, dtype,
                                            600 + si, inputs)
            y, fin = ssd.ssd_scan(x, dt, a, bm, cm, init_state=st)
            yr, finr = ssd.ssd_scan_ref(x, dt, a, bm, cm, chunk=SSD_CHUNK,
                                        init_state=st)
            torch.cuda.synchronize()
            ey, es = _rel_err(y, yr), _rel_err(fin, finr)
            finite = bool(torch.isfinite(y).all() and torch.isfinite(fin).all())
            row = {
                "shape": name, "B": b, "S": s, "H": h, "P": p, "N": n,
                "init_state": init, "inputs": inputs,
                "dtype": str(dtype).split(".")[-1],
                "x_strides": list(x.stride()),
                "y_rel_err": ey, "y_rel_tol": SSD_TOL_Y[dtype],
                "state_rel_err": es, "state_rel_tol": SSD_TOL_STATE,
                "max_abs_err": float((y.float() - yr.float()).abs().max()),
                "state_max_abs_err": float((fin - finr).abs().max()),
                "finite": finite,
                "ms": device_ms(lambda: ssd.ssd_scan(x, dt, a, bm, cm,
                                                     init_state=st),
                                SSD_REPS),
                "plain_ms": device_ms(
                    lambda: ssd.ssd_scan_ref(x, dt, a, bm, cm,
                                             chunk=SSD_CHUNK, init_state=st),
                    SSD_REPS),
                "library_ms": None,
                "host_us": host_us(lambda: ssd.ssd_scan(
                    x, dt, a, bm, cm, init_state=st), 20),
            }
            y2, fin2 = ssd.ssd_scan(x, dt, a, bm, cm, init_state=st)
            torch.cuda.synchronize()
            row["repeat_bitwise"] = bool(torch.equal(y2, y)
                                         and torch.equal(fin2, fin))
            row["bound_ms"], row["bound_by"] = ssd_bound(b, s, h, p, n, init,
                                                         dtype)
            emit("kernel", kernel="ssd_scan", **row)
            if not (finite and ey <= SSD_TOL_Y[dtype] and es <= SSD_TOL_STATE
                    and row["repeat_bitwise"]):
                raise AssertionError(
                    f"ssd_scan {name} {dtype}: y {ey}, state {es} of the "
                    "largest value, beyond tolerance (or not finite), or two "
                    "calls on the same inputs differ")
            rows[(name, dtype)] = row
            del x, dt, a, bm, cm, st, y, fin, yr, finr, y2, fin2
            torch.cuda.empty_cache()
    x, dt, a, bm, cm, _ = ssd_case(1, 64, 48, 64, 128, False, torch.float32,
                                   700)
    try:
        ssd.ssd_scan(x.clone().requires_grad_(), dt, a, bm, cm)
    except NotImplementedError as e:
        emit("kernel_grad_check", kernel="ssd_scan", raised=str(e))
    else:
        raise AssertionError("ssd_scan: a CUDA input that requires grad did "
                             "not raise")
    return rows


# ------------------------------------------- contiguous decode attention --
VLM_ARCH = "llama-3.2-vision-90b"
VLM_LAYERS = 20     # 4 whole units of 4 dense blocks and a cross block
# decode_attention: (name, B, H, Hkv, D, S, layout, lengths) -- the VLM's
# cross-attention at decode (8 slots over 1,601 vision tokens, K/V the
# [B, T, Hkv, D] projection's transposed view), the same with ragged
# lengths and an empty row, then tests/test_kernels.py's three shapes
# (head-major contiguous caches, lengths from 1 to S)
DECODE_SHAPES = [("cross", 8, 64, 8, 128, 1601, "view", "full"),
                 ("cross_ragged", 8, 64, 8, 128, 1601, "view", "ragged"),
                 ("test_512", 2, 8, 2, 64, 512, "contiguous", "ragged"),
                 ("test_300", 3, 4, 4, 128, 300, "contiguous", "ragged"),
                 ("test_1024", 1, 16, 2, 64, 1024, "contiguous", "ragged")]


def decode_case(b, h, hkv, d, s, layout, lengths, dtype, seed):
    """q [B, H, D]; K/V [B, Hkv, S, D] as the model passes them (the
    transposed view of [B, S, Hkv, D]) or contiguous; kv_len all S, or
    ragged from 1 to S with the last row S (``cross_ragged``: the first
    row 0)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
    shape = (b, s, hkv, d) if layout == "view" else (b, hkv, s, d)
    k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
            for _ in range(2))
    if layout == "view":
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    rng = np.random.default_rng(seed)
    kv_len = np.full(b, s, np.int32)
    if lengths == "ragged":
        kv_len[:-1] = rng.integers(1, s + 1, size=b - 1)
        if layout == "view":
            kv_len[0] = 0
    return q, k, v, torch.tensor(kv_len, device="cuda")


def decode_bound(q, k, kv_len):
    """Least time for one call: K/V rows up to kv_len read once, q read
    and out written once, kv_len read once; 4 FLOP per (query head, live
    row, channel)."""
    b, h, d = q.shape
    hkv, elt = k.shape[1], q.element_size()
    live = int(kv_len.long().sum())
    nbytes = 2 * q.numel() * elt + 2 * live * hkv * d * elt + 4 * b
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = 4 * live * h * d / PEAK_OPS_S[q.dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_decode(dattn, dattn_ref):
    """decode_attention against its plain version, float32 and bfloat16,
    at DECODE_SHAPES: the worst error (a kv_len == 0 row must be exactly
    zero), kernel / plain / SDPA time, the bound."""
    gqa = "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or "")
    rows = {}
    for si, (name, b, h, hkv, d, s, layout, lengths) in \
            enumerate(DECODE_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, kv_len = decode_case(b, h, hkv, d, s, layout, lengths,
                                          dtype, 800 + si)
            out = dattn(q, k, v, kv_len)
            ref = dattn_ref(q, k, v, kv_len)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            tol = TOL[dtype]
            ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
            empty = kv_len == 0
            zero_rows_exact = bool((out[empty] == 0).all())
            # the library yardstick: SDPA over the same K/V, masked at
            # kv_len (GQA natively where this PyTorch has it, else K/V
            # repeated to H heads outside the timed call)
            q4 = q[:, :, None, :]
            mask = (torch.arange(s, device="cuda")[None, :]
                    < kv_len[:, None])[:, None, None, :]
            if gqa:
                kl, vl, extra = k, v, {"enable_gqa": True}
            else:
                kl = k.repeat_interleave(h // hkv, dim=1)
                vl = v.repeat_interleave(h // hkv, dim=1)
                extra = {}

            def lib():
                return F.scaled_dot_product_attention(
                    q4, kl, vl, attn_mask=mask, **extra)

            live = ~empty            # SDPA gives NaN on an all-masked row
            lib_err = float((lib()[live, :, 0].float()
                             - ref[live].float()).abs().max())
            row = {
                "shape": name, "B": b, "H": h, "Hkv": hkv, "D": d, "S": s,
                "layout": layout, "lengths": lengths,
                "k_strides": list(k.stride()),
                "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err, "tol": tol, "ok": bool(ok),
                "empty_rows": int(empty.sum()),
                "empty_rows_exactly_zero": zero_rows_exact,
                "ms": device_ms(lambda: dattn(q, k, v, kv_len)),
                "plain_ms": device_ms(lambda: dattn_ref(q, k, v, kv_len)),
                "library_ms": device_ms(lib),
                "host_us": host_us(lambda: dattn(q, k, v, kv_len)),
                "repeat_bitwise": bitwise_repeat(
                    lambda: dattn(q, k, v, kv_len), out),
                "library": "SDPA" + (" enable_gqa" if gqa else
                                     " over K/V repeated to H heads"),
                "library_max_abs_err": lib_err,
            }
            row["bound_ms"], row["bound_by"] = decode_bound(q, k, kv_len)
            row["bound_us"] = row["bound_ms"] * 1e3
            emit("kernel", kernel="decode_attention", **row)
            if not (ok and zero_rows_exact and row["repeat_bitwise"]):
                raise AssertionError(
                    f"decode_attention {name} {dtype}: kernel vs plain max "
                    f"abs err {err} beyond {tol}, an empty row not zero, or "
                    "two calls on the same inputs differ")
            rows[(name, dtype)] = row
            del q, k, v, kv_len, out, ref, kl, vl, mask
            torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------- split sweeps --
def _kernel_us(fn, n=5):
    """Device us per call of each kernel ``fn`` launches (torch.profiler
    over ``n`` calls, L2 warm)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0]
            out[name] = out.get(name, 0.0) + _device_us(e) / n
    return out


SWEEP_SPLITS = (1, 2, 4, 8, 13, 26)
SWEEP_LORA_SPLITS = (4, 8, 11, 16, 22, 32)


def phase_splits():
    """Bring-up: what the split plans rest on.  decode_attention (bf16)
    at the cross shape over SWEEP_SPLITS splits, with K/V as the model's
    transposed view and as a contiguous copy; ssd_scan (x bf16) at every
    SSD_SHAPES entry, with the errors the kernel phase checks and each
    of its kernels' device us (torch.profiler); lora_matmul and
    segmented_lora_matmul (bf16, one plan for both) at every decode shape
    over SWEEP_LORA_SPLITS splits and the plan's own; as
    yardsticks a torch sum over 128 MB of bf16 (a streaming read) and a
    device spin of one cycle (the timing's floor).  Device ms as the
    kernel phases time them."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import lora_matmul as lmm
    big = torch.ones(64 << 20, dtype=torch.bfloat16, device="cuda")
    emit("splits", yardstick="sum of 128 MB bf16",
         ms=device_ms(lambda: big.sum()), bytes=big.numel() * 2)
    del big
    emit("splits", yardstick="torch.cuda._sleep(1)",
         ms=device_ms(lambda: torch.cuda._sleep(1)))
    b, h, hkv, d, s, layout, lengths = DECODE_SHAPES[0][1:]
    q, k, v, kv_len = decode_case(b, h, hkv, d, s, layout, lengths,
                                  torch.bfloat16, 800)
    kc, vc = k.contiguous(), v.contiguous()
    plan = da.split_plan_bf16
    tiles = -(-s // da.BF16_TILE_ROWS)
    try:
        for want in SWEEP_SPLITS:
            per = -(-tiles // want)
            da.split_plan_bf16 = \
                lambda *_, per=per: (-(-tiles // per), per * da.BF16_TILE_ROWS)
            emit("splits", kernel="decode_attention", shape="cross",
                 splits=-(-tiles // per),
                 view_ms=device_ms(lambda: da.decode_attention(q, k, v,
                                                               kv_len)),
                 contiguous_ms=device_ms(lambda: da.decode_attention(
                     q, kc, vc, kv_len)))
    finally:
        da.split_plan_bf16 = plan
    del q, k, v, kc, vc
    # ssd_scan: each of its two launches, checked against the plain
    # version as the kernel phase checks it
    from repro_torch.kernels import ssd_scan as ssd
    for si, (name, b, s, h, p, n, init, inputs) in enumerate(SSD_SHAPES):
        x, dts, a, bm, cm, st = ssd_case(b, s, h, p, n, init,
                                         torch.bfloat16, 600 + si, inputs)
        yr, finr = ssd.ssd_scan_ref(x, dts, a, bm, cm, chunk=SSD_CHUNK,
                                    init_state=st)

        def call():
            return ssd.ssd_scan(x, dts, a, bm, cm, init_state=st)

        y, fin = call()
        emit("splits", kernel="ssd_scan", shape=name,
             y_rel_err=_rel_err(y, yr), state_rel_err=_rel_err(fin, finr),
             ms=device_ms(call, SSD_REPS), us_by_kernel=_kernel_us(call))
    plan = lmm.decode_split_plan
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [("lora_matmul", name, m, k, n, 200 + si, None)
             for si, (name, m, k, n, r) in enumerate(LORA_SHAPES)]
    cases += [("segmented_lora_matmul", name, m, k, n, 500 + si, (na, seq))
              for si, (name, m, k, n, r, na, seq) in enumerate(SEG_SHAPES)]
    for kernel, name, m, k, n, seed, slots in cases:
        if m > lmm.DECODE_MAX_M:
            continue
        if slots is None:
            x, w, a, b = lora_case(m, k, n, 16, torch.bfloat16, seed)

            def call():
                return lmm.lora_matmul(x, w, a, b, LORA_SCALING)
        else:
            x, w, a, b, idx = seg_case(m, k, n, 16, *slots, torch.bfloat16,
                                       seed)

            def call():
                return lmm.segmented_lora_matmul(x, w, a, b, idx,
                                                 LORA_SCALING)
        steps = -(-k // lmm.DECODE_STEP)
        own = plan(k, n, n_sm)[0]
        times = {}
        try:
            for want in sorted(set(SWEEP_LORA_SPLITS + (own,))):
                per = -(-steps // min(want, steps))
                lmm.decode_split_plan = lambda *_, per=per: (
                    -(-steps // per), per * lmm.DECODE_STEP)
                lmm.decode_workspace.cache_clear()   # it caches the plan
                times[-(-steps // per)] = device_ms(call)
        finally:
            lmm.decode_split_plan = plan
            lmm.decode_workspace.cache_clear()
        emit("splits", kernel=kernel, shape=name, M=m, K=k, N=n,
             slots=slots[0] if slots else 1, plan_splits=own,
             ms_by_splits=times)
    return None


# ------------------------------------------------------------ A / B -----
def time_kernels():
    """``--time-kernels SRC``: of the package under SRC, lora_matmul and
    segmented_lora_matmul at every shape of LORA_SHAPES and SEG_SHAPES in
    bfloat16 (and float32 at M <= 16), lora_matmul's dX (the transposed
    operands) at its train shapes, decode_attention at DECODE_SHAPES,
    paged_decode_attention at PAGED_SHAPES and ssd_scan (y) at
    SSD_SHAPES (float32 and bfloat16), and flash_attention's bf16
    forward and backward at their main shapes, on the kernel phases' inputs (same
    seeds): device ms (as the kernel phases time them), host us per call,
    max abs error against the plain version.  One JSON line."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lora_matmul as lmm
    from repro_torch.kernels import ssd_scan as ssd

    built = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(built)) as pool:
        list(pool.map(_build.library, built))
    rows = {}

    def add(key, fn, ref, reps=REPS, calls=100):
        out = fn()
        rows[key] = {"ms": device_ms(fn, reps), "host_us": host_us(fn, calls),
                     "max_abs_err": float((out.float() - ref.float())
                                          .abs().max())}

    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        for si, (name, m, k, n, r) in enumerate(LORA_SHAPES):
            if m <= 16 or dtype == torch.bfloat16:
                x, w, a, b = lora_case(m, k, n, r, dtype, 200 + si)
                add(f"lora_matmul/{name}/{dt}",
                    lambda: lmm.lora_matmul(x, w, a, b, LORA_SCALING),
                    lmm.lora_matmul_ref(x, w, a, b, LORA_SCALING))
                if name.startswith("train") and dtype == torch.bfloat16:
                    dy = torch.randn((m, n), generator=torch.Generator(
                        device="cuda").manual_seed(300), device="cuda").to(
                            dtype)
                    add(f"lora_matmul_dx/{name}/{dt}",
                        lambda: lmm.lora_matmul(dy, w.t(), b.t(), a.t(),
                                                LORA_SCALING),
                        lmm.lora_matmul_ref(dy, w.t(), b.t(), a.t(),
                                            LORA_SCALING))
                del x, w, a, b
        for si, (name, m, k, n, r, na, seq) in enumerate(SEG_SHAPES):
            if m <= 16 or dtype == torch.bfloat16:
                x, w, a, b, idx = seg_case(m, k, n, r, na, seq, dtype,
                                           500 + si)
                add(f"segmented_lora_matmul/{name}/{dt}",
                    lambda: lmm.segmented_lora_matmul(x, w, a, b, idx,
                                                      LORA_SCALING),
                    lmm.segmented_lora_matmul_ref(x, w, a, b, idx,
                                                  LORA_SCALING))
        for si, (name, b, h, hkv, d, s, layout, lengths) in \
                enumerate(DECODE_SHAPES):
            q, k, v, kv_len = decode_case(b, h, hkv, d, s, layout, lengths,
                                          dtype, 800 + si)
            add(f"decode_attention/{name}/{dt}",
                lambda: da.decode_attention(q, k, v, kv_len),
                da.decode_attention_ref(q, k, v, kv_len))
        for si, (name, shp) in enumerate(PAGED_SHAPES):
            q, kp, vp, tables, kv_len = attention_case(**shp, dtype=dtype,
                                                       seed=100 + si)
            add(f"paged_decode_attention/{name}/{dt}",
                lambda: da.paged_decode_attention(q, kp, vp, tables, kv_len),
                da.paged_decode_attention_ref(q, kp, vp, tables, kv_len))
        for si, (name, b, s, h, p, n, init, inputs) in enumerate(SSD_SHAPES):
            x, dts, a, bm, cm, st = ssd_case(b, s, h, p, n, init, dtype,
                                             600 + si, inputs)
            add(f"ssd_scan/{name}/{dt}",
                lambda: ssd.ssd_scan(x, dts, a, bm, cm, init_state=st)[0],
                ssd.ssd_scan_ref(x, dts, a, bm, cm, chunk=SSD_CHUNK,
                                 init_state=st)[0], SSD_REPS, 20)
    # flash_attention shares csrc/hopper.cuh with them: its bf16 forward
    # at the qwen wave and backward at the qwen train batch
    for name, backward in (("qwen_prefill", False), ("qwen_train", True)):
        si = [f[0] for f in FLASH_SHAPES].index(name)
        _, b, h, hkv, d, s, w = FLASH_SHAPES[si]
        g = torch.Generator(device="cuda").manual_seed(400 + si)
        q, k, v, do = (torch.randn((b, s, n, d), generator=g, device="cuda")
                       .to(torch.bfloat16).transpose(1, 2)
                       for n in (h, hkv, hkv, h))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=True)

        def fn():
            if backward:   # dQ
                return fa.flash_attention_backward(q, k, v, o, lse, do,
                                                   causal=True)[0]
            return fa.flash_attention_fwd(q, k, v, causal=True)[0]

        ref = (fa.flash_attention_grad_ref(q, k, v, do, causal=True)[0]
               if backward else fa.flash_attention_ref(q, k, v, causal=True))
        rows[f"flash_attention{'_backward' if backward else ''}/{name}/"
             "bfloat16"] = {"ms": device_ms(fn, FLASH_REPS),
                            "host_us": host_us(fn, 20),
                            "max_abs_err": float((fn().float() - ref.float())
                                                 .abs().max())}
    print(json.dumps({"time_kernels": SRC, "rows": rows}), flush=True)


def run_ab(parent):
    """``--ab DIR``: ``time_kernels`` on the package of the checkout at
    DIR (the parent commit, unpacked) and on this one in turn: parent,
    change, change, parent, each in a process of its own on this card.
    One line per run, then one per call with the four times."""
    trees = [os.path.join(os.path.abspath(parent), "src"), SRC, SRC,
             os.path.join(os.path.abspath(parent), "src")]
    runs = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-kernels",
             tree], capture_output=True, text=True, timeout=1500)
        if proc.returncode != 0:
            raise RuntimeError(f"--time-kernels {tree} failed:\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1])["rows"])
        emit("ab_run", tree=tree, rows=runs[-1])
    for key in runs[0]:
        emit("ab", call=key,
             **{f"{f}_parent_change_change_parent": [r[key][f] for r in runs]
                for f in ("ms", "host_us", "max_abs_err")})


# --------------------------------------------------------- reference -----
def phase_reference(get_config, build, make_engine, lm, scan, dattn):
    """The port on the card against the port on the CPU on the same
    float32 weights (reduced config): decode logits, then one train
    step; full-width logits sanity; a full-width combined step against
    a decode with the pre-update adapter; then mamba2 (``_reference_ssm``)
    and the VLM (``_reference_vlm``)."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.runtime.paging import blocks_for
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config(ARCH).scaled()
    cpu = build(cfg, "cpu")
    gpu = build(cfg, "cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    lora = cpu.init_lora(torch.Generator().manual_seed(1))
    for pair in lora.values():              # a live bypass: b != 0
        pair["b"].normal_(0.0, 0.1, generator=torch.Generator()
                          .manual_seed(2))

    lens = torch.tensor([5, 9, 3], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (3, 12),
                         generator=torch.Generator().manual_seed(3))
    bs, steps = 4, 6
    nb = blocks_for(int(lens.max()) + steps, bs)
    tables = torch.arange(1, 1 + 3 * nb, dtype=torch.int32).reshape(3, nb)
    wave = tables[:, :3].clone().numpy()
    for j, n in enumerate(lens.tolist()):
        wave[j, blocks_for(n, bs):] = 1 + 3 * nb     # dropped
    outs, feed = {}, None
    lm.launches = 0
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        p, lo = (tree_map(lambda t: t.to(m.device), tree)
                 for tree in (params, lora))
        logits, pre = m.prefill_ragged(p, lo, {"tokens": toks.to(m.device)},
                                       lens.to(m.device))
        caches = m.write_prefill_blocks(m.init_paged_caches(1 + 3 * nb, bs),
                                        pre, wave)
        seq, fed = [logits.cpu()], []
        for s in range(steps):
            # both devices decode the CPU run's greedy tokens
            tok = feed[s] if feed is not None \
                else logits[:, -1].argmax(-1).cpu()
            fed.append(tok)
            logits, caches = m.decode_step_paged(
                p, lo, caches, tok[:, None].to(m.device),
                (lens + s).to(m.device), tables.to(m.device))
            seq.append(logits.cpu())
        outs[name], feed = seq, fed
    worst = max(float((a - b).abs().max() / (a.abs().max() + 1e-6))
                for a, b in zip(outs["cpu"], outs["cuda"]))
    if worst >= 5e-5:
        raise AssertionError(f"card vs CPU logits differ by {worst} "
                             "(relative to their largest magnitude)")
    if lm.launches == 0:
        raise AssertionError("the card's reference run never launched "
                             "lora_matmul")

    # one train step, card vs CPU, same weights and batch (lr 1e-3)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (4, 25))
    batch = {"tokens": torch.tensor(toks[:, :-1]),
             "labels": torch.tensor(toks[:, 1:]),
             "mask": torch.ones((4, 24))}
    res = {}
    for dev in ("cpu", "cuda"):
        eng = make_engine(cfg, lr=1e-3, device=dev)
        p, lo, bt = (tree_map(lambda t: t.to(dev), tree)
                     for tree in (params, lora, batch))
        loss, _, grads = eng.loss_and_grads(p, lo, bt)
        new, _, met = eng.train_step(p, lo, eng.optimizer.init(lo), bt)
        res[dev] = (loss.cpu(), [g.cpu() for g in tree_leaves(grads)],
                    [t.cpu() for t in tree_leaves(new)], met["loss"].cpu())
    loss_err = float((res["cuda"][0] - res["cpu"][0]).abs()
                     / res["cpu"][0].abs())
    grad_err = max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
                   for a, b in zip(res["cuda"][1], res["cpu"][1]))
    lora_err = max(float((a - b).abs().max())
                   for a, b in zip(res["cuda"][2], res["cpu"][2]))
    lora_ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                  for a, b in zip(res["cuda"][2], res["cpu"][2]))
    # tolerances: the loss is one float32 reduction (1e-5 relative);
    # gradients sum over every position in another order (1e-4 of each
    # leaf's largest); the adapter moves ~lr = 1e-3 per element, so 1e-6
    # absolute is 0.1% of the step
    emit("reference_train", reduced_config=cfg.name, dtype="float32",
         loss_rel_err=loss_err, loss_tol=1e-5, grad_rel_err=grad_err,
         grad_tol=1e-4, updated_lora_max_abs_err=lora_err,
         updated_lora_tol="rtol 1e-5, atol 1e-6",
         step_loss_cpu=float(res["cpu"][3]),
         step_loss_cuda=float(res["cuda"][3]))
    if not (loss_err < 1e-5 and grad_err < 1e-4 and lora_ok):
        raise AssertionError("train step: card vs CPU beyond tolerance")

    full = build(get_config(ARCH), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = full.init(gen)
    lora = full.init_lora(gen)
    toks = torch.randint(0, full.cfg.vocab_size, (8, 32), device="cuda",
                         generator=gen)
    logits, pre = full.prefill_ragged(params, lora, {"tokens": toks},
                                      torch.full((8,), 32, device="cuda"))
    caches = full.init_caches(8, 48)
    caches = full.write_prefill_slots(caches, pre, np.arange(8))
    dec, _ = full.decode_step(params, lora, caches,
                              logits[:, -1].argmax(-1)[:, None],
                              torch.full((8,), 32, dtype=torch.int32,
                                         device="cuda"))
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(dec).all())
    shape_ok = tuple(dec.shape) == (8, 1, full.cfg.vocab_size)
    emit("reference", reduced_config=cfg.name, dtype="float32",
         card_vs_cpu_max_rel_err=worst, tol=5e-5,
         full_width_logits_finite=finite, full_width_logits_shape=list(
             dec.shape))
    if not (finite and shape_ok):
        raise AssertionError("full-width logits not finite or misshapen")

    # full-width combined step: its logits come from the pre-update
    # adapter, so they equal a plain decode with that adapter on the
    # same cache (identical kernels on identical inputs: bitwise)
    eng = make_engine(full.cfg, lr=3e-3, device="cuda")
    for leaf in tree_leaves(lora):                # a live bypass: b != 0
        if leaf.shape[1] == full.cfg.lora.rank:
            leaf.normal_(0.0, 0.02, generator=gen)
    pool = full.init_paged_caches(1 + 8 * 2, 16)
    tables = torch.arange(1, 17, dtype=torch.int32,
                          device="cuda").reshape(8, 2)
    tok = toks[:, :1]
    pos = torch.zeros(8, dtype=torch.int32, device="cuda")
    data = SyntheticDataset("alpaca", vocab_size=full.cfg.vocab_size,
                            seq_len=256, seed=0)
    tb = {k: torch.as_tensor(v, device="cuda")
          for k, v in data.batch(4).items()}
    before = [t.clone() for t in tree_leaves(lora)]
    snap = {"kv": tuple(t.clone() for t in pool["kv"])}
    new_lora, _, comb, _, met = eng.combined_step_paged(
        params, lora, eng.optimizer.init(lora), tb, pool, tok, pos, tables)
    ref, _ = full.decode_step_paged(params, lora, snap, tok, pos, tables)
    moved = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(new_lora), before))
    untouched = all(torch.equal(a, b)
                    for a, b in zip(tree_leaves(lora), before))
    comb_err = float((comb.float() - ref.float()).abs().max())
    emit("reference_combined", config=full.cfg.name, dtype="bfloat16",
         logits_vs_pre_update_decode_max_abs_err=comb_err, tol=0.0,
         pre_update_adapter_untouched=untouched,
         adapter_max_move=moved, train_loss=float(met["ce_loss"]))
    if comb_err != 0.0 or not untouched or moved == 0.0 \
            or not np.isfinite(float(met["ce_loss"])):
        raise AssertionError("combined step: logits are not the pre-update "
                             "adapter's, or the adapter did not train")
    del full, eng, params, lora, new_lora, caches, pool, snap, pre, logits
    del dec, comb, ref, tb
    torch.cuda.empty_cache()
    _reference_ssm(get_config, build, scan)
    _reference_vlm(get_config, build, dattn)
    _reference_serving(get_config, make_engine)


def _reference_ssm(get_config, build, scan, steps=5):
    """mamba2 at its reduced float32 size (2 layers, 8 SSM heads of 32,
    state 16), the card against the CPU on the same weights: one
    exact-length prefill of two 100-token prompts (the kernel takes the
    mixer's strided views, and 100 is no multiple of its chunk): logits,
    conv tails and states; then both requests written into slots 2 and 0
    of a 3-slot pool and ``steps`` decode steps' logits.  The card's
    prefill calls ssd_scan once per layer (SSD_LAUNCHES launches)."""
    from repro_torch.tree import tree_map
    cfg = get_config(SSM_ARCH).scaled()
    cpu, gpu = build(cfg, "cpu"), build(cfg, "cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    lora = cpu.init_lora(torch.Generator().manual_seed(1))
    for pair in lora.values():              # a live bypass: b != 0
        pair["b"].normal_(0.0, 0.1, generator=torch.Generator()
                          .manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), generator=gen)
    feed = torch.randint(0, cfg.vocab_size, (steps, 3, 1), generator=gen)
    res = {}
    scan.launches = 0
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        dev = m.device
        p, lo = (tree_map(lambda t: t.to(dev), tree)
                 for tree in (params, lora))
        with torch.no_grad():
            logits, pre = m.prefill(p, lo, {"tokens": toks.to(dev)})
            pool = m.init_caches(3, 128)
            for src, slot in ((0, 2), (1, 0)):
                m.write_prefill_slot(pool, pre, slot, src)
            seq = [logits.cpu()]
            for s in range(steps):
                logits, pool = m.decode_step(
                    p, lo, pool, feed[s].to(dev),
                    torch.full((3,), 100 + s, device=dev))
                seq.append(logits.cpu())
        res[name] = (seq, {k: v.cpu() for k, v in pre["ssm"].items()})
    launches = scan.launches

    def rel(a, b):
        return float((a - b).abs().max() / (b.abs().max() + 1e-30))

    (sc, cc), (sg, cg) = res["cpu"], res["cuda"]
    prefill_err = rel(sg[0], sc[0])
    decode_err = max(rel(a, b) for a, b in zip(sg[1:], sc[1:]))
    cache_err = {k: rel(cg[k], cc[k]) for k in ("conv", "state")}
    emit("reference_ssm", reduced_config=cfg.name, dtype="float32",
         prompts=[2, 100], decode_steps=steps,
         prefill_logits_rel_err=prefill_err, decode_logits_rel_err=decode_err,
         logits_tol=5e-5, conv_rel_err=cache_err["conv"],
         state_rel_err=cache_err["state"], cache_tol=5e-5,
         ssd_scan_launches=launches)
    if not (prefill_err < 5e-5 and decode_err < 5e-5
            and max(cache_err.values()) < 5e-5):
        raise AssertionError("mamba2: card vs CPU beyond tolerance")
    if launches != cfg.n_layers * SSD_LAUNCHES:
        raise AssertionError(f"mamba2 reference: {launches} ssd_scan "
                             f"launches for one prefill of {cfg.n_layers} "
                             f"layers ({SSD_LAUNCHES} a call)")


def _open_gates(params, gate=0.5):
    """Both gates of every cross block at ``gate``: the init's zeros make
    each cross block the identity, and a wrong cross-attention would not
    move one logit."""
    for key in ("gate_attn", "gate_mlp"):
        params["cross"][key].fill_(gate)


def _vlm_decode_caches(model, pre, b, s):
    """Decode caches of length ``s`` holding a prefill's K/V in their
    first rows and its vision K/V, by slice copy (a VLM stack has no
    cache-slot writes, as in the reference)."""
    caches = model.init_caches(b, s)
    p = pre["kv"][0].shape[3]
    for dst, src in zip(caches["kv"], pre["kv"]):
        dst[:, :, :, :p] = src
    for dst, src in zip(caches["cross_kv"], pre["cross_kv"]):
        dst.copy_(src)
    return caches


def _reference_vlm(get_config, build, dattn, steps=5):
    """The VLM at a reduced float32 size (2 units of 2 dense blocks and a
    cross block, d_model 128, 37 vision tokens so the decode kernel's
    walk is split and ragged), gates at 0.5, the card against the CPU on
    the same weights: prefill logits and cross_kv of two 9-token prompts,
    then ``steps`` decode steps' logits.  The card's decode launches
    decode_attention once per unit per step."""
    from repro_torch.tree import tree_map
    cfg = get_config(VLM_ARCH).scaled(n_layers=6, cross_attn_every=3,
                                      vision_tokens=37)
    units = cfg.n_layers // cfg.cross_attn_every
    cpu, gpu = build(cfg, "cpu"), build(cfg, "cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    _open_gates(params)
    lora = cpu.init_lora(torch.Generator().manual_seed(1))
    for pair in lora.values():              # a live bypass: b != 0
        pair["b"].normal_(0.0, 0.1, generator=torch.Generator()
                          .manual_seed(2))
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen)
    vis = torch.randn((2, cfg.vision_tokens, cfg.d_model), generator=gen)
    res, feed, launches = {}, None, None
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        dev = m.device
        p, lo = (tree_map(lambda t: t.to(dev), tree)
                 for tree in (params, lora))
        with torch.no_grad():
            logits, pre = m.prefill(p, lo, {"tokens": toks.to(dev),
                                            "vision": vis.to(dev)})
            caches = _vlm_decode_caches(m, pre, 2, 9 + steps)
            seq, fed = [logits.cpu()], []
            dattn.launches = 0
            for s in range(steps):
                # both devices decode the CPU run's greedy tokens
                tok = feed[s] if feed is not None \
                    else logits[:, -1].argmax(-1).cpu()
                fed.append(tok)
                logits, caches = m.decode_step(p, lo, caches,
                                               tok[:, None].to(dev),
                                               torch.tensor(9 + s))
                seq.append(logits.cpu())
            if name == "cuda":
                launches = dattn.launches
        res[name], feed = (seq, [t.cpu() for t in pre["cross_kv"]]), fed

    def rel(a, b):
        return float((a - b).abs().max() / (b.abs().max() + 1e-30))

    (sc, cc), (sg, cg) = res["cpu"], res["cuda"]
    prefill_err = rel(sg[0], sc[0])
    decode_err = max(rel(a, b) for a, b in zip(sg[1:], sc[1:]))
    cross_err = max(rel(a, b) for a, b in zip(cg, cc))
    emit("reference_vlm", reduced_config=cfg.name, dtype="float32",
         units=units, vision_tokens=cfg.vision_tokens, gates=0.5,
         prompts=[2, 9], decode_steps=steps,
         prefill_logits_rel_err=prefill_err, decode_logits_rel_err=decode_err,
         cross_kv_rel_err=cross_err, tol=5e-5,
         decode_attention_launches=launches,
         decode_attention_launches_derived=units * steps)
    if not (prefill_err < 5e-5 and decode_err < 5e-5 and cross_err < 5e-5):
        raise AssertionError("VLM: card vs CPU beyond tolerance")
    if launches != units * steps:
        raise AssertionError(f"VLM reference: {launches} decode_attention "
                             f"launches for {steps} steps of {units} units")


def _reference_serving(get_config, make_engine):
    """The batcher's prefix cache, chunked prefill, copy-on-write and
    oversubscription, the port on the card against the port on the CPU,
    reduced float32 config, the same weights (a live bypass): a
    repeated-prefix trace, cache off, on, and on with 8-token chunks; six
    prompts chunked (paged blocks of 8: chunks of 8 and 12; contiguous: 8
    and 10) and monolithic; a 16-token sliding window whose ring wrap
    re-enters aliased blocks, cache off and on; and the twins of
    tests/test_preemption.py's four traces on a pool far below their
    worst case (``oversubscribe`` 1.0): swap (under REPRO_SANITIZE=1),
    drop (``swap=False``), chunked, and shared prefixes with the prefix
    cache, each beside the same trace on an unbounded pool.  Within each
    trace every run emits the same greedy tokens, the card's equal the
    CPU's, every paged allocator drains, every oversubscribed run
    preempts, the sanitized run adds no report, and the windowed run
    copies at least one block (``Model.copy_blocks``)."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.models.model import Model
    from repro_torch.runtime import sanitize
    from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
    from repro_torch.tree import tree_map

    def prompts(cfg, lens, seed):
        data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size,
                                seq_len=max(lens), seed=seed)
        toks = data.sample_tokens(len(lens))
        return [toks[i, :n].astype(np.int32) for i, n in enumerate(lens)]

    def traces(cfg, wcfg):
        (head,) = prompts(cfg, [24], 3)
        rep = [np.concatenate([head, t]) for t in
               prompts(cfg, [4, 7, 2, 8, 5], 11)]
        rep_kw = dict(n_slots=2, max_seq=48, prompt_pad=32, paged=True,
                      block_size=8)
        six = prompts(cfg, [7, 24, 13, 24, 6, 19], 3)
        six_kw = dict(n_slots=3, max_seq=32, prompt_pad=24)
        (wh,) = prompts(wcfg, [12], 3)
        win = [wh] + [np.concatenate([wh, t])
                      for t in prompts(wcfg, [2, 2], 5)]
        win_kw = dict(n_slots=2, max_seq=40, prompt_pad=16, paged=True,
                      block_size=4, n_blocks=13)
        # tests/test_preemption.py's traces: heavy-tailed answers on 3
        # slots, and prompts sharing a 16-token head
        ov = prompts(cfg, [7, 16, 13, 10, 6, 15], 3)
        ov_kw = dict(n_slots=3, max_seq=48, prompt_pad=16, paged=True,
                     block_size=8)
        base = prompts(cfg, [16, 16], 3)
        ovp = [base[0], np.concatenate([base[0], base[1][:4]]),
               base[0].copy(), base[1], base[0][:10],
               np.concatenate([base[0], base[1][4:9]])]
        ovp_kw = {**ov_kw, "prompt_pad": 24, "prefix_cache": True}
        over = {"oversubscribe": 1.0}
        return {
            "repeated_prefix": (False, rep, [5, 3, 6, 2, 4], [
                ("cache_off", rep_kw), ("cache_on", {**rep_kw,
                                                     "prefix_cache": True}),
                ("cache_on_chunk8", {**rep_kw, "prefix_cache": True,
                                     "prefill_chunk": 8})]),
            "chunked": (False, six, [6] * 6, [
                ("paged_monolithic", {**six_kw, "paged": True,
                                      "block_size": 8}),
                ("paged_chunk8", {**six_kw, "paged": True, "block_size": 8,
                                  "prefill_chunk": 8}),
                ("paged_chunk12", {**six_kw, "paged": True, "block_size": 8,
                                   "prefill_chunk": 12}),
                ("contiguous_monolithic", six_kw),
                ("contiguous_chunk8", {**six_kw, "prefill_chunk": 8}),
                ("contiguous_chunk10", {**six_kw, "prefill_chunk": 10})]),
            "window_cow": (True, win, [4, 10, 10], [
                ("cache_off", win_kw),
                ("cache_on", {**win_kw, "prefix_cache": True})]),
            "oversub": (False, ov, [24, 4, 20, 4, 6, 18], [
                ("unbounded", {**ov_kw, "n_blocks": 64}),
                ("swap_sanitized", {**ov_kw, **over, "n_blocks": 10}),
                ("drop", {**ov_kw, **over, "n_blocks": 10, "swap": False}),
                ("chunked", {**ov_kw, **over, "n_blocks": 9,
                             "prefill_chunk": 8})]),
            "oversub_prefix": (False, ovp, [24, 6, 18, 20, 4, 4], [
                ("unbounded", {**ovp_kw, "n_blocks": 64}),
                ("swap", {**ovp_kw, **over, "n_blocks": 12})]),
        }

    cfg = get_config(ARCH).scaled()
    wcfg = get_config(ARCH).scaled(sliding_window=16)
    weights = {}
    for name, c in (("full", cfg), ("window", wcfg)):
        cpu = make_engine(c, device="cpu").model
        p = cpu.init(torch.Generator().manual_seed(0))
        lo = cpu.init_lora(torch.Generator().manual_seed(1))
        for pair in lo.values():            # a live bypass: b != 0
            pair["b"].normal_(0.0, 0.1, generator=torch.Generator()
                              .manual_seed(2))
        weights[name] = (c, p, lo)
    copies = []
    orig = Model.copy_blocks

    def spy(self, caches, src, dst):
        copies.append((self.device.type, len(src)))
        return orig(self, caches, src, dst)

    Model.copy_blocks = spy
    tokens, drained, preempted = {}, True, {}
    reports = len(sanitize.reports())
    try:
        for dev in ("cpu", "cuda"):
            for key, (windowed, ps, gens, runs) in traces(cfg, wcfg).items():
                c, p, lo = weights["window" if windowed else "full"]
                eng = make_engine(c, device=dev)
                p, lo = (tree_map(lambda t: t.to(dev), tree)
                         for tree in (p, lo))
                for run, kw in runs:
                    armed = run.endswith("sanitized")
                    if armed:           # the factories read it at init
                        os.environ["REPRO_SANITIZE"] = "1"
                    try:
                        b = ContinuousBatcher(eng, p, lo, **kw)
                    finally:
                        os.environ.pop("REPRO_SANITIZE", None)
                    if armed and b.allocator.san is None:
                        raise AssertionError("reference serving: the "
                                             "sanitizer did not arm")
                    reqs = [GenRequest(request_id=i, prompt=q.copy(),
                                       max_new_tokens=g)
                            for i, (q, g) in enumerate(zip(ps, gens))]
                    if key == "window_cow":
                        # a short request registers the prefix, then the
                        # two sharers decode past the window
                        b.run(reqs[:1])
                        b.run(reqs[1:])
                    else:
                        b.run(reqs)
                    tokens[(dev, key, run)] = [r.tokens for r in reqs]
                    if b.paged:
                        drained &= b.allocator.n_used == 0 \
                            and b.allocator.reserved == 0 \
                            and b.n_preempted == 0
                    if b.oversubscribe:
                        st = b.stats
                        preempted[f"{dev}/{key}/{run}"] = dict(
                            preemptions=st.preemptions,
                            swap_out_blocks=st.swap_out_blocks,
                            swap_in_blocks=st.swap_in_blocks,
                            reprefill_tokens=st.reprefill_tokens)
    finally:
        Model.copy_blocks = orig
    same = {key: all(tokens[(dev, key, run)] == tokens[("cpu", key,
                                                        runs[0][0])]
                     for dev in ("cpu", "cuda") for run, _ in runs)
            for key, (_, _, _, runs) in traces(cfg, wcfg).items()}
    cuda_copies = sum(n for dev, n in copies if dev == "cuda")
    emit("reference_serving", reduced_config=cfg.name, dtype="float32",
         runs={key: [run for run, _ in runs]
               for key, (_, _, _, runs) in traces(cfg, wcfg).items()},
         all_runs_and_card_equal_cpu_tokens=same, allocators_drained=drained,
         copy_blocks_calls={dev: sum(1 for d, _ in copies if d == dev)
                            for dev in ("cpu", "cuda")},
         blocks_copied_cuda=cuda_copies, preemption_counters=preempted,
         sanitizer_reports_added=len(sanitize.reports()) - reports)
    every_run_preempted = all(c["preemptions"] > 0
                              for c in preempted.values())
    if not (all(same.values()) and drained and cuda_copies > 0
            and every_run_preempted
            and len(sanitize.reports()) == reports):
        raise AssertionError(
            f"reference serving: tokens {same}, drained {drained}, "
            f"blocks copied on the card {cuda_copies}, preemptions "
            f"{preempted}, sanitizer reports {sanitize.reports()[reports:]}")


def phase_reference_blockwise(get_config, build, make_engine, fa):
    """The blockwise path: the port on the card against the port on the
    CPU at a reduced float32 config with ``attn_impl="blockwise"``
    (head_dim 64, GQA 2:1): prefill logits and caches, then one train
    step; and at full width in bf16 the blockwise and dense paths on the
    same 992-token inputs, where both can run."""
    import dataclasses
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config(ARCH).scaled(attn_impl="blockwise", d_model=256,
                                  n_heads=4, n_kv_heads=2)
    cpu = build(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    lora = cpu.init_lora(torch.Generator().manual_seed(1))
    for pair in lora.values():              # a live bypass: b != 0
        pair["b"].normal_(0.0, 0.1, generator=torch.Generator()
                          .manual_seed(2))
    lens = torch.tensor([40, 70, 33], dtype=torch.int32)
    toks = torch.randint(0, cfg.vocab_size, (3, 80),
                         generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    tt = rng.integers(0, cfg.vocab_size, (4, 97))
    batch = {"tokens": torch.tensor(tt[:, :-1]),
             "labels": torch.tensor(tt[:, 1:]), "mask": torch.ones((4, 96))}
    res = {}
    fa.flash_attention_fwd.launches = fa.flash_attention_backward.launches = 0
    for dev in ("cpu", "cuda"):
        eng = make_engine(cfg, lr=1e-3, device=dev)
        p, lo, bt = (tree_map(lambda t: t.to(dev), tree)
                     for tree in (params, lora, batch))
        logits, pre = eng.model.prefill_ragged(
            p, lo, {"tokens": toks.to(dev)}, lens.to(dev))
        loss, _, grads = eng.loss_and_grads(p, lo, bt)
        new, _, _ = eng.train_step(p, lo, eng.optimizer.init(lo), bt)
        res[dev] = (logits.cpu(), [c.cpu() for c in pre["kv"]], loss.cpu(),
                    [g.cpu() for g in tree_leaves(grads)],
                    [t.cpu() for t in tree_leaves(new)])
    launches = (fa.flash_attention_fwd.launches,
                fa.flash_attention_backward.launches)
    c, g = res["cpu"], res["cuda"]

    def rel(a, b):
        return float((a - b).abs().max() / (b.abs().max() + 1e-30))

    logit_err = rel(g[0], c[0])
    cache_err = max(rel(a, b) for a, b in zip(g[1], c[1]))
    loss_err = rel(g[2], c[2])
    grad_err = max(rel(a, b) for a, b in zip(g[3], c[3]))
    # Adam's first step moves each element by lr * g / (|g| + eps): about
    # lr * sign(g), so an element whose gradient lies inside the gradient
    # tolerance (1e-4 of its leaf's largest) may move either way; every
    # other element must agree to rtol 1e-5, atol 1e-6
    lora_ok, loose, lora_err = True, 0, 0.0
    for a, b, gc in zip(g[4], c[4], c[3]):
        firm = gc.abs() >= 1e-4 * gc.abs().max()
        loose += int((~firm).sum())
        lora_err = max(lora_err, float((a - b).abs().max()))
        lora_ok &= torch.allclose(a[firm], b[firm], rtol=1e-5, atol=1e-6)
    emit("reference_blockwise", reduced_config=cfg.name, dtype="float32",
         head_dim=cfg.head_dim, n_kv_heads=cfg.n_kv_heads,
         prefill_logits_rel_err=logit_err, logits_tol=5e-5,
         cache_rel_err=cache_err, cache_tol=1e-5, loss_rel_err=loss_err,
         loss_tol=1e-5, grad_rel_err=grad_err, grad_tol=1e-4,
         updated_lora_ok=lora_ok, updated_lora_max_abs_err=lora_err,
         lora_elements_inside_grad_tol=loose,
         flash_attention_launches=launches[0],
         flash_attention_backward_launches=launches[1])
    if not (logit_err < 5e-5 and cache_err < 1e-5 and loss_err < 1e-5
            and grad_err < 1e-4 and lora_ok):
        raise AssertionError("blockwise path: card vs CPU beyond tolerance")
    # prefill, loss_and_grads and train_step: 2 layers forward each, and
    # FLASH_BWD launches per layer in the two backwards
    if launches != (3 * cfg.n_layers, 2 * FLASH_BWD * cfg.n_layers):
        raise AssertionError(f"blockwise reference: launches {launches}")

    # Full width, bf16, 2 x 992 tokens: every layer's attention, the
    # blockwise and the dense path on the same input (the dense model's
    # hidden state at that layer), within 2e-2 of the largest output (a
    # bf16 ulp is 2^-8..2^-7 of it).  The 24-layer logits, where bf16
    # rounding differences grow layer by layer, are read out beside a
    # float32 run of the same weights, not checked
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import rms_norm, rope_tables
    full = get_config(ARCH)
    dense = build(dataclasses.replace(full, attn_impl="dense"), "cuda")
    blockwise = build(dataclasses.replace(full, attn_impl="blockwise"),
                      "cuda")
    f32 = build(dataclasses.replace(full, attn_impl="dense", dtype="float32",
                                    param_dtype="float32"), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = dense.init(gen)
    lora = dense.init_lora(gen)
    for leaf in tree_leaves(lora):                # a live bypass: b != 0
        if leaf.shape[1] == full.lora.rank:
            leaf.normal_(0.0, 0.02, generator=gen)
    toks = torch.randint(0, full.vocab_size, (2, 992), device="cuda",
                         generator=gen)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    with torch.no_grad():
        rope = rope_tables(torch.arange(992, device="cuda"), full.head_dim,
                           full.rope_theta)
        x = params["embed"][toks]
        layer_errs = []
        for i in range(full.n_layers):
            bp = tree_map(lambda t: t[i], params["blocks"])
            lo = tree_map(lambda t: t[i], lora)
            h = rms_norm(x, bp["ln1"])
            out = {m.cfg.attn_impl: tfm.attn_full(bp["attn"], h, m.cfg,
                                                  rope, lora=lo)[0]
                   for m in (dense, blockwise)}
            layer_errs.append(rel(out["blockwise"], out["dense"]))
            x, _ = tfm.block_full(bp, x, dense.cfg, rope, lora=lo)
        ld = dense.logits(params, lora, {"tokens": toks}).float()
        lb = blockwise.logits(params, lora, {"tokens": toks}).float()
        lt = f32.logits(tree_map(lambda t: t.float(), params), lora,
                        {"tokens": toks})
    emit("reference_blockwise_vs_dense", config=full.name, dtype="bfloat16",
         tokens=[2, 992], attention_rel_err_per_layer=layer_errs,
         attention_rel_err_max=max(layer_errs), layer_tol=2e-2,
         logits_blockwise_vs_dense_rel_err=rel(lb, ld),
         logits_dense_vs_f32_rel_err=rel(ld, lt),
         logits_blockwise_vs_f32_rel_err=rel(lb, lt))
    if max(layer_errs) >= 2e-2:
        raise AssertionError(
            f"blockwise vs dense attention beyond 2e-2 of the largest "
            f"output: per layer {layer_errs}")
    del params, lora, ld, lb, lt, out, h, x, dense, blockwise, f32
    torch.cuda.empty_cache()


# ------------------------------------------------------------- serving ----
def arch_counts(get_config, arch):
    """(layers, adapter projections per forward, their dX launches per
    backward) of ``arch``: 4 targets a layer, layer 0's q/k/v get no dX
    (their input is the frozen embedding)."""
    n = get_config(arch).n_layers
    return n, 4 * n, 4 * n - 3


def long_prompt(plen):
    """Whether prefill at ``plen`` tokens takes the blockwise path."""
    return plen * plen > 1024 * 1024


SERVE_RUNS = [
    ("paged", ARCH, dict(paged=True, prompt_len=32, gen_tokens=16)),
    ("contiguous", ARCH, dict(paged=False, prompt_len=32, gen_tokens=16)),
    ("paged_992", ARCH, dict(paged=True, prompt_len=992, gen_tokens=32)),
    ("paged_992_bs128", ARCH, dict(paged=True, block_size=128,
                                   prompt_len=992, gen_tokens=32)),
    ("contiguous_992", ARCH, dict(paged=False, prompt_len=992,
                                  gen_tokens=32)),
    ("paged_2048", ARCH, dict(paged=True, prompt_len=2048, gen_tokens=32)),
    ("contiguous_2048", ARCH, dict(paged=False, prompt_len=2048,
                                   gen_tokens=32)),
    ("paged_4096", ARCH, dict(paged=True, prompt_len=4096, gen_tokens=32)),
    ("llama_paged_2048", "llama3-8b", dict(paged=True, prompt_len=2048,
                                           gen_tokens=32)),
]


def _reset(*counters):
    for c in counters:
        c.launches = 0


def latency_percentiles(out):
    """TTFT and TPOT p50 / p99 (ms) of a run from ``ServeStats.ttft`` /
    ``tpot``: arrival (all at the run's start) to the tick that admitted
    the request, and the seconds per later token, as the reference's
    batcher stamps them."""
    res = {}
    for key, vals in (("ttft", out["ttft_s"]), ("tpot", out["tpot_s"])):
        for pct in (50, 99):
            res[f"{key}_p{pct}_ms"] = float(np.percentile(vals, pct)) * 1e3
    return res


def phase_serve(run_serving, get_config, pda, lm, fa, seg):
    """Serving at full width, every launch count checked: the decode
    kernel once per layer per decode step, lora_matmul once per adapter
    projection per prefill wave and decode step, flash_attention once
    per layer per prefill wave past the dense limit and never below,
    segmented_lora_matmul never (one adapter)."""
    results = {}
    fwd = fa.flash_attention_fwd
    for name, arch, kw in SERVE_RUNS:
        n_layers, n_lora, _ = arch_counts(get_config, arch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(pda, lm, fwd, seg)                         # main path starts
        out = run_serving(arch, smoke=False, n_requests=16, batch_size=8,
                          seed=0, device="cuda", verbose=False, **kw)
        launches, lora_launches, flash = pda.launches, lm.launches, \
            fwd.launches                                  # path ends
        if seg.launches:
            raise AssertionError(f"{name}: {seg.launches} segmented "
                                 "launches with one adapter")
        gen = kw["gen_tokens"]
        flash_want = n_layers * out["prefill_waves"] \
            if long_prompt(kw["prompt_len"]) else 0
        row = {
            "run": name, "arch": arch, "prompt_len": kw["prompt_len"],
            "gen_tokens": gen,
            "block_size": kw.get("block_size", 16) if kw["paged"] else None,
            "finished": out["finished"],
            "tokens_generated": out["tokens_generated"],
            "decode_steps": out["decode_steps"],
            "prefill_waves": out["prefill_waves"],
            "kernel_launches": launches,
            "lora_matmul_launches": lora_launches,
            "flash_attention_launches": flash,
            "flash_attention_launches_derived": flash_want,
            "throughput_tok_s": out["throughput_tok_s"],
            "wall_s": out["wall_s"],
            **latency_percentiles(out),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "cache_bytes": out["cache_bytes"],
        }
        if kw["paged"]:
            row.update(peak_used_blocks=out["peak_used_blocks"],
                       pool_blocks=out["pool_blocks"],
                       blocks_used_at_end=out["blocks_used_at_end"],
                       blocks_reserved_at_end=out["blocks_reserved_at_end"])
        emit("serve", **row)
        if out["finished"] != 16 or out["tokens_generated"] != 16 * gen \
                or any(len(t) != gen for t in out["tokens"]):
            raise AssertionError(f"{name}: not every request finished")
        if launches != n_layers * out["decode_steps"]:
            raise AssertionError(
                f"{name}: {launches} kernel launches for "
                f"{out['decode_steps']} decode steps of {n_layers} layers")
        if lora_launches != n_lora * (out["decode_steps"]
                                      + out["prefill_waves"]):
            raise AssertionError(
                f"{name}: {lora_launches} lora_matmul launches for "
                f"{out['decode_steps']} decode steps and "
                f"{out['prefill_waves']} prefill waves")
        if flash != flash_want:
            raise AssertionError(f"{name}: {flash} flash_attention "
                                 f"launches, derived {flash_want}")
        if kw["paged"] and (out["blocks_used_at_end"]
                            or out["blocks_reserved_at_end"]):
            raise AssertionError(f"{name}: allocator did not drain")
        results[name] = (row, out["tokens"])
        del out
        torch.cuda.empty_cache()
    # the kernel walks logical rows whatever the pool's block size, so
    # every layout of one traffic computes the same logits
    short = results["paged"][1] == results["contiguous"][1]
    long_ = all(results[n][1] == results["paged_992"][1]
                for n in ("paged_992_bs128", "contiguous_992"))
    long2k = results["paged_2048"][1] == results["contiguous_2048"][1]
    emit("serve_check", short_paged_equals_contiguous_tokens=short,
         long_all_layouts_equal_tokens=long_,
         paged_2048_equals_contiguous_tokens=long2k)
    if not (short and long_ and long2k):
        raise AssertionError("layouts of one traffic emitted different "
                             "tokens")
    return results


# ------------------------------------------------------------ SSM serving -
SSM_ARCH = "mamba2-780m"
SSM_RUNS = [("ssm_32", dict(prompt_len=32, gen_tokens=16)),
            ("ssm_992", dict(prompt_len=992, gen_tokens=32)),
            ("ssm_2048", dict(prompt_len=2048, gen_tokens=32))]


def phase_serve_ssm(run_serving, get_config, pda, lm, fa, seg, scan):
    """mamba2-780m at full width (48 layers, d_model 1536, 48 SSM heads
    of 64, state 128, bf16, random weights from a seed), 16 requests on
    8 contiguous slots: every request finishes, and the launches are
    exactly as derived: ssd_scan once per layer per request (each prompt
    prefills alone, at its exact length; SSD_LAUNCHES launches a call),
    lora_matmul once per adapter projection (ssm_in, ssm_out) per layer
    per prefill call and decode step, and no attention or segmented
    kernel at all."""
    cfg = get_config(SSM_ARCH)
    n_lora = 2 * cfg.n_layers
    fwd = fa.flash_attention_fwd
    results = {}
    for name, kw in SSM_RUNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(pda, lm, fwd, seg, scan)                   # main path starts
        out = run_serving(SSM_ARCH, smoke=False, n_requests=16,
                          batch_size=8, seed=0, device="cuda",
                          verbose=False, **kw)
        launches = {"ssd_scan": scan.launches, "lora_matmul": lm.launches,
                    "paged_decode_attention": pda.launches,
                    "flash_attention": fwd.launches,
                    "segmented_lora_matmul": seg.launches}   # path ends
        gen, steps = kw["gen_tokens"], out["decode_steps"]
        want = {"ssd_scan": cfg.n_layers * 16 * SSD_LAUNCHES,
                "lora_matmul": n_lora * (16 + steps),
                "paged_decode_attention": 0, "flash_attention": 0,
                "segmented_lora_matmul": 0}
        row = {
            "run": name, "arch": SSM_ARCH, "prompt_len": kw["prompt_len"],
            "gen_tokens": gen, "finished": out["finished"],
            "tokens_generated": out["tokens_generated"],
            "decode_steps": steps, "prefill_waves": out["prefill_waves"],
            "launches": launches, "launches_derived": want,
            "throughput_tok_s": out["throughput_tok_s"],
            "wall_s": out["wall_s"],
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "cache_bytes": out["cache_bytes"],
        }
        emit("serve_ssm", **row)
        if out["finished"] != 16 or out["tokens_generated"] != 16 * gen \
                or any(len(t) != gen for t in out["tokens"]):
            raise AssertionError(f"serve_ssm {name}: not every request "
                                 "finished")
        if launches != want:
            raise AssertionError(f"serve_ssm {name}: launches {launches}, "
                                 f"derived {want}")
        results[name] = row
        del out
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------ VLM serving -
def _vlm_full(make_engine, get_config):
    """llama-3.2-vision-90b at published width, depth cut to VLM_LAYERS
    (whole units), bf16 random weights from a seed, gates at 0.5."""
    import dataclasses
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    engine = make_engine(cfg, lr=3e-3, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = engine.model.init(gen)
    _open_gates(params)
    return engine, params, engine.model.init_lora(gen), gen


def phase_serve_vlm(make_engine, get_config, pda, lm, fa, seg, scan, dattn):
    """VLM serving through the engine API (the batcher refuses VLM stacks,
    as in the reference): 16 requests on 8 slots in two waves, each an
    ``Engine.prefill_step`` of 8 32-token prompts with their own vision
    inputs (random patch embeddings [8, 1,601, 8,192] from a seed, the
    stub frontend's), the caches copied into decode caches, then 15
    greedy ``Engine.decode_step``s.  Launches exactly as derived:
    decode_attention once per unit per decode step, the paged kernel
    once per dense block per decode step, lora_matmul once per adapter
    projection per prefill wave and decode step.  Then one unit's
    cross-attention at decode through the kernel against the dense
    non-causal attention on the same q/K/V (bf16, 2e-2)."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import attention_dense
    n_requests, slots, plen, gen_tokens = 16, 8, 32, 16
    torch.cuda.empty_cache()
    engine, params, lora, gen = _vlm_full(make_engine, get_config)
    model, cfg = engine.model, engine.model.cfg
    units, per = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1
    data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size,
                            seq_len=plen, seed=0)
    prompts = torch.as_tensor(data.sample_tokens(n_requests)[:, :plen],
                              device="cuda")
    visions = [torch.randn((slots, cfg.vision_tokens, cfg.d_model),
                           generator=gen, device="cuda",
                           dtype=torch.bfloat16)
               for _ in range(n_requests // slots)]
    steps = gen_tokens - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(pda, lm, fa.flash_attention_fwd, seg, scan, dattn)  # path starts
    t_start = time.perf_counter()
    tokens, ttft_ms, tick_ms = [], [], []
    for w, vis in enumerate(visions):
        t0 = time.perf_counter()
        logits, pre = engine.prefill_step(
            params, lora, {"tokens": prompts[w * slots:(w + 1) * slots],
                           "vision": vis})
        tok = logits[:, -1].argmax(-1)
        caches = _vlm_decode_caches(model, pre, slots, plen + steps)
        del pre, logits
        torch.cuda.synchronize()
        ttft_ms.append((time.perf_counter() - t0) * 1e3)
        wave = [tok]
        t0 = time.perf_counter()
        for s in range(steps):
            pos = torch.full((slots,), plen + s, dtype=torch.int32,
                             device="cuda")
            logits, caches = engine.decode_step(params, lora, caches,
                                                tok[:, None], pos)
            tok = logits[:, -1].argmax(-1)
            wave.append(tok)
        finite = bool(torch.isfinite(logits).all())
        tick_ms.append((time.perf_counter() - t0) / steps * 1e3)
        tokens += torch.stack(wave, 1).tolist()
        if not finite:
            raise AssertionError(f"serve_vlm wave {w}: logits not finite")
    wall = time.perf_counter() - t_start
    launches = {"decode_attention": dattn.launches,
                "paged_decode_attention": pda.launches,
                "lora_matmul": lm.launches,
                "flash_attention": fa.flash_attention_fwd.launches,
                "segmented_lora_matmul": seg.launches,
                "ssd_scan": scan.launches}                    # path ends
    waves = len(visions)
    want = {"decode_attention": units * steps * waves,
            "paged_decode_attention": units * per * steps * waves,
            "lora_matmul": 4 * units * per * (steps + 1) * waves,
            "flash_attention": 0, "segmented_lora_matmul": 0, "ssd_scan": 0}
    peak = torch.cuda.max_memory_allocated()

    # one unit's cross-attention at decode: the kernel against the dense
    # non-causal attention on the same q/K/V
    cp = {k: v[0] for k, v in params["cross"]["attn"].items()}
    vkv = (caches["cross_kv"][0][0], caches["cross_kv"][1][0])
    x = torch.randn((slots, 1, cfg.d_model), generator=gen, device="cuda",
                    dtype=cp["wq"].dtype)
    with torch.no_grad():
        got = tfm.cross_attn(cp, x, vkv, cfg)
        q = (x @ cp["wq"]).reshape(slots, 1, cfg.n_heads, cfg.head_dim)
        o = attention_dense(q, *vkv, causal=False)
        want_o = o.reshape(slots, 1, -1) @ cp["wo"]
    cross_err = float((got.float() - want_o.float()).abs().max()
                      / want_o.float().abs().max())
    row = {
        "arch": VLM_ARCH, "n_layers": cfg.n_layers, "units": units,
        "dense_blocks_per_unit": per, "vision_tokens": cfg.vision_tokens,
        "gates": 0.5, "requests": n_requests, "slots": slots,
        "prompt_len": plen, "gen_tokens": gen_tokens, "prefill_waves": waves,
        "decode_steps": steps * waves,
        "finished": sum(len(t) == gen_tokens for t in tokens),
        "tokens_generated": sum(len(t) for t in tokens),
        "throughput_tok_s": sum(len(t) for t in tokens) / wall,
        "wall_s": wall, "prefill_wave_ms": ttft_ms,
        "host_ms_per_decode_tick": tick_ms,
        "max_memory_allocated_bytes": peak,
        "launches": launches, "launches_derived": want,
        "cross_attn_kernel_vs_dense_rel_err": cross_err,
        "cross_attn_tol": 2e-2,
    }
    emit("serve_vlm", **row)
    if row["finished"] != n_requests:
        raise AssertionError("serve_vlm: not every request finished")
    if launches != want:
        raise AssertionError(f"serve_vlm: launches {launches}, derived "
                             f"{want}")
    if not cross_err < 2e-2:
        raise AssertionError(f"serve_vlm: cross-attention through the "
                             f"kernel {cross_err} from the dense path")
    del engine, params, lora, caches, visions, vkv, x, got, o
    torch.cuda.empty_cache()
    return row


# ------------------------------------------------------------ combined ----
COMBINED_RUNS = [
    ("paged", ARCH, 4, dict(paged=True, prompt_len=32, gen_tokens=16)),
    ("contiguous", ARCH, 4, dict(paged=False, prompt_len=32,
                                 gen_tokens=16)),
    ("paged_992", ARCH, 4, dict(paged=True, prompt_len=992, gen_tokens=32)),
    ("paged_2048", ARCH, 4, dict(paged=True, prompt_len=2048,
                                 gen_tokens=32)),
    ("llama_paged_2048", "llama3-8b", 1, dict(paged=True, prompt_len=2048,
                                              gen_tokens=32)),
]


def phase_combined(run_serving, get_config, pda, lm, fa, seg):
    """Serving while co-training the adapter on every tick (a fresh
    train batch of ``train_batch`` x prompt length rows)."""
    results = {}
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_backward
    for name, arch, tbatch, kw in COMBINED_RUNS:
        n_layers, n_lora, n_lora_bwd = arch_counts(get_config, arch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(pda, lm, fwd, bwd, seg)                    # main path starts
        out = run_serving(arch, smoke=False, n_requests=16, batch_size=8,
                          combined=True, train_batch=tbatch, seed=0,
                          device="cuda", verbose=False, **kw)
        if seg.launches:
            raise AssertionError(f"combined {name}: {seg.launches} "
                                 "segmented launches with one adapter")
        launches, lora_launches = pda.launches, lm.launches
        flash, flash_bwd = fwd.launches, bwd.launches     # path ends
        gen, losses = kw["gen_tokens"], out["train_losses"]
        want = (n_lora * out["prefill_waves"] + n_lora * out["decode_steps"]
                + (n_lora + n_lora_bwd) * out["train_steps"])
        long = long_prompt(kw["prompt_len"])
        flash_want = n_layers * (out["prefill_waves"] + out["train_steps"]) \
            if long else 0
        flash_bwd_want = FLASH_BWD * n_layers * out["train_steps"] \
            if long else 0
        row = {
            "run": name, "arch": arch, "prompt_len": kw["prompt_len"],
            "gen_tokens": gen, "train_batch": [tbatch, kw["prompt_len"]],
            "finished": out["finished"],
            "tokens_generated": out["tokens_generated"],
            "decode_steps": out["decode_steps"],
            "prefill_waves": out["prefill_waves"],
            "train_steps": out["train_steps"],
            "lora_matmul_launches": lora_launches,
            "lora_matmul_launches_derived": want,
            "attention_launches": launches,
            "flash_attention_launches": flash,
            "flash_attention_launches_derived": flash_want,
            "flash_attention_backward_launches": flash_bwd,
            "flash_attention_backward_launches_derived": flash_bwd_want,
            "throughput_tok_s": out["throughput_tok_s"],
            "wall_s": out["wall_s"],
            **latency_percentiles(out),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
        }
        if kw["paged"]:
            row.update(blocks_used_at_end=out["blocks_used_at_end"],
                       blocks_reserved_at_end=out["blocks_reserved_at_end"])
        emit("combined", **row)
        if out["finished"] != 16 or any(len(t) != gen for t in out["tokens"]):
            raise AssertionError(f"combined {name}: not every request "
                                 "finished")
        # every tick had an active slot, so ticks == decode steps
        if out["train_steps"] != out["decode_steps"] \
                or len(losses) != out["train_steps"]:
            raise AssertionError(f"combined {name}: {out['train_steps']} "
                                 f"train steps for {out['decode_steps']} "
                                 "ticks")
        if not np.isfinite(losses).all():
            raise AssertionError(f"combined {name}: non-finite loss")
        if kw["paged"] and (out["blocks_used_at_end"]
                            or out["blocks_reserved_at_end"]):
            raise AssertionError(f"combined {name}: allocator did not "
                                 "drain")
        if lora_launches != want:
            raise AssertionError(f"combined {name}: {lora_launches} "
                                 f"lora_matmul launches, derived {want}")
        if launches != n_layers * out["decode_steps"]:
            raise AssertionError(f"combined {name}: {launches} attention "
                                 "launches")
        if (flash, flash_bwd) != (flash_want, flash_bwd_want):
            raise AssertionError(
                f"combined {name}: flash_attention launches {flash} / "
                f"{flash_bwd}, derived {flash_want} / {flash_bwd_want}")
        results[name] = row
        del out
        torch.cuda.empty_cache()
    return results


# ------------------------------------------- prefix cache, chunks, budget -
PREFIX_HEAD, PREFIX_GEN, CHUNK = 768, 32, 256


def prefix_trace(vocab, paired=False, seed=7):
    """16 prompts of two families sharing a 768-token prefix (48 blocks of
    16), each with a tail of 32 to 224 tokens (prompts of 800 to 992).
    Request i takes family i % 2 and tail i; ``paired``: requests 2k and
    2k + 1 take tail k and family k % 2 (identical prompts)."""
    rng = np.random.default_rng(seed)
    heads = rng.integers(0, vocab, (2, PREFIX_HEAD))
    lens = rng.permutation(np.linspace(32, 224, 16).astype(int))
    tails = [rng.integers(0, vocab, n) for n in lens]
    out = []
    for i in range(16):
        k = i // 2 if paired else i
        out.append(np.concatenate([heads[k % 2], tails[k]]).astype(np.int32))
    return out


def full_engine(make_engine, get_config, arch, seed=0):
    """A full-width engine and its random weights from ``seed``, drawn as
    ``run_serving`` draws them (params, then the adapter: b = 0)."""
    eng = make_engine(get_config(arch), lr=3e-3, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = eng.model.init(gen)
    return eng, params, eng.model.init_lora(gen)


def _rel(a, b):
    """max |a - b| over the largest |b| (float32)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max())


def serve_tapped(eng, params, lora, prompts, gen, *, registry=None,
                 aids=None, **kw):
    """``ContinuousBatcher.run`` over ``prompts`` on 8 slots, with taps on
    its prefill programs and admissions: each request's first-token
    logits (the row its monolithic or suffix wave, or its final chunk,
    computed), each wave's time between CUDA events around its program
    (the host runs ahead of the card, so the later of its host and device
    work), and each admission's blocks and matched-block count.  Returns
    (batcher, requests, stats, first logits by request id, {wave kind:
    [ms]}, admissions)."""
    from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
    pad = max(len(p) for p in prompts)
    b = ContinuousBatcher(eng, params, lora, n_slots=8, max_seq=pad + gen,
                          prompt_pad=pad, adapters=registry, **kw)
    first, events, admitted = {}, [], []
    wave, chunk, admit = b._prefill_wave, b._chunk_wave, b.admit

    def timed(kind, fn, *args):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = fn(*args)
        e.record()
        events.append((kind, s, e))
        return out

    def tap_wave(reqs, matched=None):
        kind = "suffix" if matched is not None and any(matched) else "full"
        firsts, pre, last = timed(kind, wave, reqs, matched)
        for r, row in zip(reqs, last):
            first[r.request_id] = row.float()
        return firsts, pre, last

    def tap_chunk(rows, pre_lens):
        logits = timed("chunk", chunk, rows, pre_lens)
        for j, (i, _) in enumerate(rows):   # the final chunk's row stays
            first[b.slot_req[i].request_id] = logits[j, -1].float()
        return logits

    def tap_admit(now=0.0):
        held = set(b.active_slots())
        out = admit(now)
        for i in b.active_slots():
            if i not in held and b.paged:
                admitted.append((b.slot_req[i], list(b.slot_blocks[i]),
                                 int(b.slot_cached[i]) // b.block_size))
        return out

    b._prefill_wave, b._chunk_wave, b.admit = tap_wave, tap_chunk, tap_admit
    reqs = [GenRequest(request_id=i, prompt=p, max_new_tokens=gen,
                       adapter_id=aids[i] if aids else None)
            for i, p in enumerate(prompts)]
    stats = b.run(reqs)
    # the taps close over the batcher: drop them, so the batcher (and the
    # weights and pool it holds) dies with the caller's last reference
    del b._prefill_wave, b._chunk_wave, b.admit
    torch.cuda.synchronize()
    times = {}
    for kind, s, e in events:
        times.setdefault(kind, []).append(s.elapsed_time(e))
    return b, reqs, stats, first, times, admitted


def cross_tenant_hits(admitted):
    """Aliased blocks that a request of another tenant wrote, replaying
    the admissions in order: each request's fresh blocks belong to its
    tenant from then on, and each of its matched blocks must already
    belong to it."""
    owner, crossed = {}, 0
    for req, blocks, matched in admitted:
        crossed += sum(owner.get(blk) != req.adapter_id
                       for blk in blocks[:matched])
        owner.update((blk, req.adapter_id) for blk in blocks[matched:])
    return crossed


def serve_row(name, arch, b, reqs, stats, times, gen, launches):
    """One result line of a tapped run and its checks: every request
    finished, the allocator drained (no block used or reserved, free and
    retained blocks the whole pool)."""
    row = {"run": name, "arch": arch, "finished": stats.finished,
           "decode_steps": stats.decode_steps,
           "prefill_waves": b.prefill_waves,
           "prefill_tokens_computed": stats.prefill_tokens,
           "cached_prefix_tokens": stats.cached_prefix_tokens,
           "throughput_tok_s": stats.throughput(), "wall_s": stats.wall_time,
           **latency_percentiles({"ttft_s": stats.ttft,
                                  "tpot_s": stats.tpot}),
           "wave_ms_mean": {k: statistics.mean(v) for k, v in times.items()},
           "waves": {k: len(v) for k, v in times.items()},
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "launches": launches}
    if b.paged:
        a = b.allocator
        row.update(peak_used_blocks=a.peak_used, pool_blocks=a.capacity,
                   blocks_used_at_end=a.n_used,
                   blocks_reserved_at_end=a.reserved,
                   blocks_free_at_end=a.n_free,
                   blocks_retained_at_end=a.n_retained)
    if b.prefix_cache is not None:
        row.update(prefix_cache_hits=b.prefix_cache.hits,
                   prefix_cache_misses=b.prefix_cache.misses,
                   prefix_cache_reclaimed=b.prefix_cache.reclaimed)
    if stats.finished != 16 or any(len(r.tokens) != gen for r in reqs):
        raise AssertionError(f"{name}: not every request finished")
    if b.paged and (b.allocator.n_used or b.allocator.reserved
                    or b.allocator.n_free + b.allocator.n_retained
                    != b.allocator.capacity):
        raise AssertionError(f"{name}: allocator did not drain")
    return row


def serve_launches(pda, lm, seg, fwd):
    return {"paged_decode_attention": pda.launches, "lora_matmul":
            lm.launches, "segmented_lora_matmul": seg.launches,
            "flash_attention": fwd.launches}


def check_launches(name, got, want):
    if got != want:
        raise AssertionError(f"{name}: launches {got}, derived {want}")


def phase_serve_prefix(make_engine, get_config, pda, lm, fa, seg):
    """Prefix caching at full width: qwen1.5-0.5b paged (blocks of 16),
    16 requests on 8 slots, two families sharing a 768-token prefix,
    tails of 32 to 224 tokens (prompt_pad 992: dense prefill), 32 tokens
    each, with the cache off and on; the same trace off and on for
    llama3-8b (GQA 4:1, head_dim 128); and with 4 tenants tagged
    round-robin, each pair of identical prompts to two tenants.  Every
    request finishes, the
    allocator drains, the cache hits, launches exactly as derived
    (lora_matmul, or with tenants segmented_lora_matmul, once per adapter
    projection per prefill wave and decode step; the decode kernel once
    per layer per step; flash_attention never), each request's first-token
    logits with the cache on within 2e-2 of the largest with it off
    (bf16), and no request aliases a block another tenant wrote."""
    from repro_torch.runtime.fabric import make_tenant_adapters
    from repro_torch.runtime.serving_loop import AdapterRegistry
    fwd = fa.flash_attention_fwd
    results = {}
    for arch, runs in ((ARCH, ("off", "on", "tenants")),
                       ("llama3-8b", ("off", "on"))):
        n_layers, n_lora, _ = arch_counts(get_config, arch)
        eng, params, lora = full_engine(make_engine, get_config, arch)
        for run in runs:
            tenants = run == "tenants"
            registry = aids = None
            if tenants:
                registry = AdapterRegistry(eng.model, capacity=4)
                for t, tree in enumerate(make_tenant_adapters(
                        eng.model, 4, seed=1)):
                    registry.register(f"tenant{t}", tree)
                aids = [f"tenant{i % 4}" for i in range(16)]
            prompts = prefix_trace(eng.model.cfg.vocab_size, paired=tenants)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset(pda, lm, fwd, seg)                     # main path starts
            b, reqs, stats, first, times, admitted = serve_tapped(
                eng, params, lora, prompts, PREFIX_GEN, registry=registry,
                aids=aids, paged=True, block_size=16,
                prefix_cache=run != "off")
            got = serve_launches(pda, lm, seg, fwd)       # path ends
            name = run if arch == ARCH else f"llama_{run}"
            per = n_lora * (b.prefill_waves + stats.decode_steps)
            check_launches(f"serve_prefix {name}", got, {
                "paged_decode_attention": n_layers * stats.decode_steps,
                "lora_matmul": 0 if tenants else per,
                "segmented_lora_matmul": per if tenants else 0,
                "flash_attention": 0})
            row = serve_row(name, arch, b, reqs, stats, times, PREFIX_GEN,
                            got)
            results[name] = (row, [r.tokens for r in reqs], first)
            if run != "off" and not b.prefix_cache.hits:
                raise AssertionError(f"serve_prefix {name}: no cache hit")
            if tenants:
                row["cross_tenant_aliased_blocks"] = \
                    cross_tenant_hits(admitted)
                row["adapter_refs_at_end"] = sum(
                    registry.refcount(a) for a in registry.registered())
                if row["cross_tenant_aliased_blocks"] \
                        or row["adapter_refs_at_end"]:
                    raise AssertionError(
                        "serve_prefix tenants: a request aliased another "
                        "tenant's blocks, or an adapter ref leaked")
            if run == "on":
                off_row, off_tok, off_first = results[
                    name.replace("on", "off")]
                errs = [_rel(first[i], off_first[i]) for i in range(16)]
                row.update(
                    first_logits_rel_err_vs_off=max(errs), tol=2e-2,
                    identical_token_streams_vs_off=sum(
                        t == o for t, o in zip(results[name][1], off_tok)),
                    prefill_tokens_computed_off=off_row[
                        "prefill_tokens_computed"])
                if max(errs) >= 2e-2:
                    raise AssertionError(
                        f"serve_prefix {name}: first-token logits with the "
                        f"cache on {max(errs)} from off, beyond 2e-2")
            emit("serve_prefix", **row)
            del b, first, registry
            torch.cuda.empty_cache()
        del eng, params, lora
        torch.cuda.empty_cache()
    return {k: v[0] for k, v in results.items()}


def phase_serve_chunked(make_engine, get_config, pda, lm, fa, seg):
    """Chunked prefill at full width: qwen1.5-0.5b, the serve phase's
    992 + 32 traffic (16 synthetic prompts on 8 slots), paged (blocks of
    16) and contiguous, prefill_chunk 256 against monolithic.  Every
    request finishes, the allocator drains, launches exactly as derived
    (a chunk wave is a prefill wave), and each request's final-chunk
    logits within 2e-2 of the largest of its monolithic prefill's."""
    from repro_torch.data.synthetic import SyntheticDataset
    fwd = fa.flash_attention_fwd
    n_layers, n_lora, _ = arch_counts(get_config, ARCH)
    eng, params, lora = full_engine(make_engine, get_config, ARCH)
    data = SyntheticDataset("alpaca", vocab_size=eng.model.cfg.vocab_size,
                            seq_len=992, seed=0)
    prompts = list(data.sample_tokens(16)[:, :992].astype(np.int32))
    results = {}
    for paged in (True, False):
        for chunk in (0, CHUNK):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset(pda, lm, fwd, seg)                     # main path starts
            b, reqs, stats, first, times, _ = serve_tapped(
                eng, params, lora, prompts, 32, paged=paged,
                prefill_chunk=chunk)
            got = serve_launches(pda, lm, seg, fwd)       # path ends
            name = f"{'paged' if paged else 'contiguous'}_" \
                f"{'chunk256' if chunk else 'monolithic'}"
            check_launches(f"serve_chunked {name}", got, {
                "paged_decode_attention": n_layers * stats.decode_steps,
                "lora_matmul": n_lora * (b.prefill_waves
                                         + stats.decode_steps),
                "segmented_lora_matmul": 0, "flash_attention": 0})
            row = serve_row(name, ARCH, b, reqs, stats, times, 32, got)
            results[(paged, chunk)] = (row, [r.tokens for r in reqs], first)
            if chunk:
                mono_tok, mono_first = results[(paged, 0)][1:]
                errs = [_rel(first[i], mono_first[i]) for i in range(16)]
                row.update(final_chunk_logits_rel_err_vs_monolithic=max(
                    errs), tol=2e-2, identical_token_streams_vs_monolithic=sum(
                        t == o for t, o in zip(results[(paged, chunk)][1],
                                               mono_tok)))
                if max(errs) >= 2e-2:
                    raise AssertionError(
                        f"serve_chunked {name}: final-chunk logits "
                        f"{max(errs)} from monolithic, beyond 2e-2")
            emit("serve_chunked", **row)
            del b, first
            torch.cuda.empty_cache()
    return {k: v[0] for k, v in results.items()}


# oversubscription at full width: 16 requests on 8 slots, 256-token
# prompts, 256 tokens each (max_seq 512: a request's worst case is 32
# blocks of 16); pools in blocks, scratch block 0 not counted
OVERSUB_PROMPT, OVERSUB_GEN, OVERSUB_SWAP_CHAIN = 256, 256, 62
OVERSUB_RUNS = [
    ("a_pool256", ARCH, 256, {}),           # every slot's worst case fits
    ("b_pool160", ARCH, 160, {}),           # admission holds 5 slots
    ("c_pool160_swap", ARCH, 160, dict(oversubscribe=1.0)),
    ("c_pool160_swap_sanitized", ARCH, 160, dict(oversubscribe=1.0)),
    ("d_pool160_drop", ARCH, 160, dict(oversubscribe=1.0, swap=False)),
    ("e_llama_pool160_swap", "llama3-8b", 160, dict(oversubscribe=1.0)),
]


def swap_round_trip(model, pda, pda_ref, reps=5):
    """A 62-block chain of a full-width bf16 pool (random from a seed)
    through the swap path as the batcher drives it: ``gather_blocks`` and
    the copy to host memory, ``swap_out``, ``swap_in`` onto fresh ids,
    ``scatter_blocks``.  The moved blocks must equal the originals
    bitwise, and paged_decode_attention (layer 0, 8 queries over the
    chain, 769-992 rows) over the remapped table must return bitwise its
    output over the original table.  Times: the host clock around each
    direction, synchronized (median of ``reps``), and ``paged_row``'s."""
    from repro_torch.runtime.paging import BlockAllocator
    cfg, bs, nb = model.cfg, 16, OVERSUB_SWAP_CHAIN
    pool = model.init_paged_caches(2 * nb + 1, bs)
    g = torch.Generator(device="cuda").manual_seed(11)
    for t in pool["kv"]:
        for layer in t:
            layer.copy_(torch.randn(layer.shape, generator=g,
                                    device="cuda"))
    alloc = BlockAllocator(2 * nb + 1, bs)
    alloc.reserve(nb)
    chain = [int(b) for b in np.random.default_rng(11).permutation(
        alloc.take(nb))]
    outs, ins = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = tuple(t.cpu() for t in model.gather_blocks(pool, chain)["kv"])
        outs.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        model.scatter_blocks(pool, chain, host)     # the same ids: a no-op
        torch.cuda.synchronize()
        ins.append(time.perf_counter() - t0)
    alloc.swap_out(chain)
    fresh = alloc.swap_in(nb)
    model.scatter_blocks(pool, fresh, host)
    torch.cuda.synchronize()
    moved_bitwise = all(torch.equal(t[:, fresh], t[:, chain])
                        for t in pool["kv"])
    block_bytes = sum(t[:, :1].numel() * t.element_size()
                      for t in pool["kv"])
    rng = np.random.default_rng(12)
    kv_len = rng.integers((nb - 14) * bs + 1, nb * bs + 1,
                          size=8).astype(np.int32)
    kv_len[0] = nb * bs
    kv_len = torch.tensor(kv_len, device="cuda")
    q = torch.randn((8, cfg.n_heads, cfg.head_dim), generator=g,
                    device="cuda").to(pool["kv"][0].dtype)
    kp, vp = pool["kv"][0][0], pool["kv"][1][0]
    orig = pda(q, kp, vp, torch.tensor([chain] * 8, dtype=torch.int32,
                                       device="cuda"), kv_len)
    tables = torch.tensor([fresh] * 8, dtype=torch.int32, device="cuda")
    out, row = paged_row(pda, pda_ref, q, kp, vp, tables, kv_len)
    swap_out_s, swap_in_s = statistics.median(outs), statistics.median(ins)
    row.update(
        blocks=nb, block_bytes=block_bytes, moved_bitwise=moved_bitwise,
        remapped_output_bitwise=bool(torch.equal(out, orig)),
        swap_out_ms_per_block=swap_out_s / nb * 1e3,
        swap_in_ms_per_block=swap_in_s / nb * 1e3,
        swap_out_gb_s=nb * block_bytes / swap_out_s / 1e9,
        swap_in_gb_s=nb * block_bytes / swap_in_s / 1e9)
    emit("serve_oversub", step="swap_round_trip", **row)
    if not (moved_bitwise and row["remapped_output_bitwise"] and row["ok"]
            and row["repeat_bitwise"]):
        raise AssertionError(f"swap round trip: {row}")
    return row


def oversub_run(eng, params, lora, prompts, n_blocks, sanitized=False,
                **kw):
    """One ``ContinuousBatcher.run`` of the oversubscription traffic
    (paged, blocks of 16, ``n_blocks`` + scratch), with taps: each
    swap-out's bytes and host seconds (as ``_SwapCost`` observes them),
    each swap-in's (``Model.scatter_blocks``, synchronized), each
    ``prefer_swap`` answer, each preemption's path, the ticks and, when
    ``sanitized`` (REPRO_SANITIZE=1 at construction), the host seconds of
    the decode-wave checks.  Returns (batcher, requests, stats, taps)."""
    from repro_torch.models.model import Model
    from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
    if sanitized:
        os.environ["REPRO_SANITIZE"] = "1"
    try:
        b = ContinuousBatcher(eng, params, lora, n_slots=8,
                              max_seq=OVERSUB_PROMPT + OVERSUB_GEN,
                              prompt_pad=OVERSUB_PROMPT, paged=True,
                              block_size=16, n_blocks=n_blocks + 1, **kw)
    finally:
        os.environ.pop("REPRO_SANITIZE", None)
    if sanitized and b.allocator.san is None:
        raise AssertionError("serve_oversub: the sanitizer did not arm")
    taps = {"swap_out": [], "swap_in": [], "prefer_swap": [], "paths": [],
            "ticks": 0, "sanitize_s": 0.0}
    if b.swap_cost is not None:
        observe, prefer = b.swap_cost.observe_swap, b.swap_cost.prefer_swap

        def tap_observe(nbytes, dt):
            taps["swap_out"].append((nbytes, dt))
            observe(nbytes, dt)

        def tap_prefer(tail_bytes, tokens):
            taps["prefer_swap"].append(prefer(tail_bytes, tokens))
            return taps["prefer_swap"][-1]

        b.swap_cost.observe_swap = tap_observe
        b.swap_cost.prefer_swap = tap_prefer
    preempt, step, check = b._preempt, b.step, b._sanitize_wave

    def tap_preempt(i, now):
        before = b.stats.swap_out_blocks
        preempt(i, now)
        taps["paths"].append("swap" if b.stats.swap_out_blocks > before
                             else "drop")

    def tap_step(*a, **k):
        taps["ticks"] += 1
        return step(*a, **k)

    def tap_check(active):
        t0 = time.perf_counter()
        check(active)
        taps["sanitize_s"] += time.perf_counter() - t0

    scatter = Model.scatter_blocks

    def tap_scatter(self, caches, ids, host_kv):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = scatter(self, caches, ids, host_kv)
        torch.cuda.synchronize()
        taps["swap_in"].append((len(ids), time.perf_counter() - t0))
        return out

    b._preempt, b.step, b._sanitize_wave = tap_preempt, tap_step, tap_check
    Model.scatter_blocks = tap_scatter
    reqs = [GenRequest(request_id=i, prompt=p, max_new_tokens=OVERSUB_GEN)
            for i, p in enumerate(prompts)]
    try:
        stats = b.run(reqs)
    finally:
        Model.scatter_blocks = scatter
        del b._preempt, b.step, b._sanitize_wave
        if b.swap_cost is not None:
            del b.swap_cost.observe_swap, b.swap_cost.prefer_swap
    torch.cuda.synchronize()
    return b, reqs, stats, taps


def phase_serve_oversub(make_engine, get_config, pda, pda_ref, lm, fa, seg):
    """KV-pool oversubscription at full width: first ``swap_round_trip``
    on qwen1.5-0.5b's pool, then OVERSUB_RUNS (16 requests on 8 slots,
    256 + 256 tokens, paged in blocks of 16): qwen on 256 blocks without
    oversubscription (every slot fits), on 160 without (admission holds 5
    slots), on 160 at ``oversubscribe`` 1.0 with swap and with
    ``swap=False``, llama3-8b on 160 with swap, and qwen's swap run again
    under REPRO_SANITIZE=1.  Every request finishes, the allocator drains,
    launches exactly as derived (a re-prefill is a prefill wave; swaps
    launch no kernel; flash_attention never), the oversubscribed runs
    preempt, the swap runs swap and the drop run re-prefills; the
    sanitized run adds no report.  Per run: tok/s, TTFT / TPOT, peak
    blocks, the four counters, ``_SwapCost``'s answers and the paths
    taken, swap-out / swap-in ms per block and GB/s, streams equal to
    run (a)'s (not asserted: waves of another composition can take
    other cuBLAS kernels)."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.runtime import sanitize
    fwd = fa.flash_attention_fwd
    results, engines = {}, {}
    reports = len(sanitize.reports())
    for name, arch, n_blocks, kw in OVERSUB_RUNS:
        if arch not in engines:
            engines.clear()
            torch.cuda.empty_cache()
            engines[arch] = full_engine(make_engine, get_config, arch)
            if arch == ARCH:
                round_trip = swap_round_trip(engines[arch][0].model, pda,
                                             pda_ref)
        eng, params, lora = engines[arch]
        n_layers, n_lora, _ = arch_counts(get_config, arch)
        data = SyntheticDataset("alpaca", vocab_size=eng.model.cfg.vocab_size,
                                seq_len=OVERSUB_PROMPT, seed=0)
        prompts = list(data.sample_tokens(16)[:, :OVERSUB_PROMPT]
                       .astype(np.int32))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(pda, lm, fwd, seg)                     # main path starts
        b, reqs, stats, taps = oversub_run(
            eng, params, lora, prompts, n_blocks,
            sanitized=name.endswith("sanitized"), **kw)
        got = serve_launches(pda, lm, seg, fwd)       # path ends
        check_launches(f"serve_oversub {name}", got, {
            "paged_decode_attention": n_layers * stats.decode_steps,
            "lora_matmul": n_lora * (b.prefill_waves + stats.decode_steps),
            "segmented_lora_matmul": 0, "flash_attention": 0})
        row = serve_row(name, arch, b, reqs, stats, {}, OVERSUB_GEN, got)
        out_b = sum(n for n, _ in taps["swap_out"])
        out_s = sum(dt for _, dt in taps["swap_out"])
        in_n = sum(n for n, _ in taps["swap_in"])
        in_s = sum(dt for _, dt in taps["swap_in"])
        block_bytes = b._block_bytes()
        row.update(
            pool_blocks_asked=n_blocks, ticks=taps["ticks"],
            host_ms_per_tick=stats.wall_time / taps["ticks"] * 1e3,
            preemptions=stats.preemptions,
            swap_out_blocks=stats.swap_out_blocks,
            swap_in_blocks=stats.swap_in_blocks,
            reprefill_tokens=stats.reprefill_tokens,
            preempted_by_path={p: taps["paths"].count(p)
                               for p in ("swap", "drop")},
            swap_cost_answers={"swap": taps["prefer_swap"].count(True),
                               "drop": taps["prefer_swap"].count(False)},
            swap_cost_state=None if b.swap_cost is None else {
                "swap_byte_s": b.swap_cost.swap_byte_s,
                "prefill_tok_s": b.swap_cost.prefill_tok_s},
            block_bytes=block_bytes,
            swap_out_ms_per_block=out_s / (out_b / block_bytes) * 1e3
            if out_b else None,
            swap_out_gb_s=out_b / out_s / 1e9 if out_b else None,
            swap_in_ms_per_block=in_s / in_n * 1e3 if in_n else None,
            swap_in_gb_s=in_n * block_bytes / in_s / 1e9 if in_n else None,
            tokens=[r.tokens for r in reqs])
        if name.endswith("sanitized"):
            row.update(sanitize_ms_per_tick=taps["sanitize_s"]
                       / taps["ticks"] * 1e3,
                       sanitizer_reports_added=len(sanitize.reports())
                       - reports)
        results[name] = row
        over = kw.get("oversubscribe", 0) > 0
        swapping = over and kw.get("swap", True)
        if (over and stats.preemptions == 0) \
                or (swapping and stats.swap_out_blocks == 0) \
                or (over and not swapping and stats.reprefill_tokens == 0):
            raise AssertionError(f"serve_oversub {name}: preemptions "
                                 f"{stats.preemptions}, swapped out / in "
                                 f"{stats.swap_out_blocks} / "
                                 f"{stats.swap_in_blocks}, re-prefilled "
                                 f"{stats.reprefill_tokens}")
        del b, reqs
        torch.cuda.empty_cache()
    engines.clear()
    a = results["a_pool256"]
    for name, row in results.items():
        if row["arch"] == ARCH and name != "a_pool256":
            row["identical_streams_vs_a"] = sum(
                t == o for t, o in zip(row["tokens"], a["tokens"]))
    san, plain = results["c_pool160_swap_sanitized"], \
        results["c_pool160_swap"]
    san["host_ms_per_tick_added"] = san["host_ms_per_tick"] \
        - plain["host_ms_per_tick"]
    for row in results.values():
        emit("serve_oversub", **{k: v for k, v in row.items()
                                 if k != "tokens"})
    if san["sanitizer_reports_added"]:
        raise AssertionError(f"serve_oversub: the sanitized run reported "
                             f"{sanitize.reports()[reports:]}")
    return {"round_trip": round_trip, **results}


def phase_static(make_engine, get_config, pda, lm, fa, seg):
    """The lock-step baseline against the batcher at full width:
    qwen1.5-0.5b, 16 requests of 32 + 16 tokens, ``static_batch_serve``
    in batches of 8 and ``ContinuousBatcher`` on 8 contiguous slots, with
    no EOS and then with an EOS id that request 0 emits (its third
    token).  Every request finishes under the same EOS rule (its tokens
    end at their first EOS, or hold all 16), launches exactly as derived
    (the static decode reaches the paged kernel through identity tables),
    tok/s of each; streams equal between the two, not asserted."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.runtime.serving_loop import (
        ContinuousBatcher, GenRequest, static_batch_serve,
    )
    fwd = fa.flash_attention_fwd
    n_layers, n_lora, _ = arch_counts(get_config, ARCH)
    eng, params, lora = full_engine(make_engine, get_config, ARCH)
    data = SyntheticDataset("alpaca", vocab_size=eng.model.cfg.vocab_size,
                            seq_len=32, seed=0)
    prompts = list(data.sample_tokens(16)[:, :32].astype(np.int32))
    rows, tokens, eos = {}, {}, None
    for eos_run in (False, True):
        for kind in ("continuous", "static"):
            reqs = [GenRequest(request_id=i, prompt=p.copy(),
                               max_new_tokens=16)
                    for i, p in enumerate(prompts)]
            _reset(pda, lm, fwd, seg)                 # main path starts
            if kind == "static":
                stats = static_batch_serve(eng, params, lora, reqs,
                                           batch_size=8, prompt_pad=32,
                                           max_seq=48, eos_id=eos)
                waves = 2
            else:
                b = ContinuousBatcher(eng, params, lora, n_slots=8,
                                      max_seq=48, prompt_pad=32, eos_id=eos)
                stats = b.run(reqs)
                waves = b.prefill_waves
            got = serve_launches(pda, lm, seg, fwd)   # path ends
            name = f"{kind}{'_eos' if eos_run else ''}"
            check_launches(f"static {name}", got, {
                "paged_decode_attention": n_layers * stats.decode_steps,
                "lora_matmul": n_lora * (waves + stats.decode_steps),
                "segmented_lora_matmul": 0, "flash_attention": 0})
            rule = all(
                len(r.tokens) == (r.tokens.index(eos) + 1
                                  if eos in r.tokens else 16)
                for r in reqs)
            rows[name] = {"run": name, "eos_id": eos,
                          "finished": stats.finished,
                          "generated_tokens": stats.generated_tokens,
                          "decode_steps": stats.decode_steps,
                          "throughput_tok_s": stats.throughput(),
                          "wall_s": stats.wall_time, "eos_rule_held": rule,
                          "launches": got}
            tokens[name] = [r.tokens for r in reqs]
            if stats.finished != 16 or not rule \
                    or any(r.finished_wall is None for r in reqs):
                raise AssertionError(f"static {name}: {rows[name]}")
        if not eos_run:
            eos = tokens["continuous"][0][2]
    for suffix in ("", "_eos"):
        rows["static" + suffix]["identical_streams_vs_continuous"] = sum(
            t == o for t, o in zip(tokens["static" + suffix],
                                   tokens["continuous" + suffix]))
    for row in rows.values():
        emit("static", **row)
    if not any(len(t) < 16 for t in tokens["static_eos"]):
        raise AssertionError("static: the EOS id never fired")
    return rows


BUDGET_RUNS = [("paged", "paged", dict(prompt_len=32, gen_tokens=16)),
               ("paged_992_chunk256", "paged_992",
                dict(prompt_len=992, gen_tokens=32, prefill_chunk=CHUNK))]
TPOT_TARGET = 0.1


def budget_seeded(make_engine, get_config, kw):
    """Bring-up (the ``budget_seeded`` phase, never in the full run): a
    policy the runtime does not have.  The budget run of ``kw`` with its
    train cost priced first: one
    idle tick before the trace trains alone (``step`` on an empty
    batcher), which ``_TickBudget`` measures (after one unpriced warm-up
    step outside the batcher); then the trace as ``run_serving`` serves
    it (same weights, prompts and train data).  Returns the
    ``run_serving``-like counters."""
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
    eng, params, lora = full_engine(make_engine, get_config, ARCH)
    plen, gen = kw["prompt_len"], kw["gen_tokens"]
    data = SyntheticDataset("alpaca", vocab_size=eng.model.cfg.vocab_size,
                            seq_len=plen, seed=0)
    b = ContinuousBatcher(eng, params, lora, n_slots=8, max_seq=plen + gen,
                          prompt_pad=plen, opt_state=eng.optimizer.init(lora),
                          paged=True, prefill_chunk=kw.get("prefill_chunk", 0),
                          tpot_target=TPOT_TARGET)
    prompts = data.sample_tokens(16)[:, :plen]
    # one unpriced step first (its result dropped), so that the priced
    # idle tick is warm: the budget never re-prices a skipped train step
    warm = {k: torch.as_tensor(v, device="cuda")
            for k, v in data.batch(4).items()}
    eng.train_step(params, lora, eng.optimizer.init(lora), warm)
    b.step(train_batch=data.batch(4))       # the idle tick: priced
    seeded_s = b.budget.train_tok_s
    rows = []

    def train_fn():
        if b.last_tick_trained:
            rows.append(b.last_tick_train_rows)
        return data.batch(4)

    stats = b.run([GenRequest(request_id=i, prompt=prompts[i],
                              max_new_tokens=gen) for i in range(16)],
                  train_data_fn=train_fn)
    if b.last_tick_trained:
        rows.append(b.last_tick_train_rows)
    # the counters without the idle tick (its rows, step and budget tick)
    return {"finished": stats.finished, "decode_steps": stats.decode_steps,
            "prefill_waves": b.prefill_waves,
            "train_steps": stats.train_steps - 1, "train_rows": rows[1:],
            "train_losses": b.train_losses[1:],
            "train_skipped_ticks": stats.train_skipped_ticks,
            "budget_ticks": stats.budget_ticks - 1,
            "budget_spent_s": stats.budget_spent_s,
            "budget_target_s": stats.budget_target_s - TPOT_TARGET,
            "throughput_tok_s": stats.throughput(),
            "ttft_s": stats.ttft, "tpot_s": stats.tpot,
            "train_tok_s_seeded": seeded_s,
            "train_tok_s_end": b.budget.train_tok_s,
            "decode_tick_s_end": b.budget.decode_tick_s,
            "blocks_used_at_end": b.allocator.n_used,
            "blocks_reserved_at_end": b.allocator.reserved}


def phase_budget(run_serving, make_engine, get_config, pda, lm, fa, seg,
                 combined=None, seeded=False):
    """Co-training under a decode TPOT target of 0.1 s (``run_serving(
    combined=True, tpot_target=0.1)``, paged, train batch 4 x prompt
    length): 32 + 16, and 992 + 32 with 256-token chunks.  ``seeded``
    (the ``budget_seeded`` bring-up phase): each run instead with the
    train cost priced first by an idle train tick (``budget_seeded``: the
    reference prices training only on a tick without serving work, which
    a saturated trace never has).  Reports what the budget trained
    (steps, rows per trained tick, skipped ticks), its spend against its
    target and TPOT, beside the combined phase's unbudgeted run of the
    same traffic, and the host ms of drawing one train batch as
    ``run_serving``'s train_fn draws it before every tick, trained or
    skipped (outside ``step``, so outside the budget's own clock).
    Checks: every request finishes, every loss finite, the allocator
    drains, launches as derived; no outcome of the plan is asserted."""
    from repro_torch.data.synthetic import SyntheticDataset
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_backward
    n_layers, n_lora, n_lora_bwd = arch_counts(get_config, ARCH)
    results = {}
    for name, ref, kw in BUDGET_RUNS:
        torch.cuda.synchronize()
        _reset(pda, lm, fwd, bwd, seg)                    # main path starts
        if seeded:
            out = budget_seeded(make_engine, get_config, kw)
        else:
            out = run_serving(ARCH, smoke=False, n_requests=16, batch_size=8,
                              combined=True, train_batch=4, seed=0,
                              device="cuda", verbose=False, paged=True,
                              tpot_target=TPOT_TARGET, **kw)
        got = {**serve_launches(pda, lm, seg, fwd),
               "flash_attention_backward": bwd.launches}  # path ends
        name = f"{name}_seeded" if seeded else name
        steps = out["train_steps"] + 2 * seeded   # warm-up and idle tick
        check_launches(f"budget {name}", got, {
            "paged_decode_attention": n_layers * out["decode_steps"],
            "lora_matmul": n_lora * (out["prefill_waves"]
                                     + out["decode_steps"])
            + (n_lora + n_lora_bwd) * steps,
            "segmented_lora_matmul": 0, "flash_attention": 0,
            "flash_attention_backward": 0})
        rows = out["train_rows"]
        steps = out["train_steps"]
        row = {"run": name, "tpot_target_s": TPOT_TARGET,
               "prompt_len": kw["prompt_len"], "gen_tokens": kw["gen_tokens"],
               "prefill_chunk": kw.get("prefill_chunk", 0),
               "train_batch": [4, kw["prompt_len"]],
               "finished": out["finished"],
               "decode_steps": out["decode_steps"],
               "budget_ticks": out["budget_ticks"], "train_steps": steps,
               "train_rows_per_trained_tick": rows,
               "train_skipped_ticks": out["train_skipped_ticks"],
               "budget_spent_s": out["budget_spent_s"],
               "budget_target_s": out["budget_target_s"],
               "budget_spent_over_target":
                   out["budget_spent_s"] / out["budget_target_s"],
               "throughput_tok_s": out["throughput_tok_s"],
               **latency_percentiles(out), "launches": got,
               "losses_finite": bool(np.isfinite(out["train_losses"]).all())}
        if seeded:
            row.update({k: out[k] for k in (
                "train_tok_s_seeded", "train_tok_s_end", "decode_tick_s_end")})
        data = SyntheticDataset("alpaca",
                                vocab_size=get_config(ARCH).vocab_size,
                                seq_len=kw["prompt_len"], seed=0)
        draws = []
        for _ in range(3):
            t0 = time.perf_counter()
            data.batch(4)
            draws.append((time.perf_counter() - t0) * 1e3)
        row["train_batch_draw_host_ms"] = statistics.median(draws)
        if combined is not None and ref in combined:
            c = combined[ref]
            row["unbudgeted"] = {k: c[k] for k in (
                "train_steps", "decode_steps", "throughput_tok_s",
                "tpot_p50_ms", "tpot_p99_ms", "ttft_p50_ms", "ttft_p99_ms")}
        emit("budget", **row)
        if out["finished"] != 16 or not row["losses_finite"] \
                or len(rows) != steps:
            raise AssertionError(f"budget {name}: a request unfinished, a "
                                 "loss not finite, or rows miscounted")
        if out["blocks_used_at_end"] or out["blocks_reserved_at_end"]:
            raise AssertionError(f"budget {name}: allocator did not drain")
        results[name] = row
        del out
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------ multi-tenant ----
# (name, arch, run_serving kwargs, phase_serve run of the same traffic
# with one adapter): 4 tenants on 4 device slots unless named, tagged
# round-robin over 16 requests on 8 slots
ADAPTER_RUNS = [
    ("paged", ARCH, dict(paged=True, prompt_len=32, gen_tokens=16), "paged"),
    ("contiguous", ARCH, dict(paged=False, prompt_len=32, gen_tokens=16),
     "contiguous"),
    ("paged_992", ARCH, dict(paged=True, prompt_len=992, gen_tokens=32),
     "paged_992"),
    ("paged_2048", ARCH, dict(paged=True, prompt_len=2048, gen_tokens=32),
     "paged_2048"),
    ("paged_6_on_4", ARCH, dict(paged=True, prompt_len=32, gen_tokens=16,
                                n_adapters=6, adapter_slots=4), None),
    ("combined_paged", ARCH, dict(paged=True, prompt_len=32, gen_tokens=16,
                                  combined=True, train_batch=4), "paged"),
    ("llama_paged", "llama3-8b", dict(paged=True, prompt_len=32,
                                      gen_tokens=16), None),
]


def phase_serve_adapters(run_serving, get_config, pda, lm, fa, seg,
                         serve=None):
    """Multi-tenant serving at full width (``run_serving(n_adapters=...)``,
    random tenants from ``make_tenant_adapters``): every request finishes,
    the allocator drains, every adapter ref returns, the tenants' streams
    differ, and the launches are exactly as derived: segmented_lora_matmul
    once per adapter projection per prefill wave and decode step,
    lora_matmul never when serving and forward plus dX per train step
    when co-training.  Against the serve phase's run of the same traffic
    (one adapter with b = 0, same weights and prompts, admitted in the
    same waves): tenant 0 (b = 0 too) emits its tokens exactly and every
    other tenant differs on some request; with co-training too, since
    decode reads the registry's copies, which training leaves alone."""
    results = {}
    fwd = fa.flash_attention_fwd
    for name, arch, kw, ref_name in ADAPTER_RUNS:
        kw = {"n_adapters": 4, **kw}
        n_layers, n_lora, n_lora_bwd = arch_counts(get_config, arch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset(pda, lm, fwd, seg)                         # main path starts
        out = run_serving(arch, smoke=False, n_requests=16, batch_size=8,
                          seed=0, device="cuda", verbose=False, **kw)
        launches, lora_launches, flash, seg_launches = \
            pda.launches, lm.launches, fwd.launches, seg.launches  # ends
        gen, steps = kw["gen_tokens"], out["decode_steps"]
        seg_want = n_lora * (out["prefill_waves"] + steps)
        lora_want = (n_lora + n_lora_bwd) * out["train_steps"]
        flash_want = n_layers * out["prefill_waves"] \
            if long_prompt(kw["prompt_len"]) else 0
        aids = out["adapter_ids"]
        row = {
            "run": name, "arch": arch, "prompt_len": kw["prompt_len"],
            "gen_tokens": gen, "tenants": kw["n_adapters"],
            "adapter_slots": kw.get("adapter_slots") or kw["n_adapters"],
            "combined": bool(kw.get("combined")),
            "finished": out["finished"],
            "tokens_generated": out["tokens_generated"],
            "decode_steps": steps, "prefill_waves": out["prefill_waves"],
            "train_steps": out["train_steps"],
            "segmented_lora_matmul_launches": seg_launches,
            "segmented_lora_matmul_launches_derived": seg_want,
            "lora_matmul_launches": lora_launches,
            "lora_matmul_launches_derived": lora_want,
            "kernel_launches": launches,
            "flash_attention_launches": flash,
            "adapter_requests": out["adapter_requests"],
            "adapter_hits": out["adapter_hits"],
            "adapter_loads": out["adapter_loads"],
            "adapter_evictions": out["adapter_evictions"],
            "adapter_refs_at_end": out["adapter_refs_at_end"],
            "throughput_tok_s": out["throughput_tok_s"],
            "wall_s": out["wall_s"],
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "train_losses_first_last": out["train_losses"][:1]
            + out["train_losses"][-1:],
        }
        if kw["paged"]:
            row.update(blocks_used_at_end=out["blocks_used_at_end"],
                       blocks_reserved_at_end=out["blocks_reserved_at_end"])
        failed = []
        if out["finished"] != 16 or any(len(t) != gen for t in out["tokens"]):
            failed.append("not every request finished")
        if kw["paged"] and (out["blocks_used_at_end"]
                            or out["blocks_reserved_at_end"]):
            failed.append("allocator did not drain")
        if set(out["adapter_refs_at_end"].values()) != {0}:
            failed.append("adapter refs left pinned")
        if (seg_launches, lora_launches, flash, launches) != (
                seg_want, lora_want, flash_want, n_layers * steps):
            failed.append("launch counts differ from the derived ones")
        if name == "paged_6_on_4" and out["adapter_evictions"] < 1:
            failed.append("6 tenants on 4 slots evicted none")
        if kw.get("combined") and (out["train_steps"] != steps or not
                                   np.isfinite(out["train_losses"]).all()):
            failed.append("not one finite train step per tick")
        if serve is not None and ref_name is not None:
            ref_tokens = serve[ref_name][1]
            same = {t: [out["tokens"][i] == ref_tokens[i]
                        for i in range(16) if aids[i] == t]
                    for t in sorted(set(aids))}
            row["tokens_equal_single_adapter_run"] = same
            if not all(same["tenant0"]) or any(
                    all(v) for t, v in same.items() if t != "tenant0"):
                failed.append("tenant 0 drifted from the single-adapter "
                              "run, or another tenant emitted its tokens")
        # each tenant's first request against every other tenant's
        firsts = {}
        for i, t in enumerate(aids):
            firsts.setdefault(t, out["tokens"][i])
        row["tenants_with_distinct_streams"] = len(
            {tuple(v) for v in firsts.values()})
        if row["tenants_with_distinct_streams"] != len(firsts):
            failed.append("two tenants emitted the same stream")
        emit("serve_adapters", **row)
        if failed:
            raise AssertionError(f"serve_adapters {name}: {failed}")
        results[name] = row
        del out
        torch.cuda.empty_cache()
    return results


def phase_mixed_solo(get_config, make_engine, seg, lm):
    """One paged wave of base, tenant 0, tenant 1 and tenant 2 at full
    width (4 slots, 32-token prompts, 16 new tokens), then each of them
    served alone as the server's single adapter (base: an adapter with
    b = 0) on the same four prompts: each row's greedy tokens must be
    identical, since the kernel makes every row bitwise lora_matmul's with
    its own adapter.  Read out beside it, not checked: each request served
    in a wave of its own, against the mixed wave and, as the control,
    against the same single-adapter server in the wave of four.  cuBLAS
    picks its kernel for the frozen products (MLP, logits head) by M, so
    a wave of one rounds otherwise, and random full-width weights leave
    near-tied logits that such last bits flip."""
    from repro_torch.runtime.fabric import make_tenant_adapters
    from repro_torch.runtime.serving_loop import (
        AdapterRegistry, ContinuousBatcher, GenRequest)
    cfg = get_config(ARCH)
    engine = make_engine(cfg, device="cuda")
    model = engine.model
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    base = model.init_lora(gen)
    tenants = make_tenant_adapters(model, 3, seed=1)
    reg = AdapterRegistry(model, capacity=3)
    for t, tree in enumerate(tenants):
        reg.register(f"tenant{t}", tree)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32))
    aids = [None, "tenant0", "tenant1", "tenant2"]
    trees = [base] + tenants

    def serve(lora, rows, registry=None):
        b = ContinuousBatcher(engine, params, lora, n_slots=4, max_seq=48,
                              prompt_pad=32, paged=True, adapters=registry)
        reqs = [GenRequest(request_id=i, prompt=prompts[i],
                           max_new_tokens=16,
                           adapter_id=aids[i] if registry else None)
                for i in rows]
        b.run(reqs)
        return [r.tokens for r in reqs]

    _reset(seg, lm)
    mixed = serve(tenants[0], range(4), reg)
    mixed_launches = (seg.launches, lm.launches)
    solo = [serve(tree, range(4))[i] for i, tree in enumerate(trees)]
    alone = [serve(tree, [i])[0] for i, tree in enumerate(trees)]
    same = [m == o for m, o in zip(mixed, solo)]
    emit("mixed_solo", config=cfg.name, dtype=cfg.dtype, slots=4,
         prompt_len=32, gen_tokens=16, rows=["base"] + aids[1:],
         tokens_equal=same,
         distinct_streams=len({tuple(t) for t in mixed}),
         mixed_segmented_launches=mixed_launches[0],
         mixed_lora_matmul_launches=mixed_launches[1],
         wave_of_one_equal_mixed=[m == a for m, a in zip(mixed, alone)],
         wave_of_one_equal_single_adapter_wave=[
             o == a for o, a in zip(solo, alone)])
    if not all(same) or len({tuple(t) for t in mixed}) != 4 \
            or mixed_launches[1] != 0 or mixed_launches[0] == 0:
        raise AssertionError(f"mixed wave vs solo: tokens equal {same}")
    del engine, params, base, tenants, reg, trees
    torch.cuda.empty_cache()


def phase_train(make_engine, get_config, lm, steps=10):
    """Full-width train steps on one fixed batch: the loss must fall."""
    from repro_torch.data.synthetic import SyntheticDataset
    cfg = get_config(ARCH)
    eng = make_engine(cfg, lr=3e-3, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = eng.model.init(gen)
    lora = eng.model.init_lora(gen)
    opt = eng.optimizer.init(lora)
    data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size,
                            seq_len=256, seed=1)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.batch(4).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, per_step = [], [], []
    for _ in range(steps):
        lm.launches = 0
        t0 = time.perf_counter()
        lora, opt, met = eng.train_step(params, lora, opt, batch)
        losses.append(float(met["ce_loss"]))      # syncs
        times.append((time.perf_counter() - t0) * 1e3)
        per_step.append(lm.launches)
    emit("train", config=cfg.name, batch=[4, 256], lr=3e-3, losses=losses,
         step_ms=times, lora_matmul_launches_per_step=per_step,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall {losses}")
    if set(per_step) != {N_LORA + N_LORA_BWD}:
        raise AssertionError(f"train: lora_matmul launches {per_step}")


# ------------------------------------------------------- training CLI ----
TRAIN_STEPS, TRAIN_CKPT_EVERY = 20, 10      # (b); (c) resumes to 30
TRAIN_LONG_SEQ, TRAIN_LONG_STEPS = 2048, 3  # (d): past the dense limit
CLI_SEQ, CLI_STEPS = 128, 10                # (e), then --restore to 15
LLAMA_TRAIN_STEPS = 5                       # (f): the CLI's default arch
# (a) card vs CPU, float32 reduced: the loss of each step within 1e-5
# relative (the reference phase's one-step tolerance); the adapters
# within 2e-4 absolute after 15 steps (AdamW's normalised update turns
# float32 noise in a near-zero gradient component into a step-sized
# difference: lr 3e-3; tests/test_torch_train_cli.py's bound against JAX)
TRAIN_LOSS_RTOL, TRAIN_LORA_ATOL = 1e-5, 2e-4


class TrainTap:
    """Taps ``run_training`` / ``train_from_weights`` while entered: the
    host clock of each loop iteration (from one ``Engine.train_step``
    call to the next), of the step's dispatch and of the wait that the
    loop's ``float(ce_loss)`` pull then takes (the tap synchronises
    first, so the pull finds the loss ready), the last batch trained on,
    the seconds of every ``Checkpointer.save`` and ``wait``, and the
    trees ``restore`` returned."""

    def __enter__(self):
        from repro_torch.checkpoint.checkpointer import Checkpointer
        from repro_torch.core.engine import Engine
        self._orig = (Engine.train_step, Checkpointer.save,
                      Checkpointer.wait, Checkpointer.restore)
        step, save, wait, restore = self._orig
        self.starts, self.dispatch_ms, self.pull_ms = [], [], []
        self.save_s, self.wait_s, self.restored = [], [], []

        def train_step(eng, *a, **kw):
            t0 = time.perf_counter()
            self.starts.append(t0)
            self.last_batch = a[3]
            out = step(eng, *a, **kw)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            self.dispatch_ms.append((t1 - t0) * 1e3)
            self.pull_ms.append((time.perf_counter() - t1) * 1e3)
            return out

        def timed(fn, into):
            def call(ck, *a, **kw):
                t0 = time.perf_counter()
                out = fn(ck, *a, **kw)
                into.append(time.perf_counter() - t0)
                return out
            return call

        def restore_(ck, *a, **kw):
            out = restore(ck, *a, **kw)
            self.restored.append(out[0])
            return out

        Engine.train_step = train_step
        Checkpointer.save = timed(save, self.save_s)
        Checkpointer.wait = timed(wait, self.wait_s)
        Checkpointer.restore = restore_
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from repro_torch.checkpoint.checkpointer import Checkpointer
        from repro_torch.core.engine import Engine
        self.wall_s = time.perf_counter() - self.t0
        (Engine.train_step, Checkpointer.save, Checkpointer.wait,
         Checkpointer.restore) = self._orig
        return False

    def row(self):
        """Per-iteration host ms (the last step's runs to the end of the
        call: its checkpoint and the final save), dispatch ms, pull ms,
        and the pulls' share of the loop's wall."""
        ends = self.starts[1:] + [self.t0 + self.wall_s]
        it = [(b - a) * 1e3 for a, b in zip(self.starts, ends)]
        return {"step_ms": it, "dispatch_ms": self.dispatch_ms,
                "loss_pull_wait_ms": self.pull_ms,
                "loss_pull_share": sum(self.pull_ms) / max(sum(it), 1e-9),
                "save_s": self.save_s, "wait_s": self.wait_s}


def _ce(model, params, lora_trees, batch):
    """The CE of each adapter on one batch."""
    with torch.no_grad():
        return [float(model.forward_loss(params, lo, batch)[0])
                for lo in lora_trees]


def _held_out(model, seq, rows, rng=None):
    """A batch of the training chain (domain ``alpaca``, seed 0) on the
    card: with ``rng``, rows no training step draws."""
    from repro_torch.data.synthetic import SyntheticDataset
    data = SyntheticDataset("alpaca", vocab_size=model.cfg.vocab_size,
                            seq_len=seq, seed=0)
    return {k: torch.as_tensor(v, device=model.device)
            for k, v in data.batch(rows, rng=rng).items()}


def _to(tree, device):
    """A copy of a tree of tensors (dicts, tuples, NamedTuples) on
    ``device``."""
    from repro_torch.checkpoint.checkpointer import _tree_paths, _unflatten
    return _unflatten(tree, iter([t.to(device, copy=True)
                                  for _, t in _tree_paths(tree)]))


def _bitwise(a, b):
    from repro_torch.checkpoint.checkpointer import _tree_paths
    la, lb = _tree_paths(a), _tree_paths(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        for (_, x), (_, y) in zip(la, lb))


def _train_reduced(make_engine, get_config, tmp):
    """(a) ``train_from_weights`` on the reduced float32 qwen, one weight
    set, on the CPU and on the card: 15 steps (a checkpoint every 5),
    then 25 with a NaN injected at step 12."""
    import contextlib
    import io
    from repro_torch.launch.train import init_weights, train_from_weights
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config(ARCH).scaled()
    params, lora = init_weights(make_engine(cfg, device="cpu"), 0)
    runs = {}
    for dev in ("cpu", "cuda"):
        for name, kw in (("plain", dict(steps=15)),
                         ("nan", dict(steps=25, inject_nan_at=12))):
            eng = make_engine(cfg, lr=3e-3, device=dev)
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                out = train_from_weights(
                    eng, tree_map(lambda t: t.to(dev), params),
                    tree_map(lambda t: t.to(dev), lora), arch=ARCH,
                    batch=4, seq=32, ckpt_every=5, log_every=5,
                    ckpt_dir=os.path.join(tmp, f"a_{name}_{dev}"), **kw)
            out["rollbacks"] = [ln for ln in log.getvalue().splitlines()
                                if "non-finite" in ln]
            runs[(name, dev)] = out
    row = {}
    for name in ("plain", "nan"):
        cpu, gpu = runs[(name, "cpu")], runs[(name, "cuda")]
        loss_err = max(abs(a - b) / abs(b)
                       for a, b in zip(gpu["losses"], cpu["losses"]))
        lora_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
            tree_leaves(gpu["lora"]), tree_leaves(cpu["lora"])))
        row[name] = {"steps": [cpu["steps"], gpu["steps"]],
                     "kept_losses": [len(cpu["losses"]), len(gpu["losses"])],
                     "loss_rel_err": loss_err, "lora_max_abs_err": lora_err,
                     "rollbacks": gpu["rollbacks"],
                     "first_loss": gpu["losses"][0],
                     "last_loss": gpu["losses"][-1]}
        want_steps = 15 if name == "plain" else 25
        want_kept = want_steps + (2 if name == "nan" else 0)
        want_log = ["step 12: non-finite loss; restoring step 10"] \
            if name == "nan" else []
        if not (cpu["steps"] == gpu["steps"] == want_steps
                and len(cpu["losses"]) == len(gpu["losses"]) == want_kept
                and cpu["rollbacks"] == gpu["rollbacks"] == want_log
                and np.isfinite(gpu["losses"]).all()):
            raise AssertionError(f"train_cli (a) {name}: steps, kept losses "
                                 f"or rollbacks differ: {row[name]}")
        if not (loss_err <= TRAIN_LOSS_RTOL and lora_err <= TRAIN_LORA_ATOL):
            raise AssertionError(f"train_cli (a) {name}: card vs CPU "
                                 f"beyond tolerance: {row[name]}")
    emit("train_cli_reduced", config=cfg.name, dtype="float32", batch=[4, 32],
         loss_rtol=TRAIN_LOSS_RTOL, lora_atol=TRAIN_LORA_ATOL, **row)
    return row


def phase_train_cli(make_engine, get_config, lm, fa):
    """The training CLI (``launch/train.py``) on the card: (a) card vs
    CPU at the reduced float32 config, through a NaN rollback; (a2)
    held-out CE falls at the reduced config; (b) full width qwen, 4 x
    256, 20 steps, checkpoints every 10: CE on the last batch falls,
    launches as derived, step ms, the pulls' share, checkpoint
    seconds, peak memory; (c) the restart to 30 from (b)'s directory,
    and checkpoints across devices; (d) 4 x 2,048 through
    ``flash_attention``; (e) the CLI in subprocesses with a restore; (f)
    llama3-8b at the CLI's defaults; (g) ``DataPipeline`` on the card.
    Every lora_matmul launch shape of (b)-(f) was held against the plain
    version by ``kernel_lora``."""
    import contextlib
    import io
    import tempfile
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.checkpoint import checkpointer as ckpt_mod
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.launch.train import init_weights, run_training
    from repro_torch.optim.adamw import AdamWState
    fwd, bwd = fa.flash_attention_fwd, fa.flash_attention_backward
    n_layers, n_lora, n_lora_bwd = arch_counts(get_config, ARCH)
    per_step = n_lora + n_lora_bwd
    res, shapes = {}, {}
    tmp = tempfile.mkdtemp()
    try:
        res["a"] = _train_reduced(make_engine, get_config, tmp)

        # (a2) tests/test_drivers.py's check on the card: reduced qwen,
        # 30 steps of 8 x 32 at lr 5e-3, held-out CE falls
        out_a2 = run_training(ARCH, smoke=True, steps=30, batch=8, seq=32,
                              ckpt_dir=os.path.join(tmp, "a2"),
                              ckpt_every=10, lr=5e-3, verbose=False,
                              device="cuda")
        eng = make_engine(get_config(ARCH).scaled(), device="cuda")
        params, lora0 = init_weights(eng, 0)
        a2 = _ce(eng.model, params, [lora0, out_a2["lora"]],
                 _held_out(eng.model, 32, 16))
        emit("train_cli_reduced_held_out", config=eng.model.cfg.name,
             steps=out_a2["steps"], batch=[8, 32], lr=5e-3,
             held_out_ce_initial_trained=a2)
        res["a2"] = a2
        if out_a2["steps"] != 30 or not a2[1] < a2[0]:
            raise AssertionError(f"train_cli (a2): held-out CE {a2}")
        del eng, params, lora0, out_a2

        # (b) full width, dense path
        ckb = os.path.join(tmp, "b")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with LoraShapeTap() as st, TrainTap() as tt:
            _reset(lm, fwd, bwd)                          # main path starts
            out_b = run_training(ARCH, smoke=False, steps=TRAIN_STEPS,
                                 batch=4, seq=256, ckpt_dir=ckb,
                                 ckpt_every=TRAIN_CKPT_EVERY, verbose=False,
                                 device="cuda")
            launches = (lm.launches, fwd.launches, bwd.launches)  # ends
        shapes.update(st.shapes)
        eng = make_engine(get_config(ARCH), device="cuda")
        params, lora0 = init_weights(eng, 0)
        trees = [lora0, out_b["lora"]]
        held = _ce(eng.model, params, trees, _held_out(
            eng.model, 256, 8, np.random.default_rng(12345)))
        last = _ce(eng.model, params, trees, tt.last_batch)
        del params, lora0, eng, trees
        b = {"config": ARCH, "dtype": "bfloat16", "batch": [4, 256],
             "steps": out_b["steps"], "losses": out_b["losses"],
             "held_out_ce_initial_trained": held,
             "last_batch_ce_initial_trained": last,
             "lora_matmul_launches": launches[0],
             "lora_matmul_launches_derived": TRAIN_STEPS * per_step,
             "flash_attention_launches": list(launches[1:]),
             "checkpoints": sorted(os.listdir(ckb)), **tt.row(),
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        emit("train_cli_full", **b)
        res["b"] = b
        # at full width the chain has 151,936 states with 7 successors
        # each, which 20 x 1,024 tokens do not teach: held-out CE is
        # reported, and learning is held on the last batch trained on
        # ((a2) holds held-out CE where the chain is learnable)
        if out_b["steps"] != TRAIN_STEPS or not last[1] < last[0]:
            raise AssertionError(f"train_cli (b): CE on the last batch "
                                 f"{last} in {out_b['steps']} steps")
        if launches != (TRAIN_STEPS * per_step, 0, 0):
            raise AssertionError(f"train_cli (b): launches {launches}, "
                                 f"derived {TRAIN_STEPS * per_step}, 0, 0")
        if b["checkpoints"] != ["step_0000000010", "step_0000000020"]:
            raise AssertionError(f"train_cli (b): {b['checkpoints']}")

        # (c) restart from (b)'s directory
        log = io.StringIO()
        with LoraShapeTap() as st, TrainTap() as tt, \
                contextlib.redirect_stdout(log):
            _reset(lm, fwd, bwd)
            out_c = run_training(ARCH, smoke=False, steps=30, batch=4,
                                 seq=256, ckpt_dir=ckb, restore=True,
                                 ckpt_every=TRAIN_CKPT_EVERY, verbose=True,
                                 log_every=100, device="cuda")
            c_launches = lm.launches
        shapes.update(st.shapes)
        got_lora, got_opt = tt.restored[0]
        # a card checkpoint onto the CPU, and a CPU one onto the card
        on_cpu, _ = Checkpointer(ckb).restore((out_b["lora"], got_opt),
                                              step=20, device="cpu")
        mixed = {"lora": _to(out_b["lora"], "cpu"),
                 "bf16": torch.randn(64, 96, generator=torch.Generator()
                                     .manual_seed(4)).to(torch.bfloat16),
                 "step": torch.tensor(20, dtype=torch.int32)}
        ckx = Checkpointer(os.path.join(tmp, "c_cpu"))
        ckx.save(1, mixed, blocking=True)
        on_gpu, _ = ckx.restore(_to(mixed, "cuda"))
        c = {"restored_line": [ln for ln in log.getvalue().splitlines()
                               if ln.startswith("restored")],
             "steps": out_c["steps"], "steps_run": len(out_c["losses"]),
             "restored_lora_bitwise": _bitwise(got_lora, out_b["lora"]),
             "restored_opt_step": int(got_opt.step),
             "restored_on": got_lora["q"]["a"].device.type,
             "card_ckpt_on_cpu_bitwise": _bitwise(on_cpu[0], out_b["lora"])
             and on_cpu[0]["q"]["a"].device.type == "cpu",
             "cpu_ckpt_on_card_bitwise": _bitwise(on_gpu, mixed)
             and on_gpu["bf16"].device.type == "cuda",
             "lora_matmul_launches": c_launches,
             "codec": "zstd" if ckpt_mod.zstandard else "zlib",
             "last_loss": out_c["losses"][-1], **tt.row()}
        emit("train_cli_restart", **c)
        res["c"] = c
        if not (c["restored_line"] == ["restored step 20"]
                and c["steps"] == 30 and c["steps_run"] == 10
                and c["restored_lora_bitwise"] and c["restored_opt_step"] == 20
                and c["restored_on"] == "cuda"
                and c["card_ckpt_on_cpu_bitwise"]
                and c["cpu_ckpt_on_card_bitwise"]
                and c_launches == 10 * per_step
                and isinstance(got_opt, AdamWState)):
            raise AssertionError(f"train_cli (c): restart failed: {c}")
        del out_b, out_c, got_lora, got_opt, on_cpu, on_gpu
        torch.cuda.empty_cache()

        # (d) past the dense limit: flash_attention forward and backward
        torch.cuda.reset_peak_memory_stats()
        with LoraShapeTap() as st, TrainTap() as tt:
            _reset(lm, fwd, bwd)
            out_d = run_training(ARCH, smoke=False, steps=TRAIN_LONG_STEPS,
                                 batch=4, seq=TRAIN_LONG_SEQ, verbose=False,
                                 device="cuda")
            launches = (lm.launches, fwd.launches, bwd.launches)
        shapes.update(st.shapes)
        want = (TRAIN_LONG_STEPS * per_step, TRAIN_LONG_STEPS * n_layers,
                TRAIN_LONG_STEPS * FLASH_BWD * n_layers)
        d = {"batch": [4, TRAIN_LONG_SEQ], "steps": out_d["steps"],
             "losses": out_d["losses"], "launches": list(launches),
             "launches_derived": list(want), **tt.row(),
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        emit("train_cli_long", **d)
        res["d"] = d
        if launches != want or not np.isfinite(out_d["losses"]).all():
            raise AssertionError(f"train_cli (d): launches {launches}, "
                                 f"derived {want}, losses {out_d['losses']}")
        del out_d
        torch.cuda.empty_cache()

        # (e) the CLI in subprocesses; the synthetic data seeds from
        # Python's salted hash, so the seed is pinned
        cli_dir = os.path.join(tmp, "e")
        env = dict(os.environ, PYTHONHASHSEED="0", PYTHONPATH=SRC)
        base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                ARCH, "--full", "--batch", "4", "--seq", str(CLI_SEQ),
                "--ckpt", cli_dir]
        e = {"batch": [4, CLI_SEQ], "runs": []}
        for extra, want_lines in (
                (["--steps", str(CLI_STEPS)], [f"done: {CLI_STEPS} steps"]),
                (["--steps", "15", "--restore"],
                 [f"restored step {CLI_STEPS}", "done: 15 steps"])):
            t0 = time.perf_counter()
            p = subprocess.run(base + extra, env=env, capture_output=True,
                               text=True, timeout=600)
            lines = p.stdout.splitlines()
            ok = p.returncode == 0 and all(
                any(ln.startswith(w) for ln in lines) for w in want_lines)
            e["runs"].append({"args": extra, "rc": p.returncode,
                              "wall_s": time.perf_counter() - t0,
                              "lines": [ln for ln in lines
                                        if ln.startswith(("done",
                                                          "restored"))]})
            if not ok:
                raise AssertionError(f"train_cli (e): {extra} rc "
                                     f"{p.returncode}\n{p.stdout}\n"
                                     f"{p.stderr[-4000:]}")
        with open(os.path.join(cli_dir, "step_0000000015",
                               "manifest.json")) as f:
            e["codec"] = json.load(f)["codec"]
        e["codec_expected"] = "zstd" if ckpt_mod.zstandard else "zlib"
        emit("train_cli_subprocess", **e)
        res["e"] = e
        if e["codec"] != e["codec_expected"]:
            raise AssertionError(f"train_cli (e): codec {e['codec']}")
        # the subprocesses' launches are not counted here: their shapes
        # are derived (M = 4 x 128, qwen's q/k/v/o, forward and dX)
        m = 4 * CLI_SEQ
        for kind in ("lora_matmul", "lora_matmul_dx"):
            shapes[(kind, m, 1024, 1024, 16, 1, "bfloat16")] = 0

        # (f) llama3-8b at the CLI's defaults: batch 8, seq 64
        l_layers, l_lora, l_bwd = arch_counts(get_config, "llama3-8b")
        torch.cuda.reset_peak_memory_stats()
        with LoraShapeTap() as st, TrainTap() as tt:
            _reset(lm, fwd, bwd)
            out_f = run_training("llama3-8b", smoke=False,
                                 steps=LLAMA_TRAIN_STEPS, batch=8, seq=64,
                                 verbose=False, device="cuda")
            f_launches = lm.launches
        shapes.update(st.shapes)
        f = {"config": "llama3-8b", "batch": [8, 64], "steps": out_f["steps"],
             "losses": out_f["losses"], "lora_matmul_launches": f_launches,
             "lora_matmul_launches_derived": LLAMA_TRAIN_STEPS * (
                 l_lora + l_bwd), **tt.row(),
             "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
        emit("train_cli_llama", **f)
        res["f"] = f
        if not (np.isfinite(out_f["losses"]).all()
                and out_f["steps"] == LLAMA_TRAIN_STEPS
                and f_launches == f["lora_matmul_launches_derived"]):
            raise AssertionError(f"train_cli (f): {f}")
        del out_f
        torch.cuda.empty_cache()
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)

    # (g) the pipeline: sample_fn's batches in order, bitwise, on the card
    data = SyntheticDataset("alpaca", vocab_size=1000, seq_len=64, seed=3)
    twin = SyntheticDataset("alpaca", vocab_size=1000, seq_len=64, seed=3)
    pipe = DataPipeline(data.batch, 4)
    got = [next(pipe) for _ in range(4)]
    want_b = [twin.batch(4) for _ in range(4)]
    g_ok = all(v.device.type == "cuda" and torch.equal(
        v.cpu(), torch.as_tensor(w[k])) for gb, w in zip(got, want_b)
        for k, v in gb.items()) and all(gb.keys() == w.keys()
                                        for gb, w in zip(got, want_b))
    emit("train_cli_pipeline", batches=len(got), in_order_bitwise=g_ok)
    if not g_ok:
        raise AssertionError("train_cli (g): DataPipeline batches differ")

    unchecked = [k for k in shapes if not lora_shape_checked(*k)]
    emit("train_cli_shapes", lora_shapes=[list(k) + [v] for k, v in
                                           sorted(shapes.items())],
         unchecked=[list(k) for k in unchecked])
    if unchecked:
        raise AssertionError(f"train_cli: launched at shapes no kernel "
                             f"phase checked: {unchecked}")
    return res


def phase_experiment():
    """The paper's comparison harness (``runtime/experiment.py``): the
    five policies at ``tests/test_experiment.py``'s short configuration
    (6 replicas, 420 s simulated, seed 3), held to those tests' checks.
    Simulated: the outputs are the simulator's arithmetic on the
    replicas' interference surfaces, not card times (only
    ``control_wall_s`` is a host clock)."""
    from repro_torch.runtime.experiment import (
        POLICIES, ExperimentConfig, run_experiment)
    outs = {}
    for policy in POLICIES:
        t0 = time.perf_counter()
        out = run_experiment(ExperimentConfig(
            policy=policy, n_replicas=6, duration=420.0, scale=1.0, seed=3))
        outs[policy] = {k: v for k, v in out.items() if not k.startswith("_")}
        emit("experiment", simulated=True, wall_s=time.perf_counter() - t0,
             **outs[policy])
    bad = [p for p, o in outs.items()
           if not (o["requests"] > 0 and o["completed"] > 0
                   and o["slo_rate"] > 0.3)]
    c = outs["collm"]
    if bad or not (c["fl_rounds"] > 0 and c["mean_loss"] < 2.4
                   and all(c["mean_quality"] > outs[p]["mean_quality"]
                           for p in POLICIES if p != "collm")
                   and c["mean_util"] > outs["peft"]["mean_util"]
                   and c["overhead_frac"] < 0.05):
        raise AssertionError(f"experiment: checks failed ({bad}): {outs}")
    return outs

# ---------------------------------------------------------------- tick ----
def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) \
        or getattr(evt, "self_cuda_time_total", 0)


def _is_lora(key):
    return "lora_wg_kernel" in key or "lora_fma_kernel" in key \
        or "lora_dec_kernel" in key


def _is_seg(key):
    return "segmented_wg_kernel" in key or "segmented_fma_kernel" in key \
        or "segmented_dec_kernel" in key


def _is_flash(key):
    return "fa_fwd_" in key or "fa_bwd_" in key or "fa_dkdv_" in key \
        or "fa_dq_" in key or "fa_delta" in key


def _is_ssd(key):
    return "ssd_scan_kernel" in key


# (context, prompt length, co-training, tenants: 0 = one adapter, arch)
TICKS = [("serve", 32, False, 0, ARCH), ("long", 992, False, 0, ARCH),
         ("combined", 32, True, 0, ARCH), ("serve_2048", 2048, False, 0, ARCH),
         ("combined_2048", 2048, True, 0, ARCH),
         ("serve_4_tenants", 32, False, 4, ARCH),
         ("ssm_serve", 32, False, 0, SSM_ARCH),
         ("ssm_serve_2048", 2048, False, 0, SSM_ARCH)]


def phase_tick(make_engine, get_config, n=5):
    """Where a full-width tick's time goes (8 busy slots; paged, and
    contiguous for mamba2): serve ticks at 32-, 992- and 2,048-token
    prompts and combined ticks whose train batch is 4 x the prompt length
    (built before timing).  Host wall per tick, then under torch.profiler
    the device time its kernels take, each ported kernel's part, and
    kernels per tick.  One tick serves 4 tenants, round-robin over the 8
    slots; the last two are mamba2-780m decode ticks (no attention: the
    O(1) state recurrence and the adapter projections)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.runtime.fabric import make_tenant_adapters
    from repro_torch.runtime.serving_loop import (
        AdapterRegistry, ContinuousBatcher, GenRequest)
    rng = np.random.default_rng(0)
    arch_now = None
    for name, plen, train, n_tenants, arch in TICKS:
        if arch != arch_now:                 # one model at a time
            arch_now, cfg = arch, get_config(arch)
            engine = params = lora = None
            torch.cuda.empty_cache()
            engine = make_engine(cfg, lr=3e-3, device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(0)
            params = engine.model.init(gen)
            lora = engine.model.init_lora(gen)
        data = SyntheticDataset("alpaca", vocab_size=cfg.vocab_size,
                                seq_len=plen, seed=0)
        reg = None
        if n_tenants:
            reg = AdapterRegistry(engine.model, capacity=n_tenants)
            for t, tree in enumerate(make_tenant_adapters(
                    engine.model, n_tenants, seed=1)):
                reg.register(f"tenant{t}", tree)
        b = ContinuousBatcher(engine, params, lora, n_slots=8,
                              max_seq=plen + 16, prompt_pad=plen,
                              paged=not cfg.has_ssm,
                              opt_state=engine.optimizer.init(lora),
                              adapters=reg)
        for i in range(8):
            b.submit(GenRequest(request_id=i, max_new_tokens=16,
                                prompt=rng.integers(0, cfg.vocab_size, plen),
                                adapter_id=f"tenant{i % n_tenants}"
                                if n_tenants else None))
        # train batches on the card before any timing
        batches = iter([{k: torch.as_tensor(v, device="cuda")
                         for k, v in data.batch(4).items()}
                        for _ in range(3 + 2 * n)] if train else [])

        def tick():
            b.step(train_batch=next(batches, None))

        for _ in range(3):                   # admission wave + warm ticks
            tick()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            tick()
        host_ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                tick()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) / n * 1e3
        assert len(b.active_slots()) == 8, "a slot finished inside the window"
        assert b.stats.train_steps == (3 + 2 * n if train else 0)
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]

        def part(pred):
            return sum(_device_us(e) for e in kern if pred(e.key)) / 1e3 / n

        dev_ms = part(lambda key: True)
        attn_ms = part(lambda key: "paged_decode_kernel" in key)
        lora_ms = part(_is_lora)
        flash_ms = part(_is_flash)
        seg_ms = part(_is_seg)
        top = sorted(kern, key=_device_us, reverse=True)[:6]
        emit("tick", context=name, arch=arch, paged=not cfg.has_ssm,
             prompt_len=plen, slots=8,
             tenants=n_tenants, train_batch=[4, plen] if train else None,
             host_ms_per_tick=host_ms, profiled_wall_ms_per_tick=prof_ms,
             device_busy_ms_per_tick=dev_ms,
             device_busy_share=dev_ms / prof_ms if prof_ms else None,
             attention_ms_per_tick=attn_ms,
             attention_share_of_device=attn_ms / dev_ms if dev_ms else None,
             lora_matmul_ms_per_tick=lora_ms,
             lora_matmul_share_of_device=lora_ms / dev_ms if dev_ms else None,
             flash_attention_ms_per_tick=flash_ms,
             flash_attention_share_of_device=flash_ms / dev_ms
             if dev_ms else None,
             segmented_lora_matmul_ms_per_tick=seg_ms,
             segmented_lora_matmul_share_of_device=seg_ms / dev_ms
             if dev_ms else None,
             segmented_lora_matmul_launches_per_tick=sum(
                 e.count for e in kern if _is_seg(e.key)) / n,
             lora_matmul_launches_per_tick=sum(
                 e.count for e in kern if _is_lora(e.key)) / n,
             flash_attention_launches_per_tick=sum(
                 e.count for e in kern if _is_flash(e.key)) / n,
             ssd_scan_launches_per_tick=sum(
                 e.count for e in kern if _is_ssd(e.key)) / n,
             kernels_per_tick=sum(e.count for e in kern) / n,
             top_kernels_ms_per_tick=[[e.key[:60], _device_us(e) / 1e3 / n]
                                      for e in top])
        del b, batches, reg
        torch.cuda.empty_cache()
    del engine, params, lora
    torch.cuda.empty_cache()
    _tick_waves(make_engine, get_config, n)
    _tick_vlm(make_engine, get_config, n)


def _tick_waves(make_engine, get_config, n):
    """Where a prefill wave's time goes at full width (qwen1.5-0.5b,
    paged blocks of 16, 8 rows), the programs the batcher runs: a full
    wave of the prefix trace's first 8 prompts (``prefill_ragged``, 992
    padded), the suffix wave of the next 8 over their cached 768-token
    prefix (``prefill_ragged_suffix``, 48 blocks, suffix padded to 224),
    and a 256-token chunk wave at offset 512 over the first 8's blocks.
    Host wall per wave, then under torch.profiler device ms, lora_matmul's
    part and kernels per wave."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.paging import blocks_for
    eng, params, lora = full_engine(make_engine, get_config, ARCH)
    m = eng.model
    prompts = prefix_trace(m.cfg.vocab_size)
    bs, pad = 16, 992
    nb = blocks_for(pad, bs)
    pool = m.init_paged_caches(1 + 8 * nb, bs)
    tables = np.arange(1, 1 + 8 * nb, dtype=np.int32).reshape(8, nb)
    full = np.zeros((8, pad), np.int64)
    for j, p in enumerate(prompts[:8]):
        full[j, :len(p)] = p
    lens = torch.tensor([len(p) for p in prompts[:8]], device="cuda")
    toks = torch.tensor(full, device="cuda")
    with torch.no_grad():
        _, pre = m.prefill_ragged(params, lora, {"tokens": toks}, lens)
    m.write_prefill_blocks(pool, pre, tables)
    del pre
    # rows j of the next 8 prompts share family j % 2 with row j's prefix
    tails = [p[PREFIX_HEAD:] for p in prompts[8:]]
    suf = np.zeros((8, 224), np.int64)
    for j, t in enumerate(tails):
        suf[j, :len(t)] = t
    chunk = full[:, 512:768]
    waves = {
        "full_8x992": lambda: m.prefill_ragged(
            params, lora, {"tokens": toks}, lens),
        "suffix_8x224_over_768": lambda: m.prefill_ragged_suffix(
            params, lora, {"tokens": torch.tensor(suf, device="cuda")},
            np.array([len(t) for t in tails]), np.full(8, PREFIX_HEAD),
            pool, tables),
        "chunk_8x256_at_512": lambda: m.prefill_ragged_suffix(
            params, lora, {"tokens": torch.tensor(chunk, device="cuda")},
            np.full(8, 256), np.full(8, 512), pool, tables[:, :32]),
    }
    for name, fn in waves.items():
        with torch.no_grad():
            fn()                                   # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) / n * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                prof_ms = (time.perf_counter() - t0) / n * 1e3
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(_device_us(e) for e in kern) / 1e3 / n
        lora_ms = sum(_device_us(e) for e in kern if _is_lora(e.key)) \
            / 1e3 / n
        top = sorted(kern, key=_device_us, reverse=True)[:6]
        emit("tick", context=name, arch=ARCH, paged=True, block_size=bs,
             host_ms_per_wave=host_ms, profiled_wall_ms_per_wave=prof_ms,
             device_busy_ms_per_wave=dev_ms,
             device_busy_share=dev_ms / prof_ms if prof_ms else None,
             lora_matmul_ms_per_wave=lora_ms,
             lora_matmul_share_of_device=lora_ms / dev_ms if dev_ms else None,
             kernels_per_wave=sum(e.count for e in kern) / n,
             top_kernels_ms_per_wave=[[e.key[:60], _device_us(e) / 1e3 / n]
                                      for e in top])
    del eng, params, lora, pool
    torch.cuda.empty_cache()


def _is_decode(key):
    return "decode_attn_split_kernel" in key \
        or "decode_attn_combine_kernel" in key or "decode_attn_bf16" in key


def _tick_vlm(make_engine, get_config, n):
    """A VLM decode tick at 8 busy slots (``Engine.decode_step`` after a
    32-token prefill wave): host wall per tick, then under torch.profiler
    device time, decode_attention's and the other kernels' parts, and
    kernels per tick."""
    from torch.profiler import ProfilerActivity, profile
    slots, plen = 8, 32
    engine, params, lora, gen = _vlm_full(make_engine, get_config)
    model, cfg = engine.model, engine.model.cfg
    toks = torch.randint(0, cfg.vocab_size, (slots, plen), device="cuda",
                         generator=gen)
    vis = torch.randn((slots, cfg.vision_tokens, cfg.d_model), generator=gen,
                      device="cuda", dtype=torch.bfloat16)
    logits, pre = engine.prefill_step(params, lora, {"tokens": toks,
                                                     "vision": vis})
    caches = _vlm_decode_caches(model, pre, slots, plen + 3 + 2 * n)
    del pre
    state = {"tok": logits[:, -1].argmax(-1), "pos": plen}

    def tick():
        pos = torch.full((slots,), state["pos"], dtype=torch.int32,
                         device="cuda")
        lg, _ = engine.decode_step(params, lora, caches,
                                   state["tok"][:, None], pos)
        state["tok"] = lg[:, -1].argmax(-1)
        state["pos"] += 1

    for _ in range(3):                       # warm ticks
        tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        tick()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tick()
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / n * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]

    def part(pred):
        return sum(_device_us(e) for e in kern if pred(e.key)) / 1e3 / n

    dev_ms = part(lambda key: True)
    dec_ms = part(_is_decode)
    top = sorted(kern, key=_device_us, reverse=True)[:6]
    emit("tick", context="vlm_decode", arch=VLM_ARCH, n_layers=cfg.n_layers,
         paged=False, prompt_len=plen, slots=slots, tenants=0,
         train_batch=None, host_ms_per_tick=host_ms,
         profiled_wall_ms_per_tick=prof_ms, device_busy_ms_per_tick=dev_ms,
         device_busy_share=dev_ms / prof_ms if prof_ms else None,
         decode_attention_ms_per_tick=dec_ms,
         decode_attention_share_of_device=dec_ms / dev_ms if dev_ms else None,
         decode_attention_launches_per_tick=sum(
             e.count for e in kern if _is_decode(e.key)) / n,
         attention_ms_per_tick=part(lambda key: "paged_decode_kernel" in key),
         lora_matmul_ms_per_tick=part(_is_lora),
         kernels_per_tick=sum(e.count for e in kern) / n,
         top_kernels_ms_per_tick=[[e.key[:60], _device_us(e) / 1e3 / n]
                                  for e in top])
    del engine, params, lora, caches, logits, vis, state
    torch.cuda.empty_cache()


# ------------------------------------------------- live fabric (ROADMAP 2) -
FABRIC_REQUESTS, FABRIC_PROMPT, FABRIC_GEN = 16, 32, 16
FABRIC_SLOTS = 4            # per replica: 2 replicas x 4 = one batcher's 8
FAIL_TICK = 6               # (l-b): r1 fails over at this fabric tick


class _EngineTap:
    """Stands in for one replica's batcher engine: forwards everything,
    and counts the train microbatches of every train step it is asked for
    (``grad_accum`` of each, since each microbatch runs the adapter
    projections forward and their dX), the fused steps, and whether every
    fused step inside a round had its decode read the replica's published
    tree (``serve_lora``; the optimizer steps the shadow)."""

    def __init__(self, eng, rep):
        self._eng, self._rep = eng, rep
        self.micro = 0
        self.fused = 0
        self.fused_in_round = 0
        self.decode_read_published = True

    def __getattr__(self, k):
        return getattr(self._eng, k)

    def _train(self, kw):
        self.micro += kw.get("grad_accum", 1)

    def train_step(self, *a, **kw):
        self._train(kw)
        return self._eng.train_step(*a, **kw)

    def _fused(self, lora, kw):
        self._train(kw)
        self.fused += 1
        b = self._rep.batcher
        if self._rep._session is not None:
            self.fused_in_round += 1
            want = b.adapters.device_lora() if b.adapters is not None \
                else b.lora
            if kw.get("serve_lora") is not want:
                self.decode_read_published = False

    def combined_step(self, params, lora, *a, **kw):
        self._fused(lora, kw)
        return self._eng.combined_step(params, lora, *a, **kw)

    def combined_step_paged(self, params, lora, *a, **kw):
        self._fused(lora, kw)
        return self._eng.combined_step_paged(params, lora, *a, **kw)


def _tree_equal(a, b):
    from repro_torch.tree import tree_leaves
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _dtype_name(t):
    return str(t.dtype).split(".")[-1]


def lora_shape_checked(kind, m, k, n, r, na, dtype):
    """Whether phase_kernel_lora or phase_kernel_seg held the kernel
    against its plain version at a launch's shape: a LORA_SHAPES row of
    that M, K, N, r and dtype (a dX launch, ``lora_matmul`` on the
    transposed operands, needs a row whose backward is checked, with K
    and N swapped), or a SEG_SHAPES row of that M, K, N, r and slot
    count (checked in both dtypes)."""
    if kind == "segmented_lora_matmul":
        return any(row[1:6] == (m, k, n, r, na) for row in SEG_SHAPES)
    for name, m2, k2, n2, r2 in LORA_SHAPES:
        if (m2, r2) != (m, r) or dtype not in [
                str(d).split(".")[-1] for d in lora_dtypes(name)]:
            continue
        if kind == "lora_matmul" and (k2, n2) == (k, n):
            return True
        if kind == "lora_matmul_dx" and (n2, k2) == (k, n) \
                and lora_has_backward(name):
            return True
    return False


class LoraShapeTap:
    """Records the shape of every ``lora_matmul`` / ``segmented_lora_
    matmul`` launch while it is entered (forward, and the dX of
    ``LoRAMatmulFn``'s backward) as (kind, M, K, N, r, slots, dtype):
    launch count, the keys ``lora_shape_checked`` reads."""

    def __enter__(self):
        import repro_torch.kernels.lora_matmul as lm_mod
        self._lm_mod = lm_mod
        self._lm_orig = (lm_mod._launch, lm_mod._check_seg,
                         lm_mod.LoRAMatmulFn.backward)
        launch, check_seg, backward = self._lm_orig
        self.shapes = {}
        in_bwd = [False]

        def note(key):
            self.shapes[key] = self.shapes.get(key, 0) + 1

        def rec_launch(x, w, a, b, scaling):
            note(("lora_matmul_dx" if in_bwd[0] else "lora_matmul",
                  x.shape[0], x.shape[1], w.shape[1], a.shape[1], 1,
                  _dtype_name(x)))
            return launch(x, w, a, b, scaling)

        def rec_check_seg(x, w, a, b, idx):
            note(("segmented_lora_matmul", x.shape[0], x.shape[1],
                  w.shape[1], a.shape[2], a.shape[0], _dtype_name(x)))
            return check_seg(x, w, a, b, idx)

        def rec_backward(ctx, dy):
            in_bwd[0] = True
            try:
                return backward(ctx, dy)
            finally:
                in_bwd[0] = False

        lm_mod._launch, lm_mod._check_seg = rec_launch, rec_check_seg
        lm_mod.LoRAMatmulFn.backward = staticmethod(rec_backward)
        return self

    def __exit__(self, *exc):
        lm = self._lm_mod
        lm._launch, lm._check_seg = self._lm_orig[:2]
        lm.LoRAMatmulFn.backward = staticmethod(self._lm_orig[2])
        return False

    def unchecked(self):
        """The recorded shapes no kernel phase held against the plain
        version."""
        return [k for k in self.shapes if not lora_shape_checked(*k)]


class FabricTap:
    """Taps the fabric a ``launch/serve.py`` entry point builds (patches
    ``runtime.fabric.build_fabric`` for the call; the port's own
    ``warm_up`` has run inside it, and its seconds are kept): records the
    shape of every ``lora_matmul`` / ``segmented_lora_matmul`` launch
    (forward, and the dX of ``LoRAMatmulFn``'s backward), sets the
    kernels' counts to 0 and the peak memory mark as
    ``ServingFabric.run`` starts and reads them as it returns; times every
    ``ServingFabric.tick`` and its ``ClusterController.tick``; counts the
    replicas' eval probes, train microbatches and fused steps; keeps the
    requests; with ``fail_at`` fails r1 over at that tick; checks at
    every round boundary that the published tree the round's decodes
    read is bitwise the one the round began with, and at every refused
    (non-finite) publish that the served tree is bitwise unchanged."""

    def __init__(self, counters, *, fail_at=None):
        self.counters, self.fail_at = counters, fail_at
        self.tick_s, self.ctl_s = [], []
        self.round_checks, self.blocked_checks = [], []
        self.probes = {}

    def __enter__(self):
        import repro_torch.runtime.fabric as fabric_mod
        # the last phase's fabric sits in reference cycles (its taps)
        gc.collect()
        torch.cuda.empty_cache()
        self._mod, self._orig = fabric_mod, fabric_mod.build_fabric
        self._shape_tap = LoraShapeTap().__enter__()
        self.shapes = self._shape_tap.shapes

        def build(*a, **kw):
            fab, cfg = self._orig(*a, **kw)
            self.attach(fab)
            return fab, cfg

        fabric_mod.build_fabric = build
        return self

    def __exit__(self, *exc):
        self._mod.build_fabric = self._orig
        self._shape_tap.__exit__(*exc)
        return False

    def attach(self, fab):
        self.fab, self.reps = fab, dict(fab.replicas)
        self.params_shared = all(r.params is fab.replicas["r0"].params
                                 and r.batcher.params is r.params
                                 for r in self.reps.values())
        self.taps = {}
        for rid, rep in self.reps.items():
            self.taps[rid] = rep.batcher.engine = _EngineTap(
                rep.batcher.engine, rep)
            self._wrap_replica(rid, rep)
        orig_run, orig_tick = fab.run, fab.tick
        orig_ctl = fab.cluster.tick
        n = [0]

        def ctl(now):
            t = time.perf_counter()
            orig_ctl(now)
            self.ctl_s.append(time.perf_counter() - t)

        def tick(now):
            if self.fail_at is not None and n[0] == self.fail_at \
                    and "r1" in fab.replicas:
                fab.fail_replica("r1", now)
            n[0] += 1
            t = time.perf_counter()
            busy = orig_tick(now)
            self.tick_s.append(time.perf_counter() - t)
            return busy

        def run(requests, **kw):
            self.requests = list(requests)
            torch.cuda.synchronize()
            self.start_bytes = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _reset(*self.counters)                      # main path starts
            t = time.perf_counter()
            out = orig_run(requests, **kw)
            torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - t
            self.launches = {c.__name__: c.launches
                             for c in self.counters}    # path ends
            self.peak_bytes = torch.cuda.max_memory_allocated()
            return out

        fab.cluster.tick, fab.tick, fab.run = ctl, tick, run

    def _wrap_replica(self, rid, rep):
        from repro_torch.tree import tree_finite, tree_map
        self.probes[rid] = 0
        orig_probe, orig_begin = rep._probe_loss, rep.begin_round
        orig_finish, orig_publish = rep.finish_round, rep.publish_adapter
        snap = {}

        def probe():
            self.probes[rid] += 1
            return orig_probe()

        def begin(*a, **kw):
            snap["round"] = tree_map(torch.clone, rep.lora)
            return orig_begin(*a, **kw)

        def finish(now):
            if "round" in snap:
                self.round_checks.append(
                    _tree_equal(rep.lora, snap.pop("round")))
            shadow = rep.batcher.train_lora
            if shadow is not None and not tree_finite(shadow):
                snap["blocked"] = tree_map(torch.clone, rep.lora)
            return orig_finish(now)

        def publish():
            v = orig_publish()
            if "blocked" in snap:
                self.blocked_checks.append(
                    _tree_equal(rep.lora, snap.pop("blocked")))
            return v

        rep._probe_loss, rep.begin_round = probe, begin
        rep.finish_round, rep.publish_adapter = finish, publish

    def row(self, out):
        """The run's numbers: fabric and per-replica tok/s and busy share,
        TTFT / TPOT, the control tick's host ms, the fault counters and
        whatever the health monitor recorded."""
        c, ft = out["cluster"], out["fault_tolerance"]
        tick_ms = np.asarray(self.tick_s) * 1e3
        ctl_ms = np.asarray(self.ctl_s) * 1e3
        pct = {}
        for key in ("ttft", "tpot"):
            for p in ("p50", "p99"):
                v = c[key][p]
                pct[f"{key}_{p}_ms"] = None if v is None else v * 1e3
        return {
            "replicas": len(self.reps), "requests": len(self.requests),
            "completed": out["completed"],
            "finished": c["finished"],
            "generated_tokens": c["generated_tokens"],
            "run_wall_s": self.wall_s,
            "fabric_tok_s": c["generated_tokens"] / self.wall_s,
            "per_replica": {rid: {
                "finished": row["finished"],
                "generated_tokens": row["generated_tokens"],
                "tok_s": row["throughput_tok_s"],
                "busy_share": row["wall_time"] / self.wall_s,
                "adapter_version": row["adapter_version"],
                "train_loss": row["train_loss"]}
                for rid, row in out["replicas"].items()},
            **pct,
            "ticks": len(self.tick_s),
            "tick_host_ms_p50": float(np.percentile(tick_ms, 50)),
            "tick_host_ms_p99": float(np.percentile(tick_ms, 99)),
            "tick_host_ms_mean": float(tick_ms.mean()),
            "cluster_tick_ms_mean": float(ctl_ms.mean()),
            "cluster_tick_share": float(ctl_ms.sum() / tick_ms.sum()),
            "launches": self.launches,
            "probes": dict(self.probes),
            "train_microbatches": {r: t.micro
                                   for r, t in self.taps.items()},
            "fused_steps": {r: t.fused for r, t in self.taps.items()},
            "fl_rounds": out["fl_rounds"],
            "failovers": ft["failovers"], "quarantines": ft["quarantines"],
            "nan_publishes_blocked": ft["nan_publishes_blocked"],
            "retried_requests": ft["retried_requests"],
            "injected": ft["injected"],
            "health_failures": [list(f) for f in
                                self.fab.health.failures],
            "fault_log": [list(f) for f in ft["log"]],
            "params_shared": self.params_shared,
            "warm_up_s": self.fab.warm_s,
            "lora_shapes": [list(k) + [v] for k, v in
                            sorted(self.shapes.items())],
            "start_bytes": self.start_bytes,
            "peak_bytes": self.peak_bytes,
        }

    def check(self, name, out, row, n_layers, n_lora, n_lora_bwd, *,
              faults=0, seg_serves=False):
        """Every request completes with its whole budget, every pool ends
        all-free, the counters fold, failovers and quarantines equal the
        injected faults, the weights are one copy, and the launches are
        exactly as derived from the replicas' own counts."""
        pda, lm, seg = self.counters[:3]
        if row["failovers"] + row["quarantines"] != faults:
            raise AssertionError(
                f"{name}: {row['failovers']} failovers and "
                f"{row['quarantines']} quarantines for {faults} injected "
                f"faults; health: {row['health_failures']}")
        if out["incomplete_requests"] or out.get("failed_requests") \
                or any(r.completed_at is None
                       or len(r.output_tokens) != r.tokens
                       for r in self.requests):
            raise AssertionError(f"{name}: not every request completed")
        if row["finished"] != len(self.requests):
            raise AssertionError(f"{name}: {row['finished']} finished in "
                                 f"the rollup for {len(self.requests)}")
        for rid, rep in self.reps.items():
            a = rep.batcher.allocator
            if a.n_used or a.reserved:
                raise AssertionError(f"{name}: {rid}'s pool did not drain")
        if not row["params_shared"]:
            raise AssertionError(f"{name}: replicas hold their own params")
        waves = sum(r.batcher.prefill_waves for r in self.reps.values())
        steps = sum(r.batcher.stats.decode_steps
                    for r in self.reps.values())
        probes = sum(self.probes.values())
        micro = sum(t.micro for t in self.taps.values())
        serve = n_lora * (waves + steps)
        want = {pda.__name__: n_layers * steps,
                seg.__name__: serve if seg_serves else 0,
                lm.__name__: (0 if seg_serves else serve) + n_lora * probes
                + (n_lora + n_lora_bwd) * micro}
        for c in self.counters[3:]:
            want[c.__name__] = 0
        row["launches_derived"] = want
        if row["launches"] != want:
            raise AssertionError(f"{name}: launches {row['launches']}, "
                                 f"derived {want}")
        unchecked = self._shape_tap.unchecked()
        if unchecked:
            raise AssertionError(f"{name}: launched at shapes no kernel "
                                 f"phase checks: {unchecked}")


def _fabric_kernels():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.decode_attention import \
        paged_decode_attention as pda
    from repro_torch.kernels.lora_matmul import (
        lora_matmul as lm, segmented_lora_matmul as seg)
    return (pda, lm, seg, fa.flash_attention_fwd,
            fa.flash_attention_backward)


def _param_bytes(tree):
    from repro_torch.tree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def phase_fabric(get_config, serve=None):
    """(l-a) ``run_multi_replica_serving`` at full width: 2 replicas of 4
    paged slots (blocks of 16) share one device copy of the weights, 16
    requests of 32 + 16, beside one batcher of 8 slots on the same
    traffic (the serve phase's ``paged`` run, or run here); (l-b) the
    same with r1 failed over at fabric tick ``FAIL_TICK``."""
    from repro_torch.launch.serve import (
        run_multi_replica_serving, run_serving)
    counters = _fabric_kernels()
    n_layers, n_lora, n_lora_bwd = arch_counts(get_config, ARCH)
    if serve is None:
        out = run_serving(ARCH, smoke=False, n_requests=FABRIC_REQUESTS,
                          batch_size=2 * FABRIC_SLOTS, seed=0, paged=True,
                          prompt_len=FABRIC_PROMPT, gen_tokens=FABRIC_GEN,
                          device="cuda", verbose=False)
        one = {"throughput_tok_s": out["throughput_tok_s"],
               **latency_percentiles(out)}
    else:
        one = {k: serve["paged"][0][k] for k in (
            "throughput_tok_s", "ttft_p50_ms", "ttft_p99_ms",
            "tpot_p50_ms", "tpot_p99_ms")}
    results = {"one_batcher": one}
    for name, fail_at in (("fabric", None), ("failover", FAIL_TICK)):
        with FabricTap(counters, fail_at=fail_at) as tap:
            out = run_multi_replica_serving(
                ARCH, n_replicas=2, smoke=False,
                n_requests=FABRIC_REQUESTS, prompt_len=FABRIC_PROMPT,
                gen_tokens=FABRIC_GEN, batch_size=FABRIC_SLOTS, seed=0,
                paged=True, device="cuda", verbose=False)
        row = tap.row(out)
        pool = tap.reps["r0"].batcher.cache_bytes()
        row.update(run=name, one_batcher=one,
                   param_bytes=_param_bytes(tap.reps["r0"].params),
                   pool_bytes_per_replica=pool)
        tap.check(name, out, row, n_layers, n_lora, n_lora_bwd,
                  faults=int(fail_at is not None))
        emit("fabric", **row)
        if fail_at is not None and not row["retried_requests"]:
            raise AssertionError("failover: r1 held no request at tick "
                                 f"{fail_at}")
        # one copy of the weights plus the pools: a second copy would add
        # param_bytes; the activations of a 4 x 32 wave are far below it
        if row["peak_bytes"] > row["param_bytes"] * 1.5 \
                + len(tap.reps) * pool:
            raise AssertionError(f"{name}: peak {row['peak_bytes']} bytes")
        results[name] = row
        del tap, out
        torch.cuda.empty_cache()
    return results


def phase_fabric_combined(get_config):
    """(l-c) ``run_combined_fabric_serving``: 2 replicas, 2 FL rounds of 4
    fused steps on a fixed pool of 4 train batches (4 x 32), FedAvg and
    publish at the round boundaries, over the same 16 x (32 + 16)
    traffic."""
    from repro_torch.launch.serve import run_combined_fabric_serving
    counters = _fabric_kernels()
    n_layers, n_lora, n_lora_bwd = arch_counts(get_config, ARCH)
    with FabricTap(counters) as tap:
        out = run_combined_fabric_serving(
            ARCH, n_replicas=2, smoke=False, n_requests=FABRIC_REQUESTS,
            prompt_len=FABRIC_PROMPT, gen_tokens=FABRIC_GEN,
            batch_size=FABRIC_SLOTS, seed=0, paged=True, train_batch=4,
            rounds=2, steps_per_round=4, train_pool=4, device="cuda",
            verbose=False)
    row = tap.row(out)
    losses = [r["avg_loss"] for r in out["rounds"]]
    row.update(run="combined", round_avg_loss=losses,
               rounds=[dict(r) for r in out["rounds"]],
               fused_steps_in_round={r: t.fused_in_round
                                     for r, t in tap.taps.items()},
               decode_read_published=all(
                   t.decode_read_published for t in tap.taps.values()),
               round_checks=tap.round_checks)
    tap.check("combined", out, row, n_layers, n_lora, n_lora_bwd)
    emit("fabric_combined", **row)
    versions = [r["adapter_version"] for r in row["per_replica"].values()]
    if out["fl_rounds"] < 2 or min(versions) < 2:
        raise AssertionError(f"combined: {out['fl_rounds']} rounds, "
                             f"versions {versions}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"combined: round losses {losses}")
    if sum(row["fused_steps_in_round"].values()) == 0 \
            or not row["decode_read_published"] \
            or not tap.round_checks or not all(tap.round_checks):
        raise AssertionError("combined: a decode inside a round did not "
                             "read the published tree")
    return row


def phase_fabric_chaos(get_config):
    """(l-d) ``run_combined_fabric_serving`` under ``--chaos``: one crash
    and one NaN round (no stall) from the seeded schedule over 3
    replicas (so that the round survives the crash: a session needs 2
    members), horizon 0.5 s."""
    from repro_torch.launch.serve import run_combined_fabric_serving
    counters = _fabric_kernels()
    n_layers, n_lora, n_lora_bwd = arch_counts(get_config, ARCH)
    chaos = {"seed": 0, "horizon": 0.5, "crashes": 1, "stalls": 0,
             "ooms": 0, "nan_rounds": 1}
    with FabricTap(counters) as tap:
        out = run_combined_fabric_serving(
            ARCH, n_replicas=3, smoke=False, n_requests=FABRIC_REQUESTS,
            prompt_len=FABRIC_PROMPT, gen_tokens=FABRIC_GEN,
            batch_size=FABRIC_SLOTS, seed=0, paged=True, train_batch=4,
            rounds=2, steps_per_round=4, train_pool=4, chaos=chaos,
            device="cuda", verbose=False)
    row = tap.row(out)
    crashes = len({rid for _, rid, k in row["injected"] if k == "crash"})
    row.update(run="chaos", chaos=chaos, crashed=crashes,
               blocked_checks=tap.blocked_checks)
    tap.check("chaos", out, row, n_layers, n_lora, n_lora_bwd,
              faults=crashes)
    emit("fabric_chaos", **row)
    if crashes != 1 or row["nan_publishes_blocked"] < 1 \
            or not tap.blocked_checks or not all(tap.blocked_checks):
        raise AssertionError(
            f"chaos: {crashes} crashes, {row['nan_publishes_blocked']} "
            f"publishes blocked, served tree unchanged "
            f"{tap.blocked_checks}")
    return row


def phase_fabric_adapters(get_config):
    """(l-e) ``run_multi_replica_serving(n_adapters=4)``: 4 tenants tagged
    round-robin over 2 replicas, each with every tenant registered."""
    from repro_torch.launch.serve import run_multi_replica_serving
    counters = _fabric_kernels()
    n_layers, n_lora, n_lora_bwd = arch_counts(get_config, ARCH)
    with FabricTap(counters) as tap:
        out = run_multi_replica_serving(
            ARCH, n_replicas=2, smoke=False, n_requests=FABRIC_REQUESTS,
            prompt_len=FABRIC_PROMPT, gen_tokens=FABRIC_GEN,
            batch_size=FABRIC_SLOTS, seed=0, paged=True, n_adapters=4,
            device="cuda", verbose=False)
    row = tap.row(out)
    rollup = {a: v["requests"] for a, v in out["cluster"]["adapters"].items()}
    row.update(run="adapters", tenants=4, adapter_requests=rollup,
               adapter_routed=sum(d["adapter_routed"]
                                  for d in out["dispatchers"].values()))
    tap.check("adapters", out, row, n_layers, n_lora, n_lora_bwd,
              seg_serves=True)
    emit("fabric_adapters", **row)
    if sum(rollup.values()) != row["finished"] \
            or row["launches"]["segmented_lora_matmul"] == 0:
        raise AssertionError(f"adapters: rollup {rollup}, launches "
                             f"{row['launches']}")
    for rid, rep in tap.reps.items():
        if any(rep.adapters.refcount(a) for a in rep.adapters.registered()):
            raise AssertionError(f"adapters: {rid} holds adapter refs")
    return row


def phase_fabric_reference(make_engine, get_config):
    """(l-a) and (l-b) with token identity, reduced float32 config: the
    port's fabric on the card (2 replicas of 2 paged slots, blocks of 4)
    emits the greedy tokens of one batcher on the card over the same
    weights, and of the same fabric on the CPU (the weights copied
    across); with r1 failed over at tick 3 too."""
    from repro_torch.core.interfaces import Request
    from repro_torch.data.synthetic import SyntheticDataset
    from repro_torch.runtime.fabric import build_fabric, fabric_from_weights
    from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
    from repro_torch.tree import tree_map

    lens, gens = [6, 9, 4, 8, 7, 5, 10, 6], [5, 4, 6, 3, 5, 4, 6, 5]
    data = SyntheticDataset("alpaca", vocab_size=get_config(ARCH).scaled()
                            .vocab_size, seq_len=10, seed=3)
    toks = data.sample_tokens(len(lens))
    prompts = [toks[i, :n].astype(np.int32) for i, n in enumerate(lens)]
    kw = dict(n_slots=2, prompt_len=10, gen_tokens=6, paged=True,
              block_size=4)

    def drive(fab, fail_at=None):
        stream = next(iter(fab.replicas.values())).model_id
        reqs = [Request(request_id=i, stream_id=stream, arrival=0.0,
                        deadline=1e9, tokens=gens[i], prompt=prompts[i])
                for i in range(len(lens))]
        for r in reqs:
            fab.submit(r)
        t0 = time.perf_counter()
        for it in range(5000):
            now = time.perf_counter() - t0
            if it == fail_at:
                fab.fail_replica("r1", now)
            busy = fab.tick(now)
            if not busy and all(r.completed_at is not None for r in reqs):
                break
            if not busy:
                time.sleep(0.002)
        if any(r.completed_at is None or len(r.output_tokens) != r.tokens
               for r in reqs):
            raise AssertionError("fabric_reference: not every request "
                                 "completed")
        return [r.output_tokens for r in reqs]

    fab, _ = build_fabric(ARCH, 2, smoke=True, device="cuda", **kw)
    rep = fab.replicas["r0"]
    eng, params = rep.engine, rep.params
    lora = tree_map(torch.clone, rep.lora)
    card = drive(fab)
    fab_f, _ = build_fabric(ARCH, 2, smoke=True, device="cuda", **kw)
    failed = drive(fab_f, fail_at=3)
    single = [GenRequest(request_id=i, prompt=p.copy(),
                         max_new_tokens=gens[i])
              for i, p in enumerate(prompts)]
    ContinuousBatcher(eng, params, lora, n_slots=4, max_seq=16,
                      prompt_pad=10, paged=True, block_size=4).run(single)
    ceng = make_engine(get_config(ARCH).scaled(), lr=3e-3, device="cpu")
    cpu = tree_map(lambda t: t.cpu(), {"p": params, "l": lora})
    fab_c = fabric_from_weights(ceng, cpu["p"], cpu["l"], 2, **kw)
    on_cpu = drive(fab_c)
    row = {"requests": len(lens), "card_equals_one_batcher":
           card == [r.tokens for r in single],
           "card_equals_cpu": card == on_cpu,
           "failover_equals_never_failed": failed == card,
           "failovers": fab_f.failovers,
           "failover_finished_on_r1": fab_f.retired_stats["r1"].finished,
           "failover_requeued": fab_f.retry_policy.retried,
           "health_failures": [list(f) for f in fab.health.failures]}
    emit("fabric_reference", **row)
    if not (row["card_equals_one_batcher"] and row["card_equals_cpu"]
            and row["failover_equals_never_failed"]) \
            or row["failovers"] != 1 or not row["failover_requeued"] \
            or fab.failovers \
            or fab.quarantines or fab_f.quarantines:
        raise AssertionError(f"fabric_reference: {row}")
    return row


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    if sys.argv[1:2] == ["--time-kernels"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        return time_kernels()
    if sys.argv[1:2] == ["--ab"]:
        print(smi(), flush=True)
        return run_ab(sys.argv[2])
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.decode_attention import (
        decode_attention as dattn, decode_attention_ref as dattn_ref,
        paged_decode_attention as pda, paged_decode_attention_ref as pda_ref)
    from repro_torch.kernels.lora_matmul import (
        LoRAMatmulFn, lora_matmul as lm, lora_matmul_ref as lm_ref,
        segmented_lora_matmul as seg, segmented_lora_matmul_ref as seg_ref)
    from repro_torch.launch.serve import run_serving
    from repro_torch.models.model import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(card, flush=True)
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)),
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    # one nvcc per source, all started together: library() builds on
    # first use and waits on nvcc outside the GIL
    t0 = time.perf_counter()
    built = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(built)) as pool:
        list(pool.map(_build.library, built))
    emit("build", seconds=time.perf_counter() - t0, built=built)

    phases = {
        "kernel": lambda: phase_kernel(pda, pda_ref),
        "kernel_lora": lambda: phase_kernel_lora(lm, lm_ref, LoRAMatmulFn),
        "kernel_flash": lambda: phase_kernel_flash(fa),
        "kernel_seg": lambda: phase_kernel_seg(seg, seg_ref, lm),
        "kernel_ssd": lambda: phase_kernel_ssd(ssd),
        "kernel_decode": lambda: phase_kernel_decode(dattn, dattn_ref),
        "reference": lambda: phase_reference(get_config, build, make_engine,
                                             lm, ssd.ssd_scan, dattn),
        "reference_blockwise": lambda: phase_reference_blockwise(
            get_config, build, make_engine, fa),
        "serve": lambda: phase_serve(run_serving, get_config, pda, lm, fa,
                                     seg),
        "serve_prefix": lambda: phase_serve_prefix(make_engine, get_config,
                                                   pda, lm, fa, seg),
        "serve_chunked": lambda: phase_serve_chunked(make_engine, get_config,
                                                     pda, lm, fa, seg),
        "serve_oversub": lambda: phase_serve_oversub(
            make_engine, get_config, pda, pda_ref, lm, fa, seg),
        "static": lambda: phase_static(make_engine, get_config, pda, lm, fa,
                                       seg),
        "serve_ssm": lambda: phase_serve_ssm(run_serving, get_config, pda,
                                             lm, fa, seg, ssd.ssd_scan),
        "serve_vlm": lambda: phase_serve_vlm(make_engine, get_config, pda, lm,
                                             fa, seg, ssd.ssd_scan, dattn),
        "combined": lambda: phase_combined(run_serving, get_config, pda, lm,
                                           fa, seg),
        "budget": lambda: phase_budget(run_serving, make_engine, get_config,
                                       pda, lm, fa, seg, out.get("combined")),
        "serve_adapters": lambda: phase_serve_adapters(
            run_serving, get_config, pda, lm, fa, seg, out.get("serve")),
        "mixed_solo": lambda: phase_mixed_solo(get_config, make_engine, seg,
                                               lm),
        "fabric_reference": lambda: phase_fabric_reference(make_engine,
                                                           get_config),
        "fabric": lambda: phase_fabric(get_config, out.get("serve")),
        "fabric_combined": lambda: phase_fabric_combined(get_config),
        "fabric_chaos": lambda: phase_fabric_chaos(get_config),
        "fabric_adapters": lambda: phase_fabric_adapters(get_config),
        "train": lambda: phase_train(make_engine, get_config, lm),
        "train_cli": lambda: phase_train_cli(make_engine, get_config, lm, fa),
        "experiment": phase_experiment,
        "tick": lambda: phase_tick(make_engine, get_config),
    }
    # bring-up only: named on the command line, never in the full run
    bring_up = {"splits": phase_splits,
                "budget_seeded": lambda: phase_budget(
                    run_serving, make_engine, get_config, pda, lm, fa, seg,
                    seeded=True)}
    only = sys.argv[1:]
    out = {}      # each phase's results, as later phases read them
    if only:
        # bring-up: the named phases alone, and no result lines
        for name in only:
            out[name] = {**phases, **bring_up}[name]()
        return
    seconds = {}
    for name, fn in phases.items():
        t1 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t1
    emit("seconds", phases=seconds, total=time.perf_counter() - t0)
    rows, lrows, frows = out["kernel"], out["kernel_lora"], \
        out["kernel_flash"]
    serve, combined = out["serve"], out["combined"]
    srows, adapters = out["kernel_seg"], out["serve_adapters"]
    s_main = srows[("decode", torch.bfloat16)]
    drows, ssm = out["kernel_ssd"], out["serve_ssm"]
    d_main = drows[("mamba_2048", torch.bfloat16)]
    crows, vlm = out["kernel_decode"], out["serve_vlm"]
    c_main = crows[("cross", torch.bfloat16)]

    fab = {"l-a": out["fabric"]["fabric"], "l-b": out["fabric"]["failover"],
           "l-c": out["fabric_combined"], "l-d": out["fabric_chaos"],
           "l-e": out["fabric_adapters"]}

    tc = out["train_cli"]
    # the training CLI's in-process runs of the train_cli phase: (b) and
    # (c) qwen 4 x 256, (d) qwen 4 x 2,048, (f) llama3-8b 8 x 64
    train_launches = {
        "lora_matmul": {"b": tc["b"]["lora_matmul_launches"],
                        "c": tc["c"]["lora_matmul_launches"],
                        "d": tc["d"]["launches"][0],
                        "f": tc["f"]["lora_matmul_launches"]},
        "flash_attention": {"d": tc["d"]["launches"][1]},
        "flash_attention_backward": {"d": tc["d"]["launches"][2]}}

    def fabric_launches(kernel):
        """A kernel's launches in each fabric run (traffic (l))."""
        return {k: r["launches"][kernel] for k, r in fab.items()}

    main_row = rows[("serve", torch.bfloat16)]
    worst = max(r["max_abs_err"] for (n, dt), r in rows.items()
                if dt == torch.bfloat16)
    # flash_attention's main shapes: the qwen prefill wave (forward) and
    # the co-training train batch (backward); its launches: the
    # co-training server at 2,048-token prompts
    f_fwd = frows[("qwen_prefill", torch.bfloat16)]
    f_bwd = frows[("qwen_train", torch.bfloat16)]
    flash_shapes = {n: {k: r[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bwd_ms",
        "bwd_plain_ms", "bwd_library_ms", "bwd_bound_ms", "bwd_bound_by")}
        for (n, dt), r in frows.items() if dt == torch.bfloat16}
    seg_shapes = {n: {k: r[k] for k in (
        "M", "K", "N", "slots", "ms", "plain_ms", "lora_matmul_ms",
        "library_ms", "bound_ms", "bound_by", "rel_err", "host_us")}
        for (n, dt), r in srows.items() if dt == torch.bfloat16}
    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:172",
        "launches": serve["paged"][0]["kernel_launches"],
        "fabric_launches": fabric_launches("paged_decode_attention"),
        "max_abs_err": main_row["max_abs_err"],
        "worst_bf16_err_all_shapes": worst,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "host_us": main_row["host_us"],
        "repeat_bitwise_all_shapes": all(
            r["repeat_bitwise"] for r in rows.values()),
        "bf16_shapes": {n: {k: r[k] for k in ("ms", "plain_ms", "library_ms",
                                                "bound_ms", "host_us")}
                        for (n, dt), r in rows.items()
                        if dt == torch.bfloat16},
        # a 62-block chain swapped out and back onto fresh ids: the
        # kernel over the remapped table against the original's output
        "swap_round_trip": {k: out["serve_oversub"]["round_trip"][k] for k in (
            "blocks", "moved_bitwise", "remapped_output_bitwise",
            "max_abs_err", "repeat_bitwise", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "swap_out_gb_s", "swap_in_gb_s")},
    }, {
        "name": "lora_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/lora_matmul.cu",
        "replaces": "src/repro/kernels/lora_matmul.py:57",
        # the co-training server, paged 32+16: prefill, decode and train
        "launches": combined["paged"]["lora_matmul_launches"],
        "fabric_launches": fabric_launches("lora_matmul"),
        "train_cli_launches": train_launches["lora_matmul"],
        "shape": "decode M=8 K=N=1024 r=16 bf16",
        "max_abs_err": lrows[("decode", torch.bfloat16)]["max_abs_err"],
        "worst_bf16_rel_err_all_shapes": max(
            r["rel_err"] for (n, dt), r in lrows.items()
            if dt == torch.bfloat16),
        **{k: lrows[("decode", torch.bfloat16)][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "host_us")},
        "repeat_bitwise_all_shapes": all(
            r["repeat_bitwise"] for r in lrows.values()),
        "bf16_shapes": {n: {k: r[k] for k in ("M", "K", "N", "ms",
                                                "plain_ms", "bound_ms",
                                                "bound_by", "library_ms",
                                                "base_only_ms", "host_us")}
                        for (n, dt), r in lrows.items()
                        if dt == torch.bfloat16},
        # the M > 16 path at its most launched shape: the combined 4 x
        # 2,048 run's train batch; its M > 16 launches (prefill waves and
        # train steps, forward and dX) as derived from the run's counts
        "m_gt_16": {
            "shape": "train_2048 M=8192 K=N=1024 r=16 bf16",
            "launches_derived": N_LORA * combined["paged_2048"][
                "prefill_waves"] + (N_LORA + N_LORA_BWD) * combined[
                    "paged_2048"]["train_steps"],
            **{k: lrows[("train_2048", torch.bfloat16)][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "base_only_ms", "host_us")}},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86",
        "launches": combined["paged_2048"]["flash_attention_launches"],
        "train_cli_launches": train_launches["flash_attention"],
        "shape": "prefill wave B=8 H=Hkv=16 D=64 S=2048 causal bf16",
        "max_abs_err": f_fwd["max_abs_err"],
        "worst_bf16_rel_err_all_shapes": max(
            r["rel_err"] for (n, dt), r in frows.items()
            if dt == torch.bfloat16),
        **{k: f_fwd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
        "bf16_shapes": flash_shapes,
    }, {
        "name": "flash_attention_backward",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        # no TPU kernel: JAX differentiates the blockwise scan
        "replaces": "src/repro/models/layers.py:105",
        "launches": combined["paged_2048"][
            "flash_attention_backward_launches"],
        "train_cli_launches": train_launches["flash_attention_backward"],
        "shape": "train batch B=4 H=Hkv=16 D=64 S=2048 causal bf16",
        "max_abs_err": f_bwd["bwd_max_abs_err"],
        "max_rel_err": max(f_bwd[f"{g}_rel_err"] for g in ("dq", "dk", "dv")),
        "ms": f_bwd["bwd_ms"],
        "plain_ms": f_bwd["bwd_plain_ms"],
        "bound_ms": f_bwd["bwd_bound_ms"],
        "bound_by": f_bwd["bwd_bound_by"],
        "library_ms": f_bwd["bwd_library_ms"],
    }, {
        "name": "segmented_lora_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/segmented_lora_matmul.cu",
        "replaces": "src/repro/kernels/lora_matmul.py:132",
        # the 4-tenant server, paged 32+16: prefill and decode
        "launches": adapters["paged"]["segmented_lora_matmul_launches"],
        "fabric_launches": fabric_launches("segmented_lora_matmul"),
        "shape": "decode M=8 K=N=1024 r=16, 4 slots, bf16",
        "max_abs_err": s_main["max_abs_err"],
        "worst_bf16_rel_err_all_shapes": max(
            r["rel_err"] for (n, dt), r in srows.items()
            if dt == torch.bfloat16),
        "rows_bitwise_lora_matmul_all_shapes": all(
            r["rows_bitwise_lora_matmul"] for (n, dt), r in srows.items()
            if dt == torch.bfloat16),
        **{k: s_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "lora_matmul_ms", "host_us")},
        "repeat_bitwise_all_shapes": all(
            r["repeat_bitwise"] for r in srows.values()),
        "library": "base-only torch.matmul (x @ W, no adapter term): a "
                   "floor, no PyTorch call computes the segmented product",
        "bf16_shapes": seg_shapes,
        # the M > 16 path at the 4-tenant prefill wave of 8 x 2,048 rows;
        # its launches: one per adapter projection per prefill wave of
        # the 4-tenant server at 2,048-token prompts
        "m_gt_16": {
            "shape": "prefill_2048 M=16384 K=N=1024 r=16, 4 slots, bf16",
            "launches_derived": N_LORA * adapters["paged_2048"][
                "prefill_waves"],
            **{k: srows[("prefill_2048", torch.bfloat16)][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "lora_matmul_ms", "host_us")}},
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:78",
        # the mamba2 server at 2,048-token prompts: one per layer per
        # request's prefill
        "launches": ssm["ssm_2048"]["launches"]["ssd_scan"],
        "shape": "prefill B=1 S=2048 H=48 P=64 N=128, x bf16",
        "max_abs_err": d_main["max_abs_err"],
        "y_rel_err": d_main["y_rel_err"],
        "state_rel_err": d_main["state_rel_err"],
        "worst_y_rel_err_all_shapes": max(
            r["y_rel_err"] for (n, dt), r in drows.items()
            if dt == torch.bfloat16),
        **{k: d_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
        "bf16_shapes": {n: {k: r[k] for k in ("S", "H", "N", "ms",
                                                "plain_ms", "bound_ms")}
                        for (n, dt), r in drows.items()
                        if dt == torch.bfloat16},
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:80",
        # the VLM server: one per unit per decode step
        "launches": vlm["launches"]["decode_attention"],
        "shape": "cross-attention decode B=8 H=64 Hkv=8 D=128 T=1601, "
                 "K/V a transposed view, bf16",
        "max_abs_err": c_main["max_abs_err"],
        "worst_bf16_err_all_shapes": max(
            r["max_abs_err"] for (n, dt), r in crows.items()
            if dt == torch.bfloat16),
        "worst_f32_err_all_shapes": max(
            r["max_abs_err"] for (n, dt), r in crows.items()
            if dt == torch.float32),
        **{k: c_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "library", "host_us")},
        "repeat_bitwise_all_shapes": all(
            r["repeat_bitwise"] for r in crows.values()),
        "bf16_shapes": {n: {k: r[k] for k in ("S", "lengths", "ms",
                                                "plain_ms", "library_ms",
                                                "bound_ms", "host_us")}
                        for (n, dt), r in crows.items()
                        if dt == torch.bfloat16},
    }]}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
