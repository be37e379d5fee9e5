#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA Hopper card.

  python3 chip_smoke.py             every phase, then the result lines
  python3 chip_smoke.py PHASE ...   bring-up: the named phases alone
                                    (after device and build), no result

Phases, each printing JSON lines:
  device      the card (``nvidia-smi`` name and power limit), TF32 off;
  build       nvcc builds every kernel under ``src/repro_torch/csrc``,
              one process per source, all started together;
  kernel      paged_decode_attention against its plain PyTorch version,
              float32 and bfloat16, at the serving shape and four more
              (long context, GQA, pool blocks of 128 and 256 rows);
  kernel_lora lora_matmul at the decode, train, prefill, long train and
              long prefill shapes of qwen1.5-0.5b, two ragged shapes
              (M 1000 and 5) and mamba2-780m's ssm_in / ssm_out at
              decode and a 2,048-token prefill, plus its backward (dX, dA, dB of
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
              qwen1.5-0.5b, a ragged shape and llama3-8b's decode; in bf16
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
              decode_attention once per unit per step;
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
  serve_ssm   mamba2-780m at full width (48 layers, d_model 1536, bf16),
              16 requests on 8 contiguous slots at 32+16, 992+32 and
              2,048+32 tokens: every request finishes, ssd_scan once per
              layer per request, lora_matmul once per adapter projection
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
  mixed_solo  one wave of base and three tenants against each of them
              served alone as the single adapter on the same prompts: the
              same greedy tokens (each request in a wave of its own is
              read out beside it);
  train       ten full-width train steps on one fixed 4 x 256 batch: the
              loss falls, 189 lora_matmul launches per step;
  tick        where a full-width tick's time goes (serve ticks at 32-,
              992- and 2,048-token prompts, combined ticks with a 4 x 32
              and a 4 x 2,048 train batch, a serve tick of 4 tenants at 32
              tokens, mamba2-780m decode ticks after 32- and 2,048-token
              prompts, a VLM decode tick): host wall per tick, and under
              torch.profiler the device time, each kernel's share and the
              kernels launched per tick;
  kernels     one line over all ported kernels.
The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that.  Without a CUDA device, or without the rest of the repository, it
exits non-zero and prints no result.
"""
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

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

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
# them they take each of the bf16 kernel's four tile shapes; then
# mamba2-780m's ssm_in (N = 6448: no multiple of 64) and ssm_out at decode
# (8 slots) and at a 2,048-token prefill (forward only)
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
               ("ssm_out_prefill", 2048, 3072, 1536, 16)]
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


# ------------------------------------------------- paged decode attention -
def attention_case(b, h, hkv, d, bs, nb, dtype, seed):
    """Inputs as the runtime builds them: shuffled non-scratch blocks for
    each sequence's live range, scratch block 0 past it, ragged kv_len
    holding 1 and a full table."""
    n_blocks = 1 + b * nb
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
    kp = torch.randn((n_blocks, bs, hkv, d), generator=g,
                     device="cuda").to(dtype)
    vp = torch.randn((n_blocks, bs, hkv, d), generator=g,
                     device="cuda").to(dtype)
    rng = np.random.default_rng(seed)
    kv_len = rng.integers(1, nb * bs + 1, size=b).astype(np.int32)
    kv_len[0], kv_len[1] = 1, nb * bs
    perm = rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
    tables = np.zeros((b, nb), np.int32)
    used = 0
    for i in range(b):
        live = -(-int(kv_len[i]) // bs)
        tables[i, :live] = perm[used:used + live]
        used += live
    return (q, kp, vp, torch.tensor(tables, device="cuda"),
            torch.tensor(kv_len, device="cuda"))


def attention_bound(q, kp, tables, kv_len):
    """Least time for one call: K/V rows up to kv_len read once, q read
    and out written once, live table entries and kv_len read once;
    4 FLOP per (query head, live row, channel)."""
    b, h, d = q.shape
    bs, hkv = kp.shape[1], kp.shape[2]
    lens = kv_len.long()
    elt = q.element_size()
    live_blocks = int(((lens + bs - 1) // bs).sum())
    nbytes = (2 * q.numel() * elt + 2 * int(lens.sum()) * hkv * d * elt
              + 4 * live_blocks + 4 * b)
    ops = 4 * int(lens.sum()) * h * d
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = ops / PEAK_OPS_S[q.dtype]
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel(pda, pda_ref):
    """paged_decode_attention against its plain version."""
    shapes = [
        ("serve", dict(b=8, h=16, hkv=16, d=64, bs=16, nb=3)),
        ("long", dict(b=8, h=16, hkv=16, d=64, bs=16, nb=64)),
        ("gqa", dict(b=4, h=32, hkv=8, d=128, bs=16, nb=64)),
        ("bs128", dict(b=8, h=16, hkv=16, d=64, bs=128, nb=8)),
        ("bs256", dict(b=8, h=16, hkv=16, d=64, bs=256, nb=4)),
    ]
    rows = {}
    for si, (name, shp) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, tables, kv_len = attention_case(
                **shp, dtype=dtype, seed=100 + si)
            out = pda(q, kp, vp, tables, kv_len)
            ref = pda_ref(q, kp, vp, tables, kv_len)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            tol = TOL[dtype]
            ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
            # the library yardstick: SDPA over the gathered cache (gather
            # and head expansion outside the timed call)
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
                "shape": name, **shp, "dtype": str(dtype).split(".")[-1],
                "max_abs_err": err, "tol": tol, "ok": bool(ok),
                "ms": device_ms(lambda: pda(q, kp, vp, tables, kv_len)),
                "plain_ms": device_ms(
                    lambda: pda_ref(q, kp, vp, tables, kv_len)),
                "library_ms": device_ms(lib),
                "library_max_abs_err": lib_err,
            }
            row["bound_ms"], row["bound_by"] = attention_bound(
                q, kp, tables, kv_len)
            row["bound_us"] = row["bound_ms"] * 1e3
            emit("kernel", kernel="paged_decode_attention", **row)
            if not ok:
                raise AssertionError(
                    f"paged_decode_attention {name} {dtype}: kernel vs "
                    f"plain max abs err {err} beyond {tol}")
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


def phase_kernel_lora(lm, lm_ref, fn_cls):
    """lora_matmul against its plain version at the main path's shapes,
    then its backward at the train shapes and at the decode shape (the
    transposed operands on the M <= 16 tile)."""
    rows = {}
    for si, (name, m, k, n, r) in enumerate(LORA_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
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
            }
            row["bound_ms"], row["bound_by"] = lora_bound(m, k, n, r, dtype)
            emit("kernel", kernel="lora_matmul", **row)
            if not rel <= LORA_TOL[dtype]:
                raise AssertionError(
                    f"lora_matmul {name} {dtype}: kernel vs plain error "
                    f"{rel} of the largest output, beyond {LORA_TOL[dtype]}")
            rows[(name, dtype)] = row
    for name, m, k, n, r in LORA_SHAPES:
        if not (name.startswith("train") or name == "decode"):
            continue
        for dtype in (torch.float32, torch.bfloat16):
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
# sequence), a ragged shape with a slot per row, and llama3-8b's decode
# projections (k/v: N 1024; q/o: N 4096)
SEG_SHAPES = [("decode", 8, 1024, 1024, 16, 4, 1),
              ("decode_a1", 8, 1024, 1024, 16, 1, 1),
              ("decode_a8", 8, 1024, 1024, 16, 8, 1),
              ("prefill", 256, 1024, 1024, 16, 4, 32),
              ("prefill_992", 7936, 1024, 1024, 16, 4, 992),
              ("prefill_2048", 16384, 1024, 1024, 16, 4, 2048),
              ("ragged", 1000, 1000, 2816, 16, 4, 1),
              ("llama_decode_kv", 8, 4096, 1024, 16, 4, 1),
              ("llama_decode", 8, 4096, 4096, 16, 4, 1)]
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
                library="base-only torch.matmul")
            row["bound_ms"], row["bound_by"] = seg_bound(m, k, n, r, idx,
                                                         dtype)
            emit("kernel", kernel="segmented_lora_matmul", **row)
            if not ok:
                raise AssertionError(
                    f"segmented_lora_matmul {name} {dtype}: error {rel} of "
                    f"the largest output (tolerance {LORA_TOL[dtype]}), "
                    f"bitwise rows {row.get('rows_bitwise_lora_matmul')}, "
                    f"poison {row.get('poison_1e6_no_leak')}")
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
            }
            row["bound_ms"], row["bound_by"] = ssd_bound(b, s, h, p, n, init,
                                                         dtype)
            emit("kernel", kernel="ssd_scan", **row)
            if not (finite and ey <= SSD_TOL_Y[dtype] and es <= SSD_TOL_STATE):
                raise AssertionError(
                    f"ssd_scan {name} {dtype}: y {ey}, state {es} of the "
                    "largest value, beyond tolerance (or not finite)")
            rows[(name, dtype)] = row
            del x, dt, a, bm, cm, st, y, fin, yr, finr
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
                "library": "SDPA" + (" enable_gqa" if gqa else
                                     " over K/V repeated to H heads"),
                "library_max_abs_err": lib_err,
            }
            row["bound_ms"], row["bound_by"] = decode_bound(q, k, kv_len)
            row["bound_us"] = row["bound_ms"] * 1e3
            emit("kernel", kernel="decode_attention", **row)
            if not (ok and zero_rows_exact):
                raise AssertionError(
                    f"decode_attention {name} {dtype}: kernel vs plain max "
                    f"abs err {err} beyond {tol}, or an empty row not zero")
            rows[(name, dtype)] = row
            del q, k, v, kv_len, out, ref, kl, vl, mask
            torch.cuda.empty_cache()
    return rows


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


def _reference_ssm(get_config, build, scan, steps=5):
    """mamba2 at its reduced float32 size (2 layers, 8 SSM heads of 32,
    state 16), the card against the CPU on the same weights: one
    exact-length prefill of two 100-token prompts (the kernel takes the
    mixer's strided views, and 100 is no multiple of its chunk): logits,
    conv tails and states; then both requests written into slots 2 and 0
    of a 3-slot pool and ``steps`` decode steps' logits.  The card's
    prefill launches ssd_scan once per layer."""
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
    if launches != cfg.n_layers:
        raise AssertionError(f"mamba2 reference: {launches} ssd_scan "
                             f"launches for one prefill of {cfg.n_layers} "
                             "layers")


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
    prefills alone, at its exact length), lora_matmul once per adapter
    projection (ssm_in, ssm_out) per layer per prefill call and decode
    step, and no attention or segmented kernel at all."""
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
        want = {"ssd_scan": cfg.n_layers * 16,
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


# ---------------------------------------------------------------- tick ----
def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) \
        or getattr(evt, "self_cuda_time_total", 0)


def _is_lora(key):
    return "lora_mma_kernel" in key or "lora_fma_kernel" in key


def _is_seg(key):
    return "segmented_mma_kernel" in key or "segmented_fma_kernel" in key


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
    _tick_vlm(make_engine, get_config, n)


def _is_decode(key):
    return "decode_attn_split_kernel" in key \
        or "decode_attn_combine_kernel" in key


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
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
        "serve_ssm": lambda: phase_serve_ssm(run_serving, get_config, pda,
                                             lm, fa, seg, ssd.ssd_scan),
        "serve_vlm": lambda: phase_serve_vlm(make_engine, get_config, pda, lm,
                                             fa, seg, ssd.ssd_scan, dattn),
        "combined": lambda: phase_combined(run_serving, get_config, pda, lm,
                                           fa, seg),
        "serve_adapters": lambda: phase_serve_adapters(
            run_serving, get_config, pda, lm, fa, seg, out.get("serve")),
        "mixed_solo": lambda: phase_mixed_solo(get_config, make_engine, seg,
                                               lm),
        "train": lambda: phase_train(make_engine, get_config, lm),
        "tick": lambda: phase_tick(make_engine, get_config),
    }
    only = sys.argv[1:]
    out = {}      # each phase's results, as later phases read them
    if only:
        # bring-up: the named phases alone, and no result lines
        for name in only:
            out[name] = phases[name]()
        return
    for name, fn in phases.items():
        out[name] = fn()
    rows, lrows, frows = out["kernel"], out["kernel_lora"], \
        out["kernel_flash"]
    serve, combined = out["serve"], out["combined"]
    srows, adapters = out["kernel_seg"], out["serve_adapters"]
    s_main = srows[("decode", torch.bfloat16)]
    drows, ssm = out["kernel_ssd"], out["serve_ssm"]
    d_main = drows[("mamba_2048", torch.bfloat16)]
    crows, vlm = out["kernel_decode"], out["serve_vlm"]
    c_main = crows[("cross", torch.bfloat16)]

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
        "library_ms", "bound_ms", "bound_by", "rel_err")}
        for (n, dt), r in srows.items() if dt == torch.bfloat16}
    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/paged_decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:172",
        "launches": serve["paged"][0]["kernel_launches"],
        "max_abs_err": main_row["max_abs_err"],
        "worst_bf16_err_all_shapes": worst,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }, {
        "name": "lora_matmul",
        "route": "cuda",
        "source": "src/repro_torch/csrc/lora_matmul.cu",
        "replaces": "src/repro/kernels/lora_matmul.py:57",
        # the co-training server, paged 32+16: prefill, decode and train
        "launches": combined["paged"]["lora_matmul_launches"],
        "shape": "decode M=8 K=N=1024 r=16 bf16",
        "max_abs_err": lrows[("decode", torch.bfloat16)]["max_abs_err"],
        "worst_bf16_rel_err_all_shapes": max(
            r["rel_err"] for (n, dt), r in lrows.items()
            if dt == torch.bfloat16),
        **{k: lrows[("decode", torch.bfloat16)][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms")},
        "bf16_shapes": {n: {k: r[k] for k in ("M", "K", "N", "ms",
                                                "plain_ms", "bound_ms",
                                                "bound_by", "library_ms",
                                                "base_only_ms")}
                        for (n, dt), r in lrows.items()
                        if dt == torch.bfloat16},
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86",
        "launches": combined["paged_2048"]["flash_attention_launches"],
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
        "shape": "decode M=8 K=N=1024 r=16, 4 slots, bf16",
        "max_abs_err": s_main["max_abs_err"],
        "worst_bf16_rel_err_all_shapes": max(
            r["rel_err"] for (n, dt), r in srows.items()
            if dt == torch.bfloat16),
        "rows_bitwise_lora_matmul_all_shapes": all(
            r["rows_bitwise_lora_matmul"] for (n, dt), r in srows.items()
            if dt == torch.bfloat16),
        **{k: s_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "lora_matmul_ms")},
        "library": "base-only torch.matmul (x @ W, no adapter term)",
        "bf16_shapes": seg_shapes,
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
                                  "library_ms", "library")},
        "bf16_shapes": {n: {k: r[k] for k in ("S", "lengths", "ms",
                                                "plain_ms", "library_ms",
                                                "bound_ms")}
                        for (n, dt), r in crows.items()
                        if dt == torch.bfloat16},
    }]}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
