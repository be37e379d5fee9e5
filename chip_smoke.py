#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA Hopper card.

  python3 chip_smoke.py

Phases, each printing one JSON line:
  device      the card (``nvidia-smi`` name and power limit), TF32 off;
  build       nvcc builds every kernel under ``src/repro_torch/csrc``;
  kernel      each kernel against its plain PyTorch version on the card,
              at the serving shape and four more (long context, GQA,
              pool blocks of 128 and 256 rows), float32 and bfloat16:
              worst error, kernel / plain / library time (CUDA events,
              median of 60, L2 flushed before each), and the least time
              the card could take (bytes over 3.35 TB/s, operations over
              the dtype's peak rate, whichever is larger);
  reference   the port on the card against the port on the CPU (plain
              versions) at a reduced float32 config; full-width logits
              finite and of the right shape;
  serve       qwen1.5-0.5b at full width (24 layers, d_model 1024, bf16,
              random weights from a seed) through ``run_serving``: paged
              and contiguous with 32-token prompts, then with 992-token
              prompts paged (blocks of 16 and of 128) and contiguous (a
              1024-row cache, viewed as 256-row blocks); every request
              finishes, the kernel ran 24 times per decode step, the
              allocator drains, all layouts of one traffic emit the same
              tokens;
  tick        where a full-width decode tick's time goes: host wall per
              tick, and under torch.profiler the device time, the
              attention kernel's share and the kernels launched per tick;
  kernels     one line over all ported kernels.
The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before
that.  Without a CUDA device, or without the rest of the repository, it
exits non-zero and prints no result.
"""
import json
import os
import statistics
import subprocess
import sys
import time

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


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ timing ------
_FLUSH = None


def device_ms(fn):
    """Median device time of ``fn`` over REPS runs: each run starts with
    a cold L2 (a 64 MB write) and behind a device spin long enough that
    the host enqueues the whole of ``fn`` before the start event fires."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(16 << 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
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


# --------------------------------------------------------- reference -----
def phase_reference(get_config, build):
    """The port on the card against the port on the CPU on the same
    float32 weights (reduced config), then full-width logits sanity."""
    from repro_torch.runtime.paging import blocks_for
    cfg = get_config(ARCH).scaled()
    cpu = build(cfg, "cpu")
    gpu = build(cfg, "cuda")
    params = cpu.init(torch.Generator().manual_seed(0))
    lora = cpu.init_lora(torch.Generator().manual_seed(1))
    for pair in lora.values():              # a live bypass: b != 0
        pair["b"].normal_(0.0, 0.1, generator=torch.Generator()
                          .manual_seed(2))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

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
    for name, m in (("cpu", cpu), ("cuda", gpu)):
        p, lo = to(params, m.device), to(lora, m.device)
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
    del full, params, lora, caches, pre, logits, dec
    torch.cuda.empty_cache()


# ------------------------------------------------------------- serving ----
def phase_serve(run_serving, pda):
    n_layers = 24
    runs = [("paged", dict(paged=True, prompt_len=32, gen_tokens=16)),
            ("contiguous", dict(paged=False, prompt_len=32, gen_tokens=16)),
            ("paged_long", dict(paged=True, prompt_len=992, gen_tokens=32)),
            ("paged_long_bs128", dict(paged=True, block_size=128,
                                      prompt_len=992, gen_tokens=32)),
            ("contiguous_long", dict(paged=False, prompt_len=992,
                                     gen_tokens=32))]
    results = {}
    for name, kw in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pda.launches = 0                                  # main path starts
        out = run_serving(ARCH, smoke=False, n_requests=16, batch_size=8,
                          seed=0, device="cuda", verbose=False, **kw)
        launches = pda.launches                           # main path ends
        gen = kw["gen_tokens"]
        row = {
            "run": name, "prompt_len": kw["prompt_len"], "gen_tokens": gen,
            "block_size": kw.get("block_size", 16) if kw["paged"] else None,
            "finished": out["finished"],
            "tokens_generated": out["tokens_generated"],
            "decode_steps": out["decode_steps"],
            "kernel_launches": launches,
            "throughput_tok_s": out["throughput_tok_s"],
            "wall_s": out["wall_s"],
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
        if kw["paged"] and (out["blocks_used_at_end"]
                            or out["blocks_reserved_at_end"]):
            raise AssertionError(f"{name}: allocator did not drain")
        results[name] = (row, out["tokens"])
    # the kernel walks logical rows whatever the pool's block size, so
    # every layout of one traffic computes the same logits
    short = results["paged"][1] == results["contiguous"][1]
    long_ = all(results[n][1] == results["paged_long"][1]
                for n in ("paged_long_bs128", "contiguous_long"))
    emit("serve_check", short_paged_equals_contiguous_tokens=short,
         long_all_layouts_equal_tokens=long_)
    if not (short and long_):
        raise AssertionError("layouts of one traffic emitted different "
                             "tokens")
    return results


# ---------------------------------------------------------------- tick ----
def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) \
        or getattr(evt, "self_cuda_time_total", 0)


def phase_tick(make_engine, get_config, n=5):
    """Where a full-width decode tick's time goes (paged, 8 busy slots):
    host wall per tick, then under torch.profiler the device time its
    kernels take, the attention kernel's part, and kernels per tick."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serving_loop import ContinuousBatcher, GenRequest
    cfg = get_config(ARCH)
    engine = make_engine(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = engine.model.init(gen)
    lora = engine.model.init_lora(gen)
    rng = np.random.default_rng(0)
    for name, plen in (("serve", 32), ("long", 992)):
        b = ContinuousBatcher(engine, params, lora, n_slots=8,
                              max_seq=plen + 16, prompt_pad=plen, paged=True)
        for i in range(8):
            b.submit(GenRequest(request_id=i, max_new_tokens=16,
                                prompt=rng.integers(0, cfg.vocab_size, plen)))
        for _ in range(3):                   # admission wave + warm ticks
            b.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            b.step()
        host_ms = (time.perf_counter() - t0) / n * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                b.step()
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t0) / n * 1e3
        assert len(b.active_slots()) == 8, "a slot finished inside the window"
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_ms = sum(_device_us(e) for e in kern) / 1e3 / n
        attn_ms = sum(_device_us(e) for e in kern
                      if "paged_decode_kernel" in e.key) / 1e3 / n
        top = sorted(kern, key=_device_us, reverse=True)[:6]
        emit("tick", context=name, prompt_len=plen, slots=8,
             host_ms_per_tick=host_ms, profiled_wall_ms_per_tick=prof_ms,
             device_busy_ms_per_tick=dev_ms,
             device_busy_share=dev_ms / prof_ms if prof_ms else None,
             attention_ms_per_tick=attn_ms,
             attention_share_of_device=attn_ms / dev_ms if dev_ms else None,
             kernels_per_tick=sum(e.count for e in kern) / n,
             top_kernels_ms_per_tick=[[e.key[:60], _device_us(e) / 1e3 / n]
                                      for e in top])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import make_engine
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention as pda, paged_decode_attention_ref as pda_ref)
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

    t0 = time.perf_counter()
    built = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    for name in built:
        _build.library(name)
    emit("build", seconds=time.perf_counter() - t0, built=built)

    rows = phase_kernel(pda, pda_ref)
    phase_reference(get_config, build)
    serve = phase_serve(run_serving, pda)
    phase_tick(make_engine, get_config)

    main_row = rows[("serve", torch.bfloat16)]
    worst = max(r["max_abs_err"] for (n, dt), r in rows.items()
                if dt == torch.bfloat16)
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
    }]}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
