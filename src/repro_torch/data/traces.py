"""Azure-like LLM inference trace generation + replay (paper §2.1, §8.1).

The paper replays Azure-Code and Azure-Conv over a 10 h window; those
files aren't available offline, so we synthesize traces with the same
reported morphology (Fig. 1): diurnal swing with troughs at <0.7% of the
peak rate, sudden surges up to ~440% of the local baseline, and heavy
sub-second burstiness (doubly-stochastic Poisson / Markov-modulated
surges).  Deterministic under a seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.interfaces import Request


@dataclasses.dataclass
class TraceConfig:
    name: str = "azure-conv-like"
    duration: float = 3600.0        # seconds
    peak_rate: float = 40.0         # req/s at diurnal peak
    trough_frac: float = 0.007      # Fig. 1: <0.7% of peak at the trough
    diurnal_period: float = 1800.0  # compressed "day" for the sim window
    surge_rate_mult: float = 4.4    # 440% surge (Fig. 1)
    surge_prob_per_s: float = 0.004
    surge_duration: float = 25.0
    burst_cv: float = 1.8           # sub-second burstiness (CV > 1)
    mean_tokens: int = 180          # output tokens per request (conv)
    token_cv: float = 0.6
    slo: float = 0.5
    stream_id: str = "llama3-8b"
    seed: int = 0


def rate_at(cfg: TraceConfig, t: float, surge: bool) -> float:
    lo = cfg.peak_rate * cfg.trough_frac
    phase = 0.5 * (1 - math.cos(2 * math.pi * t / cfg.diurnal_period))
    base = lo + (cfg.peak_rate - lo) * phase ** 2.2   # sharpen the peak
    return base * (cfg.surge_rate_mult if surge else 1.0)


def generate(cfg: TraceConfig, start_id: int = 0) -> List[Request]:
    """Markov-modulated Poisson process with gamma-distributed gaps for
    sub-second burstiness (CV = cfg.burst_cv)."""
    rng = np.random.default_rng(cfg.seed)
    out: List[Request] = []
    t = 0.0
    surge_until = -1.0
    rid = start_id
    # gamma with shape k has CV = 1/sqrt(k)
    k = 1.0 / (cfg.burst_cv ** 2)
    while t < cfg.duration:
        if t > surge_until and rng.random() < cfg.surge_prob_per_s * 0.1:
            surge_until = t + cfg.surge_duration * rng.lognormal(0, 0.3)
        lam = rate_at(cfg, t, t <= surge_until)
        mean_gap = 1.0 / max(lam, 1e-6)
        gap = float(rng.gamma(k, mean_gap / k))
        t += gap
        if t >= cfg.duration:
            break
        tokens = max(8, int(rng.lognormal(
            math.log(cfg.mean_tokens), cfg.token_cv)))
        out.append(Request(
            request_id=rid, stream_id=cfg.stream_id, arrival=t,
            deadline=t + cfg.slo, tokens=tokens))
        rid += 1
    return out


def code_trace(duration: float = 3600.0, seed: int = 1,
               stream_id: str = "llama3-8b", scale: float = 1.0
               ) -> List[Request]:
    """Azure-Code-like: lower rate, longer responses, spikier."""
    return generate(TraceConfig(
        name="azure-code-like", duration=duration, peak_rate=12.0 * scale,
        mean_tokens=420, token_cv=0.8, surge_prob_per_s=0.006,
        burst_cv=2.2, stream_id=stream_id, seed=seed))


def conv_trace(duration: float = 3600.0, seed: int = 2,
               stream_id: str = "llama3-8b", scale: float = 1.0
               ) -> List[Request]:
    """Azure-Conv-like: higher rate, shorter responses."""
    return generate(TraceConfig(
        name="azure-conv-like", duration=duration, peak_rate=40.0 * scale,
        mean_tokens=180, token_cv=0.6, stream_id=stream_id, seed=seed))


def merged_trace(duration: float = 3600.0, scale: float = 1.0,
                 stream_id: str = "llama3-8b", seed: int = 0
                 ) -> List[Request]:
    """§8.1: the two traces merged into one multi-tenant pattern."""
    a = code_trace(duration, seed=seed * 2 + 1, stream_id=stream_id,
                   scale=scale)
    b = conv_trace(duration, seed=seed * 2 + 2, stream_id=stream_id,
                   scale=scale)
    for i, r in enumerate(a + b):
        r.request_id = i
    merged = sorted(a + b, key=lambda r: r.arrival)
    return merged


def replay(requests: Sequence[Request], simulator, submit) -> None:
    """Schedule every request's arrival on the simulator."""
    for req in requests:
        simulator.schedule(req.arrival,
                           lambda now, r=req: submit(r), tag="arrival")


def stats(requests: Sequence[Request], bucket: float = 10.0) -> dict:
    """Fig. 1-style summary: rate percentiles, surge/trough ratio, CV."""
    if not requests:
        return {}
    arr = np.asarray([r.arrival for r in requests])
    dur = float(arr.max()) + 1e-9
    counts, _ = np.histogram(arr, bins=max(int(dur / bucket), 1))
    rates = counts / bucket
    nz = rates[rates > 0]
    secly, _ = np.histogram(arr, bins=max(int(dur), 1))
    return {
        "requests": len(requests),
        "mean_rate": float(len(requests) / dur),
        "peak_rate": float(rates.max()),
        "trough_over_peak": float(
            (nz.min() if len(nz) else 0.0) / max(rates.max(), 1e-9)),
        "surge_over_median": float(
            rates.max() / max(np.median(nz) if len(nz) else 1.0, 1e-9)),
        "per_second_cv": float(np.std(secly) / max(np.mean(secly), 1e-9)),
    }
