"""Serving metrics (paper §8.1).

goodput   — output tokens/s of responses that met their SLO deadline
Q-goodput — goodput weighted by response quality (= 1 / CE loss)
plus utilization timelines and control-plane overhead accounting.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.interfaces import BatchResult, Request


@dataclasses.dataclass
class MetricsCollector:
    horizon: float

    def __post_init__(self):
        self.results: List[BatchResult] = []
        self.util_samples: Dict[str, List[Tuple[float, float]]] = \
            collections.defaultdict(list)
        self.overhead_time: float = 0.0
        self.infer_time: float = 0.0
        self.train_time: float = 0.0

    # ------------------------------------------------------------- inputs --
    def on_result(self, result: BatchResult, stream_id: str) -> None:
        self.results.append(result)
        self.infer_time += result.infer_latency

    def sample_utilization(self, replica_id: str, now: float,
                           util: float) -> None:
        self.util_samples[replica_id].append((now, util))

    # ------------------------------------------------------------ outputs --
    def goodput(self, requests: Sequence[Request]) -> Dict[str, float]:
        done = [r for r in requests if r.completed_at is not None]
        met = [r for r in done if r.slo_met]
        tokens_met = sum(r.tokens for r in met)
        q_tokens = sum(r.tokens * r.quality for r in met)
        dur = max(self.horizon, 1e-9)
        return {
            "requests": len(requests),
            "completed": len(done),
            "slo_met": len(met),
            "slo_rate": len(met) / max(len(requests), 1),
            "goodput_tok_s": tokens_met / dur,
            "q_goodput": q_tokens / dur,
            "mean_quality": float(np.mean([r.quality for r in met]))
            if met else 0.0,
        }

    def utilization_summary(self) -> Dict[str, float]:
        vals = [u for s in self.util_samples.values() for _, u in s]
        if not vals:
            return {"mean_util": 0.0, "p10_util": 0.0}
        return {"mean_util": float(np.mean(vals)),
                "p10_util": float(np.quantile(vals, 0.10)),
                "p90_util": float(np.quantile(vals, 0.90))}

    def utilization_timeline(self, bucket: float = 60.0
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Cluster-mean utilization per time bucket (Fig. 11a)."""
        allsamp = [(t, u) for s in self.util_samples.values() for t, u in s]
        if not allsamp:
            return np.zeros(0), np.zeros(0)
        allsamp.sort()
        ts = np.asarray([t for t, _ in allsamp])
        us = np.asarray([u for _, u in allsamp])
        nb = max(int(self.horizon / bucket), 1)
        idx = np.minimum((ts / bucket).astype(int), nb - 1)
        sums = np.bincount(idx, weights=us, minlength=nb)
        cnts = np.maximum(np.bincount(idx, minlength=nb), 1)
        return (np.arange(nb) + 0.5) * bucket, sums / cnts

    def overhead_fraction(self) -> float:
        total = self.overhead_time + self.infer_time + self.train_time
        return self.overhead_time / max(total, 1e-9)


# =========================================================================
# Cluster-wide serving-stats aggregation (multi-replica fabric)
# =========================================================================
_SERVE_COUNTERS = ("admitted", "finished", "prefill_tokens",
                   "cached_prefix_tokens", "generated_tokens",
                   "decode_steps", "train_steps",
                   "nan_publishes_blocked",
                   "budget_ticks", "budget_spent_s", "budget_target_s",
                   "train_skipped_ticks",
                   "preemptions", "swap_out_blocks", "swap_in_blocks",
                   "reprefill_tokens")


def _pctl(vals: List[float]) -> Dict[str, float]:
    """p50/p99 summary of a latency sample list (empty -> None)."""
    if not vals:
        return {"p50": None, "p99": None}
    a = np.asarray(vals, dtype=float)
    return {"p50": float(np.quantile(a, 0.50)),
            "p99": float(np.quantile(a, 0.99))}


def aggregate_serve_stats(per_replica: Dict[str, "object"]) -> Dict:
    """Fold per-replica ``ServeStats`` into one coherent cluster summary.

    Returns ``{"replicas": {rid: {...}}, "cluster": {...}}`` where the
    cluster row sums every token/step counter and reports throughput two
    ways: ``throughput_sum_tok_s`` — the sum of per-replica rates (the
    pool's aggregate rate with each replica on its own accelerator, the
    deployment model) — and ``throughput_wall_tok_s`` — total tokens
    over the SUMMED per-replica busy time (replicas time-slice one
    device, so its sustained rate divides by total busy seconds, not
    the longest replica's).  Duck-typed over the ServeStats fields so
    the metrics module stays framework-free."""
    replicas: Dict[str, Dict[str, float]] = {}
    cluster: Dict[str, float] = {f: 0 for f in _SERVE_COUNTERS}
    rates: List[float] = []
    walls: List[float] = []
    versions: List[int] = []
    train_losses: List[float] = []
    all_ttft: List[float] = []
    all_tpot: List[float] = []
    for rid in sorted(per_replica):
        s = per_replica[rid]
        row = {f: getattr(s, f, 0) for f in _SERVE_COUNTERS}
        row["wall_time"] = float(s.wall_time)
        row["throughput_tok_s"] = float(s.throughput())
        # SLO latency distributions: per-request ttft (arrival ->
        # first token) and tpot (mean seconds/token after the first)
        r_ttft = list(getattr(s, "ttft", []) or [])
        r_tpot = list(getattr(s, "tpot", []) or [])
        row["ttft"] = _pctl(r_ttft)
        row["tpot"] = _pctl(r_tpot)
        all_ttft.extend(r_ttft)
        all_tpot.extend(r_tpot)
        # token-budget scheduler: fraction of each tick's SLO budget
        # actually spent (None when the budget planner is off)
        tgt = float(getattr(s, "budget_target_s", 0.0))
        row["budget_utilization"] = \
            float(getattr(s, "budget_spent_s", 0.0)) / tgt if tgt > 0 \
            else None
        # quality progression: which adapter the replica serves and the
        # latest train CE its fused steps saw (None until it trained)
        row["adapter_version"] = int(getattr(s, "adapter_version", 0))
        tl = float(getattr(s, "train_loss", float("nan")))
        row["train_loss"] = tl if tl == tl else None
        # multi-tenant serving: per-adapter finished-request counts and
        # the tenant's adapter version at last touch ({} on
        # single-adapter replicas / pre-registry stats objects)
        row["adapter_requests"] = dict(
            getattr(s, "adapter_requests", {}) or {})
        row["adapter_versions"] = dict(
            getattr(s, "adapter_versions", {}) or {})
        replicas[rid] = row
        for f in _SERVE_COUNTERS:
            cluster[f] += row[f]
        rates.append(row["throughput_tok_s"])
        walls.append(row["wall_time"])
        versions.append(row["adapter_version"])
        if row["train_loss"] is not None:
            train_losses.append(row["train_loss"])
    cluster["n_replicas"] = len(replicas)
    cluster["wall_time_busy"] = float(sum(walls))
    cluster["wall_time_max"] = float(max(walls, default=0.0))
    cluster["throughput_sum_tok_s"] = float(sum(rates))
    cluster["throughput_wall_tok_s"] = \
        cluster["generated_tokens"] / max(cluster["wall_time_busy"], 1e-9)
    # adapter spread: min == max once every member serves the merged
    # global; a lagging min flags a replica stuck on an old version
    cluster["adapter_version_min"] = int(min(versions, default=0))
    cluster["adapter_version_max"] = int(max(versions, default=0))
    cluster["train_loss"] = float(np.mean(train_losses)) \
        if train_losses else None
    # cluster latency distributions over the CONCATENATED per-request
    # samples (every request counts once, whichever replica served it)
    cluster["ttft"] = _pctl(all_ttft)
    cluster["tpot"] = _pctl(all_tpot)
    tgt = float(cluster["budget_target_s"])
    cluster["budget_utilization"] = \
        float(cluster["budget_spent_s"]) / tgt if tgt > 0 else None
    # per-adapter cluster rollup: requests summed across replicas,
    # version spread per tenant (min < max flags a replica serving a
    # stale copy of that tenant's adapter)
    adapters: Dict[str, Dict[str, int]] = {}
    for row in replicas.values():
        for aid, n in row["adapter_requests"].items():
            a = adapters.setdefault(
                aid, {"requests": 0, "version_min": None,
                      "version_max": None})
            a["requests"] += int(n)
        for aid, v in row["adapter_versions"].items():
            a = adapters.setdefault(
                aid, {"requests": 0, "version_min": None,
                      "version_max": None})
            v = int(v)
            a["version_min"] = v if a["version_min"] is None \
                else min(a["version_min"], v)
            a["version_max"] = v if a["version_max"] is None \
                else max(a["version_max"], v)
    cluster["adapters"] = {aid: adapters[aid] for aid in sorted(adapters)}
    return {"replicas": replicas, "cluster": cluster}
