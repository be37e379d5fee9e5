"""Training goodput (paper §5.1, extending Pollux) and the constrained
(B*, b*) optimization (Eq. 11–12).

  GOODPUT_t(B, b) = THROUGHPUT(B, b) × EFFICIENCY_t(B)
  THROUGHPUT      = B / T_train(B, b)                        (Eq. 7)
  EFFICIENCY_t(B) = (a·p_t·l_t + B0) / (a·p_t·l_t + B)       (Eq. 8)

p_t is the gradient-noise scale, l_t the average per-iteration loss
reduction; both come from Coordinator telemetry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.core.latency_model import BivariateLatencyModel


@dataclasses.dataclass
class EfficiencyParams:
    scale_a: float = 1.0       # a in Eq. 8
    init_batch: int = 4        # B0 in Eq. 8
    noise_scale: float = 1.0   # p_t
    loss_reduction: float = 0.1  # l_t


def efficiency(train_batch: float, p: EfficiencyParams) -> float:
    apl = p.scale_a * max(p.noise_scale, 0.0) * max(p.loss_reduction, 0.0)
    return (apl + p.init_batch) / (apl + max(train_batch, 1e-9))


def throughput(train_batch: float, infer_batch: float,
               t_train: BivariateLatencyModel) -> float:
    lat = t_train.predict(train_batch, infer_batch)
    if lat <= 1e-9:
        return 0.0
    return train_batch / lat


def goodput(train_batch: float, infer_batch: float,
            t_train: BivariateLatencyModel, p: EfficiencyParams) -> float:
    return throughput(train_batch, infer_batch, t_train) \
        * efficiency(train_batch, p)


def optimize(t_train: BivariateLatencyModel,
             t_infer: BivariateLatencyModel,
             p: EfficiencyParams, latency_budget: float, *,
             train_batches: Sequence[int] = tuple(range(1, 65)),
             infer_cap: int = 256) -> Tuple[int, int, float]:
    """Grid-search (B*, b*) = argmax_B GOODPUT(B, b*(B))   (Eq. 11).

    For each candidate B, b*(B) is the largest inference batch whose
    predicted latency under interference stays within the budget
    (Eq. 12); replicas must keep serving, so B with b*(B) == 0 are
    rejected unless nothing else is feasible.
    """
    best: Tuple[int, int, float] = (0, 0, -1.0)
    for big_b in train_batches:
        b_star = t_infer.max_x1(latency_budget, big_b, floor=0,
                                cap=infer_cap)
        if b_star <= 0:
            continue
        g = goodput(big_b, b_star, t_train, p)
        if g > best[2]:
            best = (int(big_b), int(b_star), float(g))
    if best[2] < 0:  # nothing feasible: train minimally, serve minimally
        return 1, 1, goodput(1, 1, t_train, p)
    return best
