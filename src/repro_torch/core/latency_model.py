"""Latency models (paper §2.2, §5.2, §6.2).

* ``LinearLatencyModel``   — T_infer(b) = α·b + β                (Eq. 14)
* ``BivariateLatencyModel``— T(B, b) = α·x₁ + β·x₂ + γ           (Eq. 9/10)

Both are ordinary least squares with a tiny ridge term for stability,
maintain bounded sample windows, and report R² — the paper's own
diagnostic for interference-induced model degradation (0.994 → 0.758 in
Fig. 4b, reproduced by benchmarks/latency_model_fit.py).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Optional, Sequence, Tuple

import numpy as np


def _r2(y: np.ndarray, yhat: np.ndarray) -> float:
    ss_res = float(np.sum((y - yhat) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    if ss_tot <= 1e-12:
        return 1.0 if ss_res <= 1e-12 else 0.0
    return 1.0 - ss_res / ss_tot


@dataclasses.dataclass
class LinearLatencyModel:
    """T(b) = alpha * b + beta."""
    alpha: float = 0.0
    beta: float = 0.0
    r2: float = 0.0
    max_samples: int = 512
    ridge: float = 1e-6

    def __post_init__(self) -> None:
        self._samples: Deque[Tuple[float, float]] = collections.deque(
            maxlen=self.max_samples)

    @property
    def fitted(self) -> bool:
        return len(self._samples) >= 2

    def observe(self, batch_size: float, latency: float) -> None:
        self._samples.append((float(batch_size), float(latency)))

    def fit(self) -> Tuple[float, float]:
        if not self.fitted:
            return self.alpha, self.beta
        arr = np.asarray(self._samples, dtype=np.float64)
        x, y = arr[:, 0], arr[:, 1]
        a = np.stack([x, np.ones_like(x)], axis=1)
        ata = a.T @ a + self.ridge * np.eye(2)
        coef = np.linalg.solve(ata, a.T @ y)
        self.alpha, self.beta = float(coef[0]), float(coef[1])
        self.r2 = _r2(y, a @ coef)
        return self.alpha, self.beta

    def predict(self, batch_size: float) -> float:
        return self.alpha * float(batch_size) + self.beta

    def max_batch(self, budget: float, floor: int = 1,
                  cap: int = 4096) -> int:
        """b_max = ⌊(τ' − β)/α⌋   (Eq. 16)."""
        if self.alpha <= 1e-9:
            return cap
        return int(max(floor, min(cap, (budget - self.beta) // self.alpha)))


@dataclasses.dataclass
class BivariateLatencyModel:
    """T(x1, x2) = alpha*x1 + beta*x2 + gamma   (Eq. 9/10).

    For T_infer: x1 = inference batch b, x2 = co-running training batch B.
    For T_train: x1 = training batch B, x2 = co-running inference batch b.
    """
    alpha: float = 0.0
    beta: float = 0.0
    gamma: float = 0.0
    r2: float = 0.0
    max_samples: int = 512
    ridge: float = 1e-6

    def __post_init__(self) -> None:
        self._samples: Deque[Tuple[float, float, float]] = collections.deque(
            maxlen=self.max_samples)

    @property
    def fitted(self) -> bool:
        return len(self._samples) >= 3

    def observe(self, x1: float, x2: float, latency: float) -> None:
        self._samples.append((float(x1), float(x2), float(latency)))

    def fit(self) -> Tuple[float, float, float]:
        if not self.fitted:
            return self.alpha, self.beta, self.gamma
        arr = np.asarray(self._samples, dtype=np.float64)
        x1, x2, y = arr[:, 0], arr[:, 1], arr[:, 2]
        a = np.stack([x1, x2, np.ones_like(x1)], axis=1)
        ata = a.T @ a + self.ridge * np.eye(3)
        coef = np.linalg.solve(ata, a.T @ y)
        self.alpha, self.beta, self.gamma = map(float, coef)
        self.r2 = _r2(y, a @ coef)
        return self.alpha, self.beta, self.gamma

    def predict(self, x1: float, x2: float) -> float:
        return self.alpha * x1 + self.beta * x2 + self.gamma

    def max_x1(self, budget: float, x2: float, floor: int = 0,
               cap: int = 4096) -> int:
        """max x1 with T(x1, x2) <= budget   (Eq. 12)."""
        if self.alpha <= 1e-9:
            return cap
        return int(max(floor,
                       min(cap, (budget - self.beta * x2 - self.gamma)
                           // self.alpha)))
