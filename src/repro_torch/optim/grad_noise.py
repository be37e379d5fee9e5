"""Gradient noise scale (McCandlish et al., arXiv:1812.06162) — the
port of ``repro.optim.grad_noise``.

CoLLM's Coordinator uses the noise scale ``p_t`` inside the EFFICIENCY
term (Eq. 8) to penalize over-large training batches.  The simple
(B_small, B_big) estimator: with per-microbatch gradients g_i and their
mean g,

  S = (B_big*|g_big|² - B_small*|g_small|²) / (B_big - B_small)   (signal)
  Σ = (|g_small|² - |g_big|²) / (1/B_small - 1/B_big)             (noise)
  B_noise = Σ / S

The inputs are a train step's ``micro_grad_sqnorm`` and ``grad_sqnorm``
metrics (tensors or host floats).
"""
from __future__ import annotations

import torch


def noise_scale_from_microbatches(micro_grads_sqnorm, mean_grad_sqnorm,
                                  micro_batch: int, n_micro: int
                                  ) -> torch.Tensor:
    """micro_grads_sqnorm: mean over microbatches of |g_i|²;
    mean_grad_sqnorm: |mean_i g_i|².  Returns estimated noise scale."""
    g2_small = torch.as_tensor(micro_grads_sqnorm, dtype=torch.float32)
    g2_big = torch.as_tensor(mean_grad_sqnorm, dtype=torch.float32,
                             device=g2_small.device)
    b_small = float(micro_batch)
    b_big = float(micro_batch * n_micro)
    signal = (b_big * g2_big - b_small * g2_small) / max(b_big - b_small,
                                                         1.0)
    noise = (g2_small - g2_big) / max(1.0 / b_small - 1.0 / b_big, 1e-9)
    return torch.clamp(noise, min=0.0) / torch.clamp(signal, min=1e-9)


class NoiseScaleEMA:
    """Host-side EMA of the noise-scale estimate (Coordinator telemetry)."""

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.value: float = 0.0
        self._initialized = False

    def update(self, estimate: float) -> float:
        if not self._initialized:
            self.value = float(estimate)
            self._initialized = True
        else:
            self.value = self.decay * self.value \
                + (1 - self.decay) * float(estimate)
        return self.value

    @property
    def initialized(self) -> bool:
        """True once at least one measurement has landed — consumers
        fall back to a prior until then."""
        return self._initialized
