"""Step functions of the port — ``repro.core.engine`` for serving.

The JAX engine also owns the optimizer, the LoRA train step and the
fused co-training steps (``combined_step[_paged]``); those come with the
training slice (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, build


@dataclasses.dataclass(frozen=True)
class Engine:
    """Step factory for one architecture on one device."""
    model: Model

    def prefill_step(self, params: Any, lora: Any,
                     batch: Any) -> Tuple[torch.Tensor, Any]:
        """Prefill full-length prompts: (last-token logits, caches)."""
        tokens = batch["tokens"]
        lens = torch.full((tokens.shape[0],), tokens.shape[1],
                          device=tokens.device)
        return self.model.prefill_ragged(params, lora, batch, lens)

    def decode_step(self, params: Any, lora: Any, caches: Any,
                    token: torch.Tensor,
                    pos: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        return self.model.decode_step(params, lora, caches, token, pos)


def make_engine(cfg: ModelConfig, device="cuda") -> Engine:
    return Engine(model=build(cfg, device))
