"""AdamW for the port — ``repro.optim.adamw`` in PyTorch, with the same
functional (init, update) interface, global-norm clipping and schedules.

``update`` returns NEW tensors and leaves its inputs untouched, as the
JAX version does.  The LoRA trees it steps are small (~12.6 MB at
qwen1.5-0.5b's r=16), and new tensors make the co-training snapshot
semantics hold by construction: a decode that read the pre-update
adapter keeps reading it, whatever the optimizer does next.

State mirrors the params (m, v in float32); ``step`` is a 0-d int32
tensor on the params' device, so a step needs no host sync.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Tuple, Union

import torch

from ..tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


def _first_device(tree: Any) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 1.0

    def init(self, params: Any) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32,
                             device=_first_device(params)),
            m=tree_map(zeros, params), v=tree_map(zeros, params))

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any
               ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
        """One step: clip by global norm, Adam moments with bias
        correction, decoupled weight decay.  Returns (new params, new
        state, {"grad_norm", "lr"})."""
        step = state.step + 1
        gnorm = global_norm(grads)
        if self.clip_norm > 0:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
        grads = tree_map(lambda g: g.float() * scale, grads)
        m = tree_map(lambda mm, g: self.b1 * mm + (1 - self.b1) * g,
                     state.m, grads)
        v = tree_map(lambda vv, g: self.b2 * vv + (1 - self.b2) * g * g,
                     state.v, grads)
        stepf = step.float()
        bc1 = 1 - torch.pow(self.b1, stepf)
        bc2 = 1 - torch.pow(self.b2, stepf)
        lr = self._lr(step)

        def upd(p, mm, vv):
            delta = (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
            if self.weight_decay > 0:
                delta = delta + self.weight_decay * p.float()
            return p + (-lr * delta).to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        metrics = {"grad_norm": gnorm, "lr": lr}
        return new_params, AdamWState(step=step, m=m, v=v), metrics


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(sum(x.float().square().sum() for x in leaves))


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable:
    """Linear warmup to ``base_lr``, then cosine decay to
    ``min_frac * base_lr`` at ``total``; ``step`` is a tensor."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr
