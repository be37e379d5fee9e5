"""Tenant adapters for multi-tenant serving — the one piece of
``repro.runtime.fabric`` the port has so far (the replica fabric is a
later slice)."""
from __future__ import annotations

from typing import Any, List

import torch


def make_tenant_adapters(model, n: int, *, seed: int = 0) -> List[Any]:
    """``n`` distinct tenant LoRA trees on the model's device.

    A fresh adapter has ``b = 0`` (a no-op), which would make every tenant
    serve the base model's tokens, so tenants t >= 1 draw a nonzero ``b``
    per target at scale 0.5 (much smaller perturbations shift the logits
    without flipping an argmax on small configs).  Tenant 0 keeps the
    no-op init: it is the co-training tenant.  Tenant t draws from its
    own ``torch.Generator`` seeded ``seed + 101 * t``, ``a`` first, then
    each target's ``b`` in sorted target order."""
    out = []
    for t in range(n):
        gen = torch.Generator(device=model.device).manual_seed(seed + 101 * t)
        tree = model.init_lora(gen)
        if t > 0:
            for tgt in sorted(tree):
                b = tree[tgt]["b"]
                tree[tgt]["b"] = 0.5 * torch.randn(
                    b.shape, generator=gen, dtype=b.dtype, device=b.device)
        out.append(tree)
    return out
