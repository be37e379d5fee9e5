"""Load weights given as numpy arrays into the port's tensor trees.

The JAX ``Model.init`` / ``init_lora`` trees, turned into numpy leaf for
leaf by the caller, have exactly the port's layout (nested dicts,
stacked ``[L, ...]`` block leaves, ``[in, out]`` matrices), so loading
is a per-leaf conversion that keeps dtypes: params in
``cfg.param_dtype`` except the leaves the JAX init keeps in float32 (the
SSM's ``A_log``, ``D_skip``, ``dt_bias``, in the SSM and hybrid blocks
alike; a VLM cross block's ``gate_attn``, ``gate_mlp``; an MoE block's
``router``), LoRA pairs in float32.  The tree goes through
``mamba2.pad_storage``, as ``Model.init``'s does.  A VLM's
``[units, per, ...]`` blocks and ``[units, ...]`` cross blocks convert
leaf for leaf like any other stack, and so does an encoder's tree (dense
blocks, its embedding table and frame classifier head).  An AdamW
state (step, m, v) converts the same way, so a test can carry a JAX
optimizer state across.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba2 import FLOAT32_LEAVES, pad_storage
from repro_torch.models.moe import MOE_FLOAT32_LEAVES
from repro_torch.models.transformer import CROSS_FLOAT32_LEAVES
from repro_torch.optim.adamw import AdamWState


def _tensor(arr: Any, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":          # ml_dtypes; torch can't wrap it
        a = a.astype(np.float32)
    # a copy: the source may be a read-only view of the caller's array
    return torch.tensor(a, dtype=dtype, device=device)


def _tree(tree: Any, dtype: torch.dtype, device, keep=()) -> Any:
    """Leaves to ``dtype``, but leaves named in ``keep`` to float32."""
    if isinstance(tree, dict):
        return {k: _tensor(v, torch.float32, device) if k in keep
                else _tree(v, dtype, device, keep) for k, v in tree.items()}
    return _tensor(tree, dtype, device)


def params_from_numpy(cfg: ModelConfig, tree: Dict, device="cuda") -> Dict:
    """A JAX params tree (numpy leaves) -> the port's params, in
    ``cfg.param_dtype`` on ``device`` (the SSM's, the cross blocks' and
    the MoE router's float32 leaves stay float32)."""
    return pad_storage(_tree(tree, getattr(torch, cfg.param_dtype),
                             torch.device(device),
                             keep=FLOAT32_LEAVES + CROSS_FLOAT32_LEAVES
                             + MOE_FLOAT32_LEAVES))


def lora_from_numpy(tree: Dict, device="cuda") -> Dict:
    """A JAX LoRA tree (numpy leaves) -> the port's, float32."""
    return _tree(tree, torch.float32, torch.device(device))


def opt_state_from_numpy(state: Any, device="cuda") -> AdamWState:
    """A JAX ``AdamWState`` (numpy leaves, or anything with ``step``,
    ``m`` and ``v``) -> the port's: int32 step, float32 moments."""
    dev = torch.device(device)
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        m=_tree(state.m, torch.float32, dev),
        v=_tree(state.v, torch.float32, dev))
