"""Architecture registry: ``--arch <id>`` resolution for the port.

The ids are the JAX package's, every one of them ported: the four dense
decoders, the Mamba2 SSM, the hybrid hymba-1.5b, the encoder-only
hubert-xlarge, the llama-3.2-vision VLM and the two MoE stacks
(moonshot-v1-16b-a3b, grok-1-314b); their config files are copies of
the JAX ones.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (
    grok1_314b, hubert_xlarge, hymba_1_5b, internlm2_1_8b,
    llama3_2_vision_90b, llama3_8b, mamba2_780m, moonshot_v1_16b_a3b,
    qwen1_5_0_5b, qwen3_14b,
)
from repro_torch.configs.base import ModelConfig

_REGISTRY: Dict[str, ModelConfig] = {
    "qwen1.5-0.5b": qwen1_5_0_5b.CONFIG,
    "qwen3-14b": qwen3_14b.CONFIG,
    "internlm2-1.8b": internlm2_1_8b.CONFIG,
    "llama3-8b": llama3_8b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "hubert-xlarge": hubert_xlarge.CONFIG,
    "llama-3.2-vision-90b": llama3_2_vision_90b.CONFIG,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.CONFIG,
    "grok-1-314b": grok1_314b.CONFIG,
}

ARCH_IDS = tuple(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    try:
        return _REGISTRY[arch]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch!r}; available: {', '.join(ARCH_IDS)}"
        ) from None
