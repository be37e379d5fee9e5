"""llama-3.2-vision-90b — decoder with interleaved cross-attention layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified] 100L d_model=8192 64H
(GQA kv=8) d_ff=28672 vocab=128256.  Every 5th layer cross-attends to
vision tokens; the vision frontend is a STUB (``input_specs()`` provides
precomputed patch embeddings of shape [batch, vision_tokens, d_model]).
"""
from repro_torch.configs.base import Family, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family=Family.VLM,
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    vision_tokens=1601,
    lora=LoRAConfig(targets=("q", "k", "v", "o")),
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
