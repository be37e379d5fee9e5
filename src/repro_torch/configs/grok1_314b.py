"""grok-1-314b — MoE, 8 experts top-2.

[hf:xai-org/grok-1; unverified] 64L d_model=6144 48H (GQA kv=8)
d_ff=32768 vocab=131072, MoE 8e top-2.

Sharding note: 8 experts do not divide the 16-way model axis, so expert
weights are sharded expert-wise 8-way x ff-wise 2-way ("tp" hybrid); see
launch/mesh.py sharding rules.
"""
from repro_torch.configs.base import Family, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family=Family.MOE,
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    top_k=2,
    moe_shard="tp",
    lora=LoRAConfig(targets=("q", "k", "v", "o")),
    source="hf:xai-org/grok-1; unverified",
)
