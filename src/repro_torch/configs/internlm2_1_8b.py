"""internlm2-1.8b — dense decoder with GQA.

[arXiv:2403.17297; hf] 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544.
"""
from repro_torch.configs.base import Family, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family=Family.DENSE,
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    rope_theta=1_000_000.0,
    lora=LoRAConfig(targets=("q", "k", "v", "o")),
    source="arXiv:2403.17297; hf",
)
