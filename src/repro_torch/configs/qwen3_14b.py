"""qwen3-14b — dense decoder with qk_norm + GQA.

[hf:Qwen/Qwen3-8B; hf] 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, head_dim=128, qk_norm.
"""
from repro_torch.configs.base import Family, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family=Family.DENSE,
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    lora=LoRAConfig(targets=("q", "k", "v", "o")),
    source="hf:Qwen/Qwen3-8B; hf",
)
