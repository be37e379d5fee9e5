"""llama3-8b — dense decoder, GQA, 128k vocab.  The paper's own serving
model is LLaMA-3.1-8B, so this arch is the paper-representative cell.

[arXiv:2407.21783; unverified] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256.
"""
from repro_torch.configs.base import Family, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family=Family.DENSE,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    lora=LoRAConfig(targets=("q", "k", "v", "o")),
    source="arXiv:2407.21783; unverified",
)
