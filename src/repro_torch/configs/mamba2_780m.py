"""mamba2-780m — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified] 48L d_model=1536 d_ff=0 vocab=50280
ssm_state=128.
"""
from repro_torch.configs.base import Family, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family=Family.SSM,
    n_layers=48,
    d_model=1536,
    n_heads=1,              # unused (attention-free); keeps divisibility
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,                 # mamba2 block has no separate MLP
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    lora=LoRAConfig(targets=("ssm_in", "ssm_out")),
    source="arXiv:2405.21060; unverified",
)
