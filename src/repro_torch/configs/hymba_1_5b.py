"""hymba-1.5b — hybrid: parallel attention + mamba heads per layer.

[arXiv:2411.13676; hf] 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16.

Adaptation note (DESIGN.md section 8): attention uses a 2048-token sliding
window in every layer (the published Hymba uses SWA in all but 3 layers plus
meta tokens); this preserves the sub-quadratic property required for the
long_500k cell and keeps the layer stack homogeneous for scan-over-layers.
"""
from repro_torch.configs.base import Family, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family=Family.HYBRID,
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    sliding_window=2048,
    lora=LoRAConfig(targets=("q", "k", "v", "o", "ssm_in", "ssm_out")),
    source="arXiv:2411.13676; hf",
)
