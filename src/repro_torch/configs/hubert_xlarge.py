"""hubert-xlarge — encoder-only audio backbone (same arch as wav2vec2).

[arXiv:2106.07447; unverified] 48L d_model=1280 16H (GQA kv=16) d_ff=5120
vocab=504 (k-means codebook units -> frame classifier head).
The audio frontend (conv feature extractor) is a STUB: ``input_specs()``
provides precomputed frame embeddings.
"""
from repro_torch.configs.base import Family, LoRAConfig, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family=Family.ENCODER,
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    encoder_only=True,
    lora=LoRAConfig(targets=("q", "k", "v", "o")),
    source="arXiv:2106.07447; unverified",
)
