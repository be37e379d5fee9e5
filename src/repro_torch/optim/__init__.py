from repro_torch.optim.adamw import (  # noqa: F401
    AdamW, AdamWState, cosine_schedule, global_norm,
)
from repro_torch.optim.compression import (  # noqa: F401
    ErrorFeedback, compress_tree_int8, compress_tree_topk, dequantize_int8,
    init_error_feedback, quantize_int8, topk_compress,
)
from repro_torch.optim.grad_noise import (  # noqa: F401
    NoiseScaleEMA, noise_scale_from_microbatches,
)
