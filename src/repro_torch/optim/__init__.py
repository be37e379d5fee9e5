from repro_torch.optim.adamw import (  # noqa: F401
    AdamW, AdamWState, cosine_schedule, global_norm,
)
from repro_torch.optim.grad_noise import (  # noqa: F401
    NoiseScaleEMA, noise_scale_from_microbatches,
)
