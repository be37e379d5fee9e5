from repro_torch.checkpoint.checkpointer import Checkpointer, config_hash  # noqa: F401
