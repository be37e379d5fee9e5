"""PyTorch/CUDA port of the CoLLM system (the JAX reference is
``src/repro``).  Imports torch and numpy only; kernels written by hand
for Hopper live in ``csrc/`` and are built at first use on the card."""
