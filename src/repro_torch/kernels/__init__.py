"""Hand-written Hopper kernels (``csrc/``), their builder, wrappers and
plain PyTorch versions."""
