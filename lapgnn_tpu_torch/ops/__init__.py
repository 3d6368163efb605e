"""Tensor ops of the port: dual math, features, seed policy, and the
hand-written CUDA kernels under ``ops.cuda``."""
