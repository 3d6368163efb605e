"""lapgnn_tpu_torch — the PyTorch / CUDA port of lapgnn_tpu for NVIDIA Hopper.

The JAX package ``lapgnn_tpu`` is the reference; this package keeps its
module layout and names so each counterpart is easy to find, and never
imports it (or JAX).  Every Pallas kernel on a ported path is a CUDA C++
kernel under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use into
the repository's ``build/`` directory, with a plain PyTorch version beside it
that CPU tensors take.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit device they raise instead of falling back.
"""

from __future__ import annotations

import torch

from .device import resolve_device

# The JAX reference computes in full float32; TF32 would keep ~3 decimal
# digits in matrix products and convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]
