"""The kernel libraries: one ``.so`` per ``csrc/*.cu``, built with ``nvcc``.

Route: ``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` into a library with a plain C interface, loaded with
``ctypes``.  No ``--use_fast_math``: the feature kernel's entropy channel
(``expf``/``logf``) is held to 2e-5 relative.  Nothing here runs at import;
the build runs at a wrapper's first CUDA call, or when a caller
(``chip_smoke.py``) loads every ``SharedLibrary`` at once from threads.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path
from typing import Dict, List

import torch

from ..._build import SharedLibrary

__all__ = ["KERNEL_LIBS", "check", "ptr", "stream_ptr"]

CSRC = Path(__file__).resolve().parent.parent.parent / "csrc"


def _nvcc_command() -> List[str]:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    exe = str(nvcc) if nvcc.exists() else shutil.which("nvcc")
    if exe is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return [
        exe, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    ]


_VP = ctypes.c_void_p
_I = ctypes.c_int


def _bind_colmin(lib: ctypes.CDLL) -> None:
    lib.lapgnn_colmin.restype = _I
    lib.lapgnn_colmin.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP]


def _bind_features(lib: ctypes.CDLL) -> None:
    lib.lapgnn_row_features_stats.restype = _I
    lib.lapgnn_row_features_stats.argtypes = [_VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP]
    lib.lapgnn_row_features_max_m.restype = _I
    lib.lapgnn_row_features_max_m.argtypes = [_I]


def _bind_twomin(lib: ctypes.CDLL) -> None:
    lib.lapgnn_two_min.restype = _I
    lib.lapgnn_two_min.argtypes = [
        _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP,
    ]


KERNEL_LIBS: Dict[str, SharedLibrary] = {
    "colmin": SharedLibrary(CSRC / "colmin.cu", "kernels", _nvcc_command, _bind_colmin),
    "features": SharedLibrary(
        CSRC / "features.cu", "kernels", _nvcc_command, _bind_features
    ),
    "twomin": SharedLibrary(CSRC / "twomin.cu", "kernels", _nvcc_command, _bind_twomin),
}


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {rc}")
