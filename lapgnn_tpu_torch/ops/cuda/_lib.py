"""The kernel libraries: one ``.so`` per ``csrc/*.cu``, built with ``nvcc``.

Route: ``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` into a library with a plain C interface, loaded with
``ctypes``.  No ``--use_fast_math``: the feature kernel's entropy channel
(``expf``/``logf``) is held to 2e-5 relative.  The solver's persistent
kernels (S1-S3) also build with ``--fmad=false``: their thresholds round
twice, as the plain versions' do.  Nothing here runs at import;
the build runs at a wrapper's first CUDA call, or when a caller
(``chip_smoke.py``) loads every ``SharedLibrary`` at once from threads.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from functools import partial
from pathlib import Path
from typing import Dict, List

import torch

from ... import tracing
from ..._build import SharedLibrary

__all__ = ["KERNEL_LIBS", "check", "coop_blocks", "launched", "ptr", "stream_ptr"]

CSRC = Path(__file__).resolve().parent.parent.parent / "csrc"


def _nvcc_command(*extra: str) -> List[str]:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    exe = str(nvcc) if nvcc.exists() else shutil.which("nvcc")
    if exe is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return [
        exe, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *extra,
    ]


_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double


def _bind_colmin(lib: ctypes.CDLL) -> None:
    lib.lapgnn_colmin.restype = _I
    lib.lapgnn_colmin.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP]
    lib.lapgnn_colmin_cluster.restype = _I
    lib.lapgnn_colmin_cluster.argtypes = [
        _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _I, _VP,
    ]
    lib.lapgnn_colmin_max_active_clusters.restype = _I
    lib.lapgnn_colmin_max_active_clusters.argtypes = [_I, _I, _I, _I, _I]


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
    lib.lapgnn_two_min_f64.restype = _I
    lib.lapgnn_two_min_f64.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP]


def _bind_greedy(lib: ctypes.CDLL) -> None:
    lib.lapgnn_greedy_total.restype = _I
    lib.lapgnn_greedy_total.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP]


def _bind_augment(lib: ctypes.CDLL) -> None:
    lib.lapgnn_augment_occupancy.restype = _I
    lib.lapgnn_augment_occupancy.argtypes = [_I, _I, _I, _I]
    lib.lapgnn_augment_static_smem.restype = _I
    lib.lapgnn_augment_static_smem.argtypes = [_I, _I]
    lib.lapgnn_augment_work_bytes.restype = _LL
    lib.lapgnn_augment_work_bytes.argtypes = [_I, _I, _I]
    lib.lapgnn_augment.restype = _I
    lib.lapgnn_augment.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP]
    lib.lapgnn_augment_f64.restype = _I
    lib.lapgnn_augment_f64.argtypes = [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _D, _VP]
    lib.lapgnn_augment_barrier_work_bytes.restype = _LL
    lib.lapgnn_augment_barrier_work_bytes.argtypes = []
    lib.lapgnn_augment_barrier_bench.restype = _I
    lib.lapgnn_augment_barrier_bench.argtypes = [_I, _I, _I, _I, _VP, _VP]


def _bind_arr(lib: ctypes.CDLL) -> None:
    lib.lapgnn_arr_occupancy.restype = _I
    lib.lapgnn_arr_occupancy.argtypes = [_I, _I, _I, _I]
    lib.lapgnn_arr_static_smem.restype = _I
    lib.lapgnn_arr_static_smem.argtypes = [_I, _I]
    lib.lapgnn_arr_work_bytes.restype = _LL
    lib.lapgnn_arr_work_bytes.argtypes = [_I, _I]
    lib.lapgnn_arr.restype = _I
    lib.lapgnn_arr.argtypes = [*[_VP] * 10, _I, _I, _F, _I, _I, _I, _I, _VP]
    lib.lapgnn_arr_f64.restype = _I
    lib.lapgnn_arr_f64.argtypes = [*[_VP] * 10, _I, _I, _D, _I, _I, _I, _VP]


def _bind_greedy_match(lib: ctypes.CDLL) -> None:
    lib.lapgnn_greedy_match_occupancy.restype = _I
    lib.lapgnn_greedy_match_occupancy.argtypes = [_I]
    lib.lapgnn_greedy_match_static_smem.restype = _I
    lib.lapgnn_greedy_match_static_smem.argtypes = []
    lib.lapgnn_greedy_match_work_bytes.restype = _LL
    lib.lapgnn_greedy_match_work_bytes.argtypes = [_I]
    lib.lapgnn_greedy_match.restype = _I
    lib.lapgnn_greedy_match.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _VP]


def _bind_sinkhorn(lib: ctypes.CDLL) -> None:
    lib.lapgnn_sinkhorn_occupancy.restype = _I
    lib.lapgnn_sinkhorn_occupancy.argtypes = [_I, _I, _I]
    lib.lapgnn_sinkhorn_static_smem.restype = _I
    lib.lapgnn_sinkhorn_static_smem.argtypes = []
    lib.lapgnn_sinkhorn_work_bytes.restype = _LL
    lib.lapgnn_sinkhorn_work_bytes.argtypes = [_I, _I, _I]
    lib.lapgnn_sinkhorn_ladder_offset.restype = _LL
    lib.lapgnn_sinkhorn_ladder_offset.argtypes = []
    lib.lapgnn_sinkhorn.restype = _I
    lib.lapgnn_sinkhorn.argtypes = [*[_VP] * 7, ctypes.POINTER(_F), _I, _I, _I, _I, _I, _I,
                                    _I, _I, _VP]


def _bind_dual_edge(lib: ctypes.CDLL) -> None:
    lib.lapgnn_dual_edge.restype = _I
    lib.lapgnn_dual_edge.argtypes = [*[_VP] * 8, _LL, _I, _I, _VP]


_TWOMIN_H = CSRC / "twomin.cuh"
_BARRIER_H = CSRC / "grid_barrier.cuh"
_ROUNDS_H = CSRC / "free_rows.cuh"
_SOLVER_FLAGS = partial(_nvcc_command, "--fmad=false")

KERNEL_LIBS: Dict[str, SharedLibrary] = {
    "colmin": SharedLibrary(CSRC / "colmin.cu", "kernels", _nvcc_command, _bind_colmin),
    "features": SharedLibrary(
        CSRC / "features.cu", "kernels", _nvcc_command, _bind_features
    ),
    "twomin": SharedLibrary(
        CSRC / "twomin.cu", "kernels", _nvcc_command, _bind_twomin, deps=[_TWOMIN_H]
    ),
    "greedy": SharedLibrary(CSRC / "greedy.cu", "kernels", _nvcc_command, _bind_greedy),
    "augment": SharedLibrary(
        CSRC / "augment.cu", "kernels", _SOLVER_FLAGS, _bind_augment,
        deps=[_TWOMIN_H, _BARRIER_H],
    ),
    "arr": SharedLibrary(
        CSRC / "arr.cu", "kernels", _SOLVER_FLAGS, _bind_arr,
        deps=[_TWOMIN_H, _BARRIER_H, _ROUNDS_H],
    ),
    "greedy_match": SharedLibrary(
        CSRC / "greedy_match.cu", "kernels", _SOLVER_FLAGS, _bind_greedy_match,
        deps=[_BARRIER_H, _ROUNDS_H],
    ),
    "sinkhorn": SharedLibrary(
        CSRC / "sinkhorn.cu", "kernels", _nvcc_command, _bind_sinkhorn, deps=[_BARRIER_H]
    ),
    "dual_edge": SharedLibrary(CSRC / "dual_edge.cu", "kernels", _nvcc_command, _bind_dual_edge),
}


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {rc}")


def launched(rc: int, what: str, wrapper: str) -> None:
    """After a wrapper's kernel launch: raise on a CUDA error, else count the
    launch once, in the tracer's counter ``launch.<wrapper>``."""
    check(rc, what)
    tracing.count(f"launch.{wrapper}")


def coop_blocks(occupancy: int, sms: int, work_blocks: int, per_sm: int = 2) -> int:
    """Blocks of a cooperative launch: every block must be resident at once,
    so at most ``occupancy`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    for the kernel's threads and shared memory) times the SM count; at most
    ``per_sm`` a SM, since every block joins every grid sync and the solver
    kernels' passes are short; and no more than ``work_blocks``, the blocks
    the problem has work for.  An occupancy below 1 (a kernel the card
    cannot hold, or a CUDA error as its negative) raises."""
    if occupancy < 1:
        raise RuntimeError(f"the card holds no block of this cooperative kernel ({occupancy})")
    return max(1, min(sms * min(occupancy, per_sm), work_blocks))


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
