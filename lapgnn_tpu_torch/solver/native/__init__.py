"""ctypes bindings for the port's copy of the native lapx solver (``lapx.cpp``).

The exact float64 Jonker–Volgenant solver that the hybrid path runs on the
host, and the dual repair of the device path's certificate.  ``lapx.cpp`` is the port's own copy of
``lapgnn_tpu/solver/native/lapx.cpp``; it is built with ``g++ -O3
-march=native`` at first use into the repository's ``build/native/``, so it
is never shared with the JAX package's cache.
"""

from __future__ import annotations

import ctypes
import platform
import shutil
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..._build import BuildError, SharedLibrary

__all__ = ["lapjv_native", "lapjv_seeded_native", "repair_duals_native", "NativeSolveError"]


class NativeSolveError(RuntimeError):
    pass


def _gxx_command() -> List[str]:
    gxx = shutil.which("g++")
    if gxx is None:
        raise BuildError("g++ not found")
    # -march=native: the host tag keeps one machine's binary from being
    # loaded on another through the hash in the file name.
    return [gxx, "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
            f"-DLAPGNN_HOST={platform.machine()}-{platform.processor() or 'cpu'}"]


def _bind(lib: ctypes.CDLL) -> None:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.lapx_dense.restype = ctypes.c_int
    lib.lapx_dense.argtypes = [ctypes.c_int, f64p, i32p, i32p, f64p, f64p]
    lib.lapx_seeded.restype = ctypes.c_int
    lib.lapx_seeded.argtypes = [
        ctypes.c_int, f64p, f64p, f64p, ctypes.c_double, i32p, i32p, i32p,
        f64p, f64p, ctypes.c_int,
    ]
    lib.lapx_repair_duals.restype = ctypes.c_int
    lib.lapx_repair_duals.argtypes = [
        ctypes.c_int, f64p, i32p, f64p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_double),
    ]


LIBRARY = SharedLibrary(Path(__file__).with_name("lapx.cpp"), "native", _gxx_command, _bind)


def _lib() -> ctypes.CDLL:
    try:
        return LIBRARY.load()
    except (BuildError, OSError) as exc:
        raise NativeSolveError(f"native build failed: {exc}") from exc


def _square(C: np.ndarray, what: str) -> np.ndarray:
    C = np.ascontiguousarray(C, dtype=np.float64)
    if C.ndim != 2 or C.shape[0] != C.shape[1]:
        raise ValueError(f"{what} expects a square matrix")
    return C


def lapjv_native(C: np.ndarray, return_duals: bool = False):
    """Cold optimal solve. Returns (col_of_row, row_of_col, cost[, u, v])."""
    C = _square(C, "lapjv_native")
    n = C.shape[0]
    x = np.empty(n, np.int32)
    y = np.empty(n, np.int32)
    u = np.empty(n, np.float64)
    v = np.empty(n, np.float64)
    rc = _lib().lapx_dense(n, C, x, y, u, v)
    if rc != 0:
        raise NativeSolveError(f"lapx_dense failed with code {rc}")
    cost = float(C[np.arange(n), x].sum())
    if return_duals:
        return x, y, cost, u, v
    return x, y, cost


_GATES = {"density": 0, "free_rows": 1, "never": 2, "both": 3}


def lapjv_seeded_native(
    C: np.ndarray,
    u_seed: np.ndarray,
    v_seed: np.ndarray,
    eps: float = 1e-12,
    return_info: bool = False,
    gate: str = "density",
):
    """Warm-started exact solve. Returns (col_of_row, row_of_col, cost[, info]).

    ``gate`` selects the cold-fallback criterion: "density" (the 1.2n rule),
    "free_rows" (more than half the rows free after the greedy phase),
    "both" (cold only when both say so), "never"."""
    C = _square(C, "lapjv_seeded_native")
    n = C.shape[0]
    u_seed = np.ascontiguousarray(u_seed, dtype=np.float64)
    v_seed = np.ascontiguousarray(v_seed, dtype=np.float64)
    if u_seed.shape != (n,) or v_seed.shape != (n,):
        # a short seed would be an out-of-bounds read in the C++
        raise ValueError(f"seed shapes {u_seed.shape}/{v_seed.shape} must be ({n},)")
    if gate not in _GATES:
        raise ValueError(f"gate must be one of {sorted(_GATES)}")
    x = np.empty(n, np.int32)
    y = np.empty(n, np.int32)
    fb = np.zeros(1, np.int32)
    u = np.empty(n, np.float64)
    v = np.empty(n, np.float64)
    rc = _lib().lapx_seeded(n, C, u_seed, v_seed, float(eps), x, y, fb, u, v, _GATES[gate])
    if rc != 0:
        raise NativeSolveError(f"lapx_seeded failed with code {rc}")
    cost = float(C[np.arange(n), x].sum())
    if return_info:
        return x, y, cost, {"used_fallback": bool(fb[0]), "u": u, "v": v}
    return x, y, cost


def repair_duals_native(
    C: np.ndarray,
    col_of_row: np.ndarray,
    v0: np.ndarray,
    max_scans: int = 0,
) -> Optional[Tuple[np.ndarray, float]]:
    """Warm-started exact dual repair of a candidate optimal assignment.

    Drives ``v0`` to the min-plus fixpoint of the difference constraints the
    assignment induces on the true matrix ``C`` (heap-ordered label
    correcting, ``lapx.cpp:lapx_repair_duals``).  Returns ``(v, min_red)``:
    with ``u_i = C[i, x_i] - v[x_i]``, (u, v) is tight on the assignment, so
    ``min_red >= -tol`` certifies it ``tol``-optimal with a zero
    complementary-slackness gap.  Returns ``None`` when the relaxation budget
    (``max_scans`` column scans, 64 n when 0) runs out, the sign of a
    suboptimal assignment; raises on malformed inputs."""
    C = _square(C, "repair_duals_native")
    n = C.shape[0]
    x = np.ascontiguousarray(col_of_row, np.int32)
    v = np.array(v0, np.float64, copy=True, order="C")
    if x.shape != (n,) or v.shape != (n,):
        raise ValueError(f"x/v shapes {x.shape}/{v.shape} must be ({n},)")
    min_red = ctypes.c_double(float("nan"))
    rc = _lib().lapx_repair_duals(n, C, x, v, int(max_scans), ctypes.byref(min_red))
    if rc == -1:
        return None
    if rc != 0:
        raise NativeSolveError(f"lapx_repair_duals failed with code {rc}")
    return v, float(min_red.value)
