"""Solver perf-regression bench: every in-repo solver against SciPy.

Port of ``lapgnn_tpu/bench/regression.py``: a fixed grid of (size, family)
cells timed with the rigorous harness, emitted as one JSON document to diff
between commits: SciPy, native cold (lapx_dense), native seeded (oracle duals
at two noise levels), sparse CSR (both find-path strategies) and, with
``--device``, the port's seeded device solver on the GPU, seeded with the
min-trick column duals of kernel K2 (``ops.dual.min_trick``).

Run:  python -m lapgnn_tpu_torch.bench.regression --sizes 256 1024 --output logs/...
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def _time(fn, repeats: int = 5, warmups: int = 1) -> float:
    """Median seconds through the shared harness; raises on a failed
    measurement so that a broken solver is loud in the grid."""
    from .harness import time_rigorous

    stats = time_rigorous(fn, warmups=warmups, repeats=repeats)
    if not stats["success"]:
        raise RuntimeError(f"measurement failed: {stats.get('error')}")
    return stats["median"]


def run_regression(sizes, families, repeats=5, include_device=False, seed=0, device=None):
    """The grid's cells, ``{f"{family}_{n}": {timing key: ms or ratio}}``.
    ``include_device`` adds ``device_seeded_ms``, the seeded float32 solve on
    ``device`` (the GPU unless given)."""
    import scipy.optimize

    from ..data.generators import FAMILIES
    from ..ops.host_dual import oracle_duals_np
    from ..solver import native

    rng = np.random.default_rng(seed)
    out = {}
    for n in sizes:
        for fam in families:
            C = FAMILIES[fam](n, rng)
            cell = {}
            t_scipy = _time(
                lambda: scipy.optimize.linear_sum_assignment(C), repeats
            )
            cell["scipy_ms"] = round(t_scipy * 1e3, 3)

            t_cold = _time(lambda: native.lapjv_native(C), repeats)
            cell["lapx_dense_ms"] = round(t_cold * 1e3, 3)
            cell["lapx_dense_vs_scipy"] = round(t_scipy / t_cold, 3)

            u, v = oracle_duals_np(C)
            for noise in (0.0, 0.1):
                un = u + rng.normal(0, noise, n) if noise else u
                t_seed = _time(
                    lambda: native.lapjv_seeded_native(C, un, v, gate="both"),
                    repeats,
                )
                key = f"lapx_seeded_noise{noise:g}"
                cell[f"{key}_ms"] = round(t_seed * 1e3, 3)
                cell[f"{key}_vs_scipy"] = round(t_scipy / t_seed, 3)

            # Sparse CSR on a thresholded copy (the 30% cheapest entries kept).
            thresh = np.quantile(C, 0.3)
            Cs = np.where(C <= thresh, C, 1e6)
            np.fill_diagonal(Cs, np.minimum(C.diagonal(), thresh))  # feasible
            rp, ci, vals = native.sparse_from_dense(Cs, 1e5)
            for fp in (1, 2):
                t_sp = _time(
                    lambda: native.lapmod_native(n, rp, ci, vals, fp_version=fp),
                    repeats,
                )
                cell[f"lapmod_fp{fp}_ms"] = round(t_sp * 1e3, 3)

            if include_device:
                cell["device_seeded_ms"] = round(_time_device(C, u, repeats, device) * 1e3, 3)

            out[f"{fam}_{n}"] = cell
    return out


def _time_device(C, u, repeats, device):
    """Median seconds of the seeded float32 device solve (gate 'both') from
    the row duals ``u`` and their min-trick column duals; each solve ends in
    a read of its cost, which waits for the device."""
    import torch

    from ..device import resolve_device
    from ..ops import dual as dual_ops
    from ..solver.seeded import lapjv_seeded_single

    dev = resolve_device(device)
    Cd = torch.from_numpy(np.ascontiguousarray(C)).to(dev, torch.float32)
    ud = torch.from_numpy(np.ascontiguousarray(u)).to(dev, torch.float32)
    with torch.inference_mode():
        vd = dual_ops.min_trick(Cd, ud)
        return _time(
            lambda: lapjv_seeded_single(Cd, ud, vd, gate="both").cost.item(), repeats
        )


def run_real(files, repeats=5):
    """Bench parsed real instances (OR-Library, SuiteSparse, STRING formats)
    end to end, with SciPy's optimum held against the native cold solve."""
    import scipy.optimize

    from ..data.processors import iter_real_instances, normalize_cost_matrix
    from ..ops.host_dual import oracle_duals_np
    from ..solver import native

    out = {}
    for inst in iter_real_instances([Path(f) for f in files]):
        C = normalize_cost_matrix(inst.cost)
        n = C.shape[0]
        cell = {"n": n, "source": inst.source}
        t_scipy = _time(lambda: scipy.optimize.linear_sum_assignment(C), repeats)
        cell["scipy_ms"] = round(t_scipy * 1e3, 3)
        t_cold = _time(lambda: native.lapjv_native(C), repeats)
        cell["lapx_dense_ms"] = round(t_cold * 1e3, 3)
        u, v = oracle_duals_np(C)
        t_seed = _time(
            lambda: native.lapjv_seeded_native(C, u, v, gate="both"), repeats
        )
        cell["lapx_seeded_oracle_ms"] = round(t_seed * 1e3, 3)
        cell["seeded_vs_scipy"] = round(t_scipy / t_seed, 3)
        # exactness gate (an explicit raise: a bare assert vanishes under -O)
        _, _, c_cold = native.lapjv_native(C)
        r, cc = scipy.optimize.linear_sum_assignment(C)
        opt = float(C[r, cc].sum())
        if not (abs(c_cold - opt) < 1e-9 * max(1.0, abs(c_cold))):
            raise RuntimeError(f"exactness violated on {inst.name}: {c_cold} vs {opt}")
        out[inst.name] = cell
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--sizes", type=int, nargs="+", default=[256, 1024])
    p.add_argument("--families", nargs="+", default=["uniform", "sparse"])
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--device", action="store_true",
                   help="also time the seeded device solve on the GPU")
    p.add_argument(
        "--real-files", nargs="*", default=None,
        help="real-instance files (default: every fixture under data/real/, "
             "OR-Library .assign, SuiteSparse .mtx, STRING links); pass an "
             "empty list to skip",
    )
    p.add_argument("--output", type=Path, default=None)
    args = p.parse_args(argv)
    res = run_regression(
        args.sizes, args.families, args.repeats, include_device=args.device
    )
    real_files = args.real_files
    if real_files is None:
        real_dir = Path(__file__).resolve().parents[2] / "data" / "real"
        real_files = sorted(str(f) for f in real_dir.glob("*")) if real_dir.is_dir() else []
    if real_files:
        res["real_instances"] = run_real(real_files, args.repeats)
    line = json.dumps(res, indent=2)
    print(line)
    if args.output:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text(line + "\n")
    return res


if __name__ == "__main__":
    main()
