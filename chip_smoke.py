#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``lapgnn_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases; any failure exits non-zero without the final ``ok`` line:
  1. Device and build: the card's name and power limit, then every kernel
     (one ``nvcc`` per ``csrc/*.cu``) and the native host solver (``g++``),
     built together from the checkout into ``build/``.
  2. Kernels against their plain PyTorch versions at n = 1000, 2048 and 8192
     on a (uniform, tie) batch of two: K1 column min and K2 min-trick must
     match bit for bit, K3 row-feature statistics within rtol 2e-5 / atol 2e-6.
  3. End to end: ``WarmStartPipeline(mode="hybrid", seed_mode="auto",
     normalize_costs=True)`` with ``artifacts/one_gnn_default`` (OneGNN,
     hidden 192, 4 layers, top-k 16) solves one instance of each of four
     families at n = 2048 with ``certify=True``.  Each optimal cost must equal
     SciPy's (float64, 1e-12 relative) and pass the port's certificate, and
     the kernel launch counters, zeroed just before, must show that the path
     ran K3 and K1 at least once and K2 at least twice per instance.
  4. Times: the end-to-end predict and host-solve time per instance, the
     predict's stages and the device's busy share under torch.profiler, and
     each kernel and its plain version at n = 2048 and 8192 (median of
     CUDA-event timings after warm-up, L2 flushed before each launch) beside
     its bound: the larger of the bytes it must move over the HBM rate and
     the float32 operations it must do over the card's float32 rate.

Output: a JSON line per phase, then the kernels' JSON line, the card's
``nvidia-smi`` name and power limit, and as the last line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX or of the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

# H100 SXM data-sheet peaks (dense, no sparsity), at a 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

K3_RTOL, K3_ATOL = 2e-5, 2e-6
N_E2E = 2048
FAMILIES_E2E = ("uniform", "noisy_linear", "sparse", "tie")
COMPARE_SIZES = (1000, 2048, 8192)

KERNELS = {
    "col_min": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/colmin.cu",
        "replaces": "lapgnn_tpu/ops/pallas/colmin.py:75",
    },
    "min_trick": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/colmin.cu",
        "replaces": "lapgnn_tpu/ops/pallas/colmin.py:94",
    },
    "row_features_stats": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/features.cu",
        "replaces": "lapgnn_tpu/ops/pallas/features.py:193",
    },
}


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def _bound_ms(name: str, B: int, n: int, m: int):
    """Least time for the function on these inputs: each input read once and
    each output written once over the HBM rate, against its float32
    operations over the float32 rate.  K1 does one compare per element, K2 a
    subtract and a compare.  K3's float32 work (moments, entropy) is a few
    operations per element, far below its bytes time; its exact selections
    are integer compares whose count depends on the selection algorithm and
    which the rate table does not cover, so K3 is held to the bytes bound."""
    f32 = 4
    if name == "col_min":
        nbytes, ops = B * n * m * f32 + B * m * f32, B * n * m
    elif name == "min_trick":
        nbytes, ops = B * n * m * f32 + B * n * f32 + B * m * f32, 2 * B * n * m
    else:
        nbytes, ops = B * n * m * f32 + B * n * 13 * f32, 0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build(torch):
    """Build every library at once, one compiler process each."""
    from concurrent.futures import ThreadPoolExecutor

    from lapgnn_tpu_torch.ops.cuda._lib import KERNEL_LIBS
    from lapgnn_tpu_torch.solver.native import LIBRARY

    libs = dict(KERNEL_LIBS, native=LIBRARY)

    def timed_load(lib):
        t = time.perf_counter()
        lib.load()
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        seconds = dict(zip(libs, pool.map(timed_load, libs.values())))
    for name in KERNEL_LIBS:
        log = KERNEL_LIBS[name].path.with_suffix(".log")
        for line in (log.read_text() if log.exists() else "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "per_library_seconds": seconds})


def _batch(torch, n, seed, fams=("uniform", "tie")):
    import numpy as np

    from lapgnn_tpu_torch.data.generators import FAMILIES

    rng = np.random.default_rng(seed)
    C = np.stack([FAMILIES[f](n, rng).astype(np.float32) for f in fams])
    return torch.from_numpy(C).cuda()


def phase_compare(torch, seed):
    from lapgnn_tpu_torch.ops import features
    from lapgnn_tpu_torch.ops.cuda import col_min, min_trick, row_features_stats
    from lapgnn_tpu_torch.ops.cuda.colmin import col_min_plain, min_trick_plain
    from lapgnn_tpu_torch.ops.cuda.features import row_features_stats_plain

    errs = {name: 0.0 for name in KERNELS}
    detail = []
    for n in COMPARE_SIZES:
        C = _batch(torch, n, seed + n)
        g = torch.Generator(device="cuda").manual_seed(seed + n)
        u = torch.randn((2, n), generator=g, device="cuda") * 0.3
        k1, p1 = col_min(C), col_min_plain(C)
        k2, p2 = min_trick(C, u), min_trick_plain(C, u)
        k3, p3 = row_features_stats(C), row_features_stats_plain(C, col_min_plain(C))
        sort_path = features.row_features(C)[..., :13]
        torch.cuda.synchronize()
        if not torch.equal(k1.view(torch.int32), p1.view(torch.int32)):
            raise AssertionError(f"col_min differs from amin at n={n}")
        if not torch.equal(k2.view(torch.int32), p2.view(torch.int32)):
            raise AssertionError(f"min_trick differs from its plain version at n={n}")
        if not torch.isfinite(k3).all():
            raise AssertionError(f"row_features_stats is not finite at n={n}")
        torch.testing.assert_close(k3, p3, rtol=K3_RTOL, atol=K3_ATOL)
        e3 = float((k3 - p3).abs().max())
        errs["col_min"] = max(errs["col_min"], float((k1 - p1).abs().max()))
        errs["min_trick"] = max(errs["min_trick"], float((k2 - p2).abs().max()))
        errs["row_features_stats"] = max(errs["row_features_stats"], e3)
        rel = ((k3 - sort_path).abs() / (sort_path.abs() + K3_ATOL / K3_RTOL)).amax((0, 1))
        detail.append({"n": n, "k3_max_abs_err": e3,
                       "k3_vs_sort_path_max_rel_per_channel": [float(x) for x in rel]})
    _emit({"phase": "compare", "max_abs_err": errs, "detail": detail})
    return errs


def phase_e2e(torch, seed):
    import numpy as np
    import scipy.optimize

    from lapgnn_tpu_torch.data.generators import FAMILIES
    from lapgnn_tpu_torch.ops.cuda import WRAPPERS, col_min, min_trick, row_features_stats
    from lapgnn_tpu_torch.pipeline import WarmStartPipeline
    from lapgnn_tpu_torch.solver.native import lapjv_native, lapjv_seeded_native
    from lapgnn_tpu_torch.solver.verification import certify_assignment
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint

    params, meta, _ = load_checkpoint(Path(__file__).resolve().parent / "artifacts" / "one_gnn_default")
    pipe = WarmStartPipeline(
        build_model_from_meta(meta), params, mode="hybrid", seed_mode="auto",
        normalize_costs=True,
    )
    n = N_E2E
    rng = np.random.default_rng(seed)
    costs = {f: FAMILIES[f](n, rng).astype(np.float32) for f in FAMILIES_E2E}

    for w in WRAPPERS:
        w.launches = 0
    results = {f: pipe.solve(C, certify=True) for f, C in costs.items()}
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in WRAPPERS}

    per = len(costs)
    if row_features_stats.launches < per or col_min.launches < per or min_trick.launches < 2 * per:
        raise AssertionError(f"the main path skipped a kernel: launches {launches}")
    report = {}
    for f, C in costs.items():
        out = results[f]
        C64 = C.astype(np.float64)
        r, c = scipy.optimize.linear_sum_assignment(C64)
        opt = float(C64[r, c].sum())
        got = float(out["cost"][0])
        if not abs(got - opt) <= 1e-12 * max(1.0, abs(opt)):
            raise AssertionError(f"{f}: cost {got!r} != SciPy {opt!r}")
        _, _, _, _, v_opt = lapjv_native(C64, return_duals=True)
        ok, viol, _ = certify_assignment(C64, out["col_of_row"][0], v_opt)
        if not (ok and out["certified"].all()):
            raise AssertionError(f"{f}: certificate failed (violation {viol})")

        # times per instance, outside the counted run: predict on the card
        # (host clock around work ending in a synchronize), then the host solve
        predict_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u, v = pipe.predict_duals(C)
            torch.cuda.synchronize()
            predict_ms.append((time.perf_counter() - t0) * 1e3)
        uv = torch.stack([u, v], 1).cpu().numpy().astype(np.float64)
        t0 = time.perf_counter()
        x, _, c_host, info = lapjv_seeded_native(
            C64, uv[0, 0], uv[0, 1], eps=pipe.eps, gate=pipe.gate, return_info=True
        )
        host_ms = (time.perf_counter() - t0) * 1e3
        if c_host != got:
            raise AssertionError(f"{f}: the timed host solve gave another cost")
        report[f] = {"cost": got, "scipy_cost": opt, "used_fallback": bool(out["used_fallback"][0]),
                     "predict_ms_median": statistics.median(predict_ms),
                     "host_solve_ms": host_ms}
    _emit({"phase": "e2e", "n": n, "launches": launches, "instances": report})
    return launches, pipe, costs["uniform"]


def _time_ms(torch, fn, reps, flush):
    """Median CUDA-event time of ``fn`` with L2 flushed before each launch."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_times(torch, seed):
    from lapgnn_tpu_torch.ops.cuda import col_min, min_trick, row_features_stats
    from lapgnn_tpu_torch.ops.cuda.colmin import col_min_plain, min_trick_plain
    from lapgnn_tpu_torch.ops.cuda.features import row_features_stats_plain

    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")
    out = {}
    for n in (2048, 8192):
        C = _batch(torch, n, seed + 7 * n, fams=("uniform",))
        u = torch.randn((1, n), device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed)) * 0.3
        cm = col_min_plain(C)
        reps = 20 if n == 2048 else 10
        fns = {
            "col_min": (lambda: col_min(C), lambda: col_min_plain(C), lambda: torch.amin(C, dim=-2)),
            "min_trick": (lambda: min_trick(C, u), lambda: min_trick_plain(C, u), None),
            "row_features_stats": (
                lambda: row_features_stats(C),
                lambda: row_features_stats_plain(C, cm),
                None,
            ),
        }
        for name, (kern, plain, lib) in fns.items():
            bound, by = _bound_ms(name, 1, n, n)
            out.setdefault(name, {})[n] = {
                "ms": _time_ms(torch, kern, reps, flush),
                "plain_ms": _time_ms(torch, plain, max(3, reps // 4), flush),
                "library_ms": None if lib is None else _time_ms(torch, lib, reps, flush),
                "bound_ms": bound,
                "bound_by": by,
            }
    _emit({"phase": "times", "batch": 1, "kernels": out})
    return out


def phase_breakdown(torch, pipe, C_np):
    """Where one predict's time goes at the e2e size (uniform instance):
    each stage timed alone with CUDA events (median of 5 after warm-up), and
    one whole predict under torch.profiler for the device's busy share and
    its heaviest kernels."""
    from lapgnn_tpu_torch.ops.dual import robust_normalize
    from lapgnn_tpu_torch.ops.features import fast_row_features
    from lapgnn_tpu_torch.ops.sinkhorn import auto_select_seed

    cost = torch.from_numpy(C_np).cuda()[None]
    with torch.inference_mode():
        cn, mn, a = robust_normalize(cost)
        feats = fast_row_features(cn)
        u = pipe.model(feats, cost=cn)["u"] * a[..., None] + mn[..., None]
        stages = {
            "normalize": lambda: robust_normalize(cost),
            "features_k3_k1": lambda: fast_row_features(cn),
            "model": lambda: pipe.model(feats, cost=cn),
            "seed_policy_auto": lambda: auto_select_seed(cost, u),
            "predict_total": lambda: pipe.predict_duals(cost),
        }
        no_flush = torch.empty(1, device="cuda")
        stage_ms = {k: _time_ms(torch, fn, 5, no_flush) for k, fn in stages.items()}

        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipe.predict_duals(cost)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        # kernel events only: an aten op's device time repeats its kernels'
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                rows.append((dev_us, evt.key, evt.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    _emit({
        "phase": "breakdown", "n": C_np.shape[-1], "stage_ms": stage_ms,
        "profiled_predict_wall_ms": wall_ms,
        "device_busy_ms": busy_ms if rows else "not measured",
        "device_idle_share": (1.0 - busy_ms / wall_ms) if rows else "not measured",
        "top_kernels": [{"name": k[:80], "device_ms": d / 1e3, "count": c} for d, k, c in rows[:8]],
    })


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    try:
        import lapgnn_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port ({exc}); run it from the "
              "repository root", file=sys.stderr)
        return 1

    card = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    _emit({"torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0]})
    try:
        phase_build(torch)
        errs = phase_compare(torch, args.seed)
        launches, pipe, c_uniform = phase_e2e(torch, args.seed)
        phase_breakdown(torch, pipe, c_uniform)
        times = phase_times(torch, args.seed)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    kernels = []
    for kname, info in KERNELS.items():
        t = times[kname]
        kernels.append({
            "name": kname, **info,
            "launches": launches[kname],
            "max_abs_err": errs[kname],
            "n": N_E2E,
            **t[N_E2E],
            "at_n_8192": t[8192],
            "card": card,
        })
    _emit({"kernels": kernels})
    print(card, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
