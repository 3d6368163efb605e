#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``lapgnn_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0] [--phases build,compare,times]

``--phases`` runs a subset (for a first look at a changed kernel) and then
prints no ``ok`` line; with no arguments every phase runs.

Phases; any failure exits non-zero without the final ``ok`` line:
  1. Device and build: the card's name and power limit, then every kernel
     (one ``nvcc`` per ``csrc/*.cu``) and the native host solver (``g++``),
     built together from the checkout into ``build/``.
  2. Kernels against their plain PyTorch versions at n = 1000, 2048 and 8192
     on a (uniform, tie) batch of two: K1 column min, K2 min-trick and K4
     two-min must match bit for bit (K4 also on rows with +-inf and NaN),
     K3 row-feature statistics within rtol 2e-5 / atol 2e-6 with its
     selection channels (min, max, MAD, second-best gap, near-best,
     is-col-best) bit-equal, also on all-equal rows, rows of mixed +-0.0 and
     rows with +-inf.  K3 and K4 again at the ragged shapes their tiling
     must survive: m in {1, 7, 10, 11, 33, 1001}, m = 16384 (eight warps a
     row), m = 20000 (K3's shared-memory path), and a view that starts 4
     bytes into its buffer.
  3. Hybrid end to end: ``WarmStartPipeline(mode="hybrid", seed_mode="auto",
     normalize_costs=True)`` with ``artifacts/one_gnn_default`` (OneGNN,
     hidden 192, 4 layers, top-k 16) solves one instance of each of four
     families at n = 2048 with ``certify=True``; each optimal cost must equal
     SciPy's (float64, 1e-12 relative) and the launch counters, zeroed just
     before, must show K3 and K1 at least once and K2 at least twice per
     instance.  Then the predict's stages and the device's busy share.
  4. Device end to end: the default ``WarmStartPipeline(mode="device", ...)``
     solves the same four families at n = 2048 in float32 on the card and
     certifies each against the float64 matrix on the host; each cost must
     equal SciPy's (1e-12 relative), be certified and not routed to the host,
     and the counters must show K4 in every instance besides K1-K3.  Per
     instance: the certificate's route (raw, repair or polish), predict,
     device-solve and certify times, and the solver's loop and sync counts.
  5. The port's device solver on the card and on the CPU from the same
     float32 input and seeds at n = 512 (uniform, tie): equal assignments,
     bit-equal duals.
  6. Where one device solve's time goes (uniform): its stages, and the
     device's idle share and K4's time under torch.profiler.
  7. Times: each kernel and its plain version at n = 2048 and 8192 beside
     its bound (the larger of the bytes it must move over the HBM rate and
     the float32 operations over the card's float32 rate).  Median of
     CUDA-event timings, all reps queued behind a spin kernel so the host's
     launch latency stays out of the event windows, L2 flushed before each
     launch.  At n = 2048 the kernels are also timed with a loop that
     synchronises before every rep, for comparison.

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
N_DEVICE_VS_CPU = 512
FAMILIES_E2E = ("uniform", "noisy_linear", "sparse", "tie")
COMPARE_SIZES = (1000, 2048, 8192)
# The device path's certificate tolerance.  The default 1e-6 admits a
# per-row dual violation of 1e-6, a gap of up to n * 1e-6, which on the tie
# family (optimum ~1e-5, 1e-6 jitter) is larger than the optimum; at 1e-12
# only the float64 dual repair or the host polish can certify, and both are
# exact.
CERTIFY_TOL = 1e-12
# Spin before a queue of timed reps: ~25-35 ms at the H100's clocks.
SPIN_CYCLES = 50_000_000

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
    "two_min": {
        "route": "cuda",
        "source": "lapgnn_tpu_torch/csrc/twomin.cu",
        "replaces": "lapgnn_tpu/ops/pallas/twomin.py:40",
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
    which the rate table does not cover, so K3 is held to the bytes bound.
    K4 reads C and v and writes min1, min2 and the int32 argmin; it does a
    subtract and two compares per element."""
    f32 = 4
    if name == "col_min":
        nbytes, ops = B * n * m * f32 + B * m * f32, B * n * m
    elif name == "min_trick":
        nbytes, ops = B * n * m * f32 + B * n * f32 + B * m * f32, 2 * B * n * m
    elif name == "two_min":
        nbytes, ops = B * n * m * f32 + B * m * f32 + 3 * B * n * f32, 3 * B * n * m
    else:
        nbytes, ops = B * n * m * f32 + B * n * 13 * f32, 0
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build(torch, strict=True):
    """Build every library at once, one compiler process each, and print
    what ``nvcc -Xptxas -v`` said of every kernel.  A kernel that spills
    registers fails the phase (``strict``)."""
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
    spills = []
    for name in KERNEL_LIBS:
        log = KERNEL_LIBS[name].path.with_suffix(".log")
        for line in (log.read_text() if log.exists() else "").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
            if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                spills.append(f"{name}: {line.strip()}")
    if spills and strict:
        raise AssertionError(f"kernels spill registers: {spills}")
    _emit({"phase": "build", "seconds": time.perf_counter() - t0,
           "per_library_seconds": seconds})


def _batch(torch, n, seed, fams=("uniform", "tie")):
    import numpy as np

    from lapgnn_tpu_torch.data.generators import FAMILIES

    rng = np.random.default_rng(seed)
    C = np.stack([FAMILIES[f](n, rng).astype(np.float32) for f in fams])
    return torch.from_numpy(C).cuda()


def _check_two_min(torch, got, want, what):
    """K4 against its plain version: argmin equal, min1 and min2 bit-equal
    (NaN where the plain version has NaN).  Returns the largest absolute
    difference over the finite entries."""
    if not torch.equal(got[2], want[2]):
        raise AssertionError(f"two_min argmin differs from its plain version ({what})")
    err = 0.0
    for g, w in zip(got[:2], want[:2]):
        nan = torch.isnan(w)
        if not torch.equal(torch.isnan(g), nan):
            raise AssertionError(f"two_min NaN pattern differs ({what})")
        if not torch.equal(g[~nan].view(torch.int32), w[~nan].view(torch.int32)):
            raise AssertionError(f"two_min values differ from its plain version ({what})")
        fin = torch.isfinite(w)
        if fin.any():
            err = max(err, float((g[fin] - w[fin]).abs().max()))
    return err


# K3's channels that are selections or counts: bit-equal to the plain version.
K3_EXACT_CHANNELS = (0, 1, 4, 6, 11, 12)
# (rows, m) beyond the square sizes, for K3 and K4: odd m, m < k = 10, m not a
# multiple of 4 or 32, eight warps a row, and K3's shared-memory path.
RAGGED_SHAPES = ((37, 1), (37, 7), (37, 10), (37, 11), (37, 33), (50, 1001),
                 (40, 16384), (12, 20000))


def _check_k3(torch, C, what, finite=False):
    """K3 against its plain version on the same input: every channel within
    K3_RTOL / K3_ATOL, the selection channels bit-equal.  Entries where the
    plain version is NaN (inf - inf inside a float sum of a row with +-inf)
    are not compared: there the kernel keeps what it always gave (its
    ``fmaxf`` / ``fminf`` drop a NaN operand where torch propagates it).
    Returns the kernel's result and the largest absolute difference over
    the finite entries."""
    from lapgnn_tpu_torch.ops.cuda import row_features_stats
    from lapgnn_tpu_torch.ops.cuda.colmin import col_min_plain
    from lapgnn_tpu_torch.ops.cuda.features import row_features_stats_plain

    got = row_features_stats(C)
    want = row_features_stats_plain(C, col_min_plain(C))
    torch.cuda.synchronize()
    if finite and not torch.isfinite(got).all():
        raise AssertionError(f"row_features_stats is not finite ({what})")
    known = ~torch.isnan(want)
    torch.testing.assert_close(got[known], want[known], rtol=K3_RTOL, atol=K3_ATOL,
                               msg=lambda m: f"row_features_stats ({what}): {m}")
    for ch in K3_EXACT_CHANNELS:
        if not torch.equal(got[..., ch].view(torch.int32), want[..., ch].view(torch.int32)):
            raise AssertionError(
                f"row_features_stats channel {ch} is not bit-equal to its plain version ({what})")
    fin = torch.isfinite(want)
    return got, float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def _special_rows(torch, C):
    """A copy of the (2, n, m >= 7) batch with rows that try the selections:
    all equal, +-0.0 mixed between -1 and 1, +inf, -inf, and both."""
    S = C.clone()
    m = S.shape[-1]
    S[0, 1, :] = 0.25
    S[0, 2, :] = 0.0
    S[0, 2, ::2] = -0.0
    S[0, 2, 0], S[0, 2, m - 1] = -1.0, 1.0
    S[1, 1, :] = S[0, 2, :]
    S[1, 1, m // 2] = 0.5
    S[0, 3, 5] = float("inf")
    S[0, 4, 2] = float("-inf")
    S[1, 2, 1], S[1, 2, m - 2] = float("-inf"), float("inf")
    return S


def _nan_inf_rows(torch, C):
    """+-inf in one row, NaN in three others (one NaN, two NaNs, and a NaN
    with its sign bit set)."""
    S = C.clone()
    m = S.shape[-1]
    S[1, 9, 3] = torch.tensor([-4194303], dtype=torch.int32).view(torch.float32).item()
    S[0, 3, 5] = float("inf")
    S[0, 4, 2] = S[0, 4, m - 1] = float("-inf")
    S[1, 7, m - 2] = float("nan")
    S[1, 8, 1] = S[1, 8, m // 2] = float("nan")
    return S


def phase_compare(torch, seed):
    from lapgnn_tpu_torch.ops import features
    from lapgnn_tpu_torch.ops.cuda import col_min, min_trick, two_min
    from lapgnn_tpu_torch.ops.cuda.colmin import col_min_plain, min_trick_plain
    from lapgnn_tpu_torch.ops.cuda.features import row_features_geometry
    from lapgnn_tpu_torch.ops.cuda.twomin import two_min_geometry, two_min_kernel, two_min_plain

    errs = {name: 0.0 for name in KERNELS}
    detail = []
    for n in COMPARE_SIZES:
        C = _batch(torch, n, seed + n)
        g = torch.Generator(device="cuda").manual_seed(seed + n)
        u = torch.randn((2, n), generator=g, device="cuda") * 0.3
        k1, p1 = col_min(C), col_min_plain(C)
        k2, p2 = min_trick(C, u), min_trick_plain(C, u)
        sort_path = features.row_features(C)[..., :13]
        torch.cuda.synchronize()
        if not torch.equal(k1.view(torch.int32), p1.view(torch.int32)):
            raise AssertionError(f"col_min differs from amin at n={n}")
        if not torch.equal(k2.view(torch.int32), p2.view(torch.int32)):
            raise AssertionError(f"min_trick differs from its plain version at n={n}")
        k3, e3 = _check_k3(torch, C, f"n={n}", finite=True)
        _check_k3(torch, _special_rows(torch, C), f"special rows, n={n}")
        errs["col_min"] = max(errs["col_min"], float((k1 - p1).abs().max()))
        errs["min_trick"] = max(errs["min_trick"], float((k2 - p2).abs().max()))
        errs["row_features_stats"] = max(errs["row_features_stats"], e3)
        v = torch.randn((2, n), generator=g, device="cuda") * 0.3
        errs["two_min"] = max(errs["two_min"], _check_two_min(
            torch, two_min(C, v), two_min_plain(C, v), f"n={n}"))
        S = _nan_inf_rows(torch, C)
        _check_two_min(torch, two_min(S, v), two_min_plain(S, v), f"inf/NaN rows, n={n}")
        # every geometry the wrapper can be forced to
        for force in ({"state": s, "unroll": r} for s in ("keys", "floats") for r in (4, 1)):
            _check_two_min(torch, two_min_kernel(S, v, **force), two_min_plain(S, v),
                           f"inf/NaN rows, n={n}, {force}")
        rel = ((k3 - sort_path).abs() / (sort_path.abs() + K3_ATOL / K3_RTOL)).amax((0, 1))
        detail.append({"n": n, "k3_max_abs_err": e3,
                       "k3_vs_sort_path_max_rel_per_channel": [float(x) for x in rel]})

    # Ragged and long rows: batch 0 continuous, batch 1 heavy with ties.
    ragged = []
    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    for rows, m in RAGGED_SHAPES:
        C = torch.rand((2, rows, m), generator=g, device="cuda")
        C[1] = torch.floor(C[1] * 8.0) / 8.0
        v = torch.randn((2, m), generator=g, device="cuda") * 0.3
        what = f"rows={rows}, m={m}"
        _, e3 = _check_k3(torch, C, what, finite=True)
        if m >= 7:
            _check_k3(torch, _special_rows(torch, C), f"special rows, {what}")
        errs["row_features_stats"] = max(errs["row_features_stats"], e3)
        errs["two_min"] = max(errs["two_min"], _check_two_min(
            torch, two_min(C, v), two_min_plain(C, v), what))
        if m >= 7:
            S = _nan_inf_rows(torch, C)
            _check_two_min(torch, two_min(S, v), two_min_plain(S, v), f"inf/NaN rows, {what}")
        ragged.append({"rows": rows, "m": m, "k3_max_abs_err": e3,
                       "k3_path": row_features_geometry(m, True).path,
                       "k3_warps_per_row": row_features_geometry(m, True).warps_per_row,
                       "k4_vector_loads": two_min_geometry(rows, m, True, batch=2).vector})

    # A view that starts 4 bytes into its buffer: contiguous, not 16-byte aligned.
    n = COMPARE_SIZES[0]
    C = _batch(torch, n, seed + n)
    buf = torch.empty(C.numel() + 1, dtype=torch.float32, device="cuda")
    Cu = buf[1:].view(C.shape).copy_(C)
    vbuf = torch.empty(2 * n + 1, dtype=torch.float32, device="cuda")
    vu = vbuf[1:].view(2, n).copy_(torch.randn((2, n), generator=g, device="cuda") * 0.3)
    if Cu.data_ptr() % 16 == 0 or vu.data_ptr() % 16 == 0:
        raise AssertionError("the unaligned views came out aligned")
    _, e3 = _check_k3(torch, Cu, "unaligned view", finite=True)
    _check_k3(torch, _special_rows(torch, Cu), "special rows, unaligned view")
    errs["row_features_stats"] = max(errs["row_features_stats"], e3)
    errs["two_min"] = max(errs["two_min"], _check_two_min(
        torch, two_min(Cu, vu), two_min_plain(Cu, vu), "unaligned view"))
    _check_two_min(torch, two_min(_nan_inf_rows(torch, Cu), vu),
                   two_min_plain(_nan_inf_rows(torch, Cu), vu), "inf/NaN rows, unaligned view")

    _emit({"phase": "compare", "max_abs_err": errs, "detail": detail, "ragged": ragged,
           "unaligned_view": {"n": n, "k3_max_abs_err": e3}})
    return errs


CHECKPOINT = Path(__file__).resolve().parent / "artifacts" / "one_gnn_default"


def _e2e_costs(seed):
    """One float32 instance of each family at n = N_E2E, drawn from ``seed``."""
    import numpy as np

    from lapgnn_tpu_torch.data.generators import FAMILIES

    rng = np.random.default_rng(seed)
    return {f: FAMILIES[f](N_E2E, rng).astype(np.float32) for f in FAMILIES_E2E}


def _scipy_opt(C64) -> float:
    import scipy.optimize

    r, c = scipy.optimize.linear_sum_assignment(C64)
    return float(C64[r, c].sum())


def _zero_launches():
    from lapgnn_tpu_torch.ops.cuda import WRAPPERS

    for w in WRAPPERS:
        w.launches = 0


def _read_launches():
    from lapgnn_tpu_torch.ops.cuda import WRAPPERS

    return {w.__name__: w.launches for w in WRAPPERS}


def phase_e2e(torch, seed):
    import numpy as np

    from lapgnn_tpu_torch.ops.cuda import col_min, min_trick, row_features_stats
    from lapgnn_tpu_torch.pipeline import WarmStartPipeline
    from lapgnn_tpu_torch.solver.native import lapjv_native, lapjv_seeded_native
    from lapgnn_tpu_torch.solver.verification import certify_assignment
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint

    params, meta, _ = load_checkpoint(CHECKPOINT)
    pipe = WarmStartPipeline(
        build_model_from_meta(meta), params, mode="hybrid", seed_mode="auto",
        normalize_costs=True,
    )
    n = N_E2E
    costs = _e2e_costs(seed)

    _zero_launches()
    results = {f: pipe.solve(C, certify=True) for f, C in costs.items()}
    torch.cuda.synchronize()
    launches = _read_launches()

    per = len(costs)
    if row_features_stats.launches < per or col_min.launches < per or min_trick.launches < 2 * per:
        raise AssertionError(f"the hybrid path skipped a kernel: launches {launches}")
    report = {}
    for f, C in costs.items():
        out = results[f]
        C64 = C.astype(np.float64)
        opt = _scipy_opt(C64)
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
    return pipe, costs["uniform"]


def _ms_host(torch, fn, reps):
    """Median host-clock ms of ``fn`` over work that ends in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_device_e2e(torch, seed):
    """The default serving call on the card: predict, the float32 seeded
    solve on the device, the float64 certificate on the host."""
    import numpy as np

    from lapgnn_tpu_torch.ops.cuda import col_min, min_trick, row_features_stats, two_min
    from lapgnn_tpu_torch.pipeline import WarmStartPipeline
    from lapgnn_tpu_torch.solver.jv import SolveStats
    from lapgnn_tpu_torch.solver.seeded import lapjv_seeded_single
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint

    params, meta, _ = load_checkpoint(CHECKPOINT)
    pipe = WarmStartPipeline(
        build_model_from_meta(meta), params, mode="device", seed_mode="auto",
        normalize_costs=True, certify_tol=CERTIFY_TOL,
    )
    if pipe.mode != "device" or pipe.device.type != "cuda":
        raise AssertionError("the default pipeline is not the device mode on the card")
    n = N_E2E
    costs = _e2e_costs(seed)

    _zero_launches()
    results, stats, k4_per_instance = {}, {}, {}
    for f, C in costs.items():
        before = two_min.launches
        results[f] = pipe.solve(C, certify=True)
        stats[f] = pipe.last_solve_stats[0]
        k4_per_instance[f] = two_min.launches - before
    torch.cuda.synchronize()
    launches = _read_launches()

    per = len(costs)
    if (row_features_stats.launches < per or col_min.launches < per
            or min_trick.launches < 2 * per or min(k4_per_instance.values()) < 1):
        raise AssertionError(
            f"the device path skipped a kernel: launches {launches}, "
            f"K4 per instance {k4_per_instance}"
        )
    report = {}
    for f, C in costs.items():
        out = results[f]
        C64 = C.astype(np.float64)
        opt = _scipy_opt(C64)
        got = float(out["cost"][0])
        if not abs(got - opt) <= 1e-12 * max(1.0, abs(opt)):
            raise AssertionError(f"{f}: device cost {got!r} != SciPy {opt!r}")
        if not out["certified"].all():
            raise AssertionError(f"{f}: not certified (gap bound {out['gap_bound']})")
        if "routed_host" in out:
            raise AssertionError(f"{f}: routed to the host")
        how = ("polish" if out["polished"][0] else "repair" if out["repaired"][0] else "raw")

        # times per instance, outside the counted run
        Ct = torch.from_numpy(C).cuda()[None]
        predict_ms = _ms_host(torch, lambda: pipe.predict_duals(Ct), 3)
        u, v = pipe.predict_duals(Ct)
        with torch.inference_mode():
            solve_ms = _ms_host(torch, lambda: lapjv_seeded_single(
                Ct[0], u[0], v[0], eps=pipe.eps, gate=pipe.gate, stats=SolveStats()), 2)
        packed = pipe._solve_device(Ct)
        again = pipe._unpack(packed, n)
        t0 = time.perf_counter()
        pipe._certify_and_polish(C64[None], packed, again)
        certify_ms = (time.perf_counter() - t0) * 1e3
        st = stats[f]
        report[f] = {
            "cost": got, "scipy_cost": opt, "certificate": how,
            "used_fallback": bool(out["used_fallback"][0]),
            "repaired": bool(out["repaired"][0]), "polished": bool(out["polished"][0]),
            "polish_ms": float(out["polish_ms"][0]),
            "predict_ms_median": predict_ms, "device_solve_ms_median": solve_ms,
            "certify_ms": certify_ms, "k4_launches": k4_per_instance[f],
            "loops": {"greedy_rounds": st.greedy_rounds, "arr_rounds": st.arr_rounds,
                      "aug_rounds": st.aug_rounds, "sweeps": st.sweeps,
                      "flip_steps": st.flip_steps, "host_syncs": st.host_syncs,
                      "flip_ms": st.flip_ms},
        }
    _emit({"phase": "device_e2e", "n": n, "certify_tol": CERTIFY_TOL,
           "launches": launches, "instances": report})
    return launches, pipe, costs


def phase_device_vs_cpu(torch, pipe, seed):
    """The port's seeded solver on the card and on the CPU from the same
    float32 matrix and seeds (the pipeline's, min-trick projected)."""
    import numpy as np

    from lapgnn_tpu_torch.data.generators import FAMILIES
    from lapgnn_tpu_torch.solver.seeded import lapjv_seeded_single

    n = N_DEVICE_VS_CPU
    rng = np.random.default_rng(seed + 5)
    report = {}
    for f in ("uniform", "tie"):
        Ct = torch.from_numpy(FAMILIES[f](n, rng).astype(np.float32)).cuda()
        u, v = pipe.predict_duals(Ct[None])
        with torch.inference_mode():
            on_card = lapjv_seeded_single(Ct, u[0], v[0], gate=pipe.gate)
            on_cpu = lapjv_seeded_single(Ct.cpu(), u[0].cpu(), v[0].cpu(), gate=pipe.gate)
        same_x = torch.equal(on_card.col_of_row.cpu(), on_cpu.col_of_row)
        same_v = torch.equal(on_card.v.cpu().view(torch.int32), on_cpu.v.view(torch.int32))
        if not (same_x and same_v):
            raise AssertionError(f"{f}: the card and the CPU disagree (x {same_x}, v {same_v})")
        report[f] = {"equal_col_of_row": same_x, "bit_equal_v": same_v,
                     "used_fallback": bool(on_card.used_fallback)}
    _emit({"phase": "device_vs_cpu", "n": n, "instances": report})


def phase_device_breakdown(torch, pipe, C_np):
    """Where one device solve's time goes (uniform, n = N_E2E): each stage on
    the host clock between synchronizes, then one whole solve under
    torch.profiler for the device's idle share and K4's device time."""
    from lapgnn_tpu_torch.solver.jv import SolveStats
    from lapgnn_tpu_torch.solver.seeded import lapjv_seeded_single

    Ct = torch.from_numpy(C_np).cuda()
    u, v = pipe.predict_duals(Ct[None])

    def solve(stats):
        with torch.inference_mode():
            lapjv_seeded_single(Ct, u[0], v[0], eps=pipe.eps, gate=pipe.gate, stats=stats)

    timed = SolveStats(timed=True)
    solve(timed)
    rows, wall_ms = _profile(torch, lambda: solve(SolveStats()))
    busy_ms = sum(r[0] for r in rows) / 1e3
    k4_ms = sum(d for d, k, _ in rows if "twomin" in k) / 1e3
    _emit({
        "phase": "device_breakdown", "n": C_np.shape[-1],
        "stage_ms": timed.stage_ms, "flip_ms": timed.flip_ms,
        "host_syncs": timed.host_syncs,
        "k4_device_ms": k4_ms if rows else "not measured",
        "k4_share_of_arr": (k4_ms / timed.stage_ms["arr"]) if rows else "not measured",
        "profiled_solve_wall_ms": wall_ms,
        "device_busy_ms": busy_ms if rows else "not measured",
        "device_idle_share": (1.0 - busy_ms / wall_ms) if rows else "not measured",
        "top_kernels": [{"name": k[:80], "device_ms": d / 1e3, "count": c} for d, k, c in rows[:8]],
    })


def _time_ms(torch, fn, reps, flush, queued=True, flush_by_read=False):
    """Median CUDA-event time of ``fn`` with L2 flushed before each launch:
    by ``flush.zero_()``, which leaves L2 full of dirty lines that the timed
    reads must evict, or (``flush_by_read``) by a sum over ``flush``, which
    leaves clean lines.

    Queued (the default): a spin kernel first, then every rep's flush, start
    event, launch and end event without a synchronize between reps, and one
    synchronize at the end.  The host enqueues the reps while the card
    spins, so the card finds each launch already queued and the host's
    launch latency stays out of the event windows.  ``queued=False``
    synchronises after every rep instead, so each rep starts on an idle
    card and its window holds the host's launch latency."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    if queued:
        torch.cuda._sleep(SPIN_CYCLES)
    for start, end in zip(starts, ends):
        if flush_by_read:
            flush.sum()
        else:
            flush.zero_()
        start.record()
        fn()
        end.record()
        if not queued:
            end.synchronize()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _device_us_per_launch(torch, fn, reps=20):
    """Device time of ``fn``'s kernels per call, from torch.profiler, with
    the data left in L2 between calls; None where the profiler saw none."""
    for _ in range(3):
        fn()
    rows, _ = _profile(torch, lambda: [fn() for _ in range(reps)])
    return sum(r[0] for r in rows) / reps if rows else None


def _two_min_yardsticks(torch, C, v, reps, flush, no_flush):
    """What K4's times at this size stand beside: the event window's floor (a
    launch on 8 x 128 elements through the same wrapper), a row reduction of
    the same matrix by the framework (``torch.amin`` over rows: one read of
    C, not K4's function), both kernels flushed by a read instead of by
    ``zero_``, and their device time per launch under the profiler."""
    from lapgnn_tpu_torch.ops.cuda import two_min

    tiny_C = torch.rand((1, 8, 128), device="cuda")
    tiny_v = torch.zeros((1, 128), device="cuda")
    kern = lambda: two_min(C, v)  # noqa: E731
    amin = lambda: torch.amin(C, dim=-1)  # noqa: E731
    return {
        "event_floor_ms": _time_ms(torch, lambda: two_min(tiny_C, tiny_v), reps, no_flush),
        "ms_read_flush": _time_ms(torch, kern, reps, flush, flush_by_read=True),
        "device_us_per_launch_l2_resident": _device_us_per_launch(torch, kern),
        "row_amin_ms": _time_ms(torch, amin, reps, flush),
        "row_amin_ms_l2_resident": _time_ms(torch, amin, reps, no_flush),
        "row_amin_ms_read_flush": _time_ms(torch, amin, reps, flush, flush_by_read=True),
        "row_amin_device_us_per_launch_l2_resident": _device_us_per_launch(torch, amin),
    }


def _two_min_variants(torch, C, v, reps, flush, no_flush):
    """K4's time with each compare state and either unroll, cold and with C
    left in L2."""
    from lapgnn_tpu_torch.ops.cuda.twomin import two_min_kernel

    out = {}
    for state in ("keys", "floats"):
        for unroll in (4, 1):
            fn = lambda: two_min_kernel(C, v, state=state, unroll=unroll)  # noqa: E731
            out[f"{state}_unroll{unroll}"] = {
                "ms": _time_ms(torch, fn, reps, flush),
                "ms_l2_resident": _time_ms(torch, fn, reps, no_flush),
            }
    return out


def phase_times(torch, seed):
    from lapgnn_tpu_torch.ops.cuda import col_min, min_trick, row_features_stats, two_min
    from lapgnn_tpu_torch.ops.cuda.colmin import col_min_plain, min_trick_plain
    from lapgnn_tpu_torch.ops.cuda.features import row_features_stats_plain, stats_kernel
    from lapgnn_tpu_torch.ops.cuda.twomin import two_min_plain

    flush = torch.empty(128 * 2**20 // 4, dtype=torch.float32, device="cuda")
    no_flush = torch.empty(1, dtype=torch.float32, device="cuda")
    out = {}
    for n in (2048, 8192):
        C = _batch(torch, n, seed + 7 * n, fams=("uniform",))
        g = torch.Generator(device="cuda").manual_seed(seed)
        u = torch.randn((1, n), device="cuda", generator=g) * 0.3
        v = torch.randn((1, n), device="cuda", generator=g) * 0.3
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
            "two_min": (lambda: two_min(C, v), lambda: two_min_plain(C, v), None),
        }
        for name, (kern, plain, lib) in fns.items():
            bound, by = _bound_ms(name, 1, n, n)
            row = {
                "ms": _time_ms(torch, kern, reps, flush),
                "plain_ms": _time_ms(torch, plain, max(3, reps // 4), flush),
                "library_ms": None if lib is None else _time_ms(torch, lib, reps, flush),
                "bound_ms": bound,
                "bound_by": by,
            }
            if n == N_E2E:
                row["ms_synced_loop"] = _time_ms(torch, kern, reps, flush, queued=False)
            out.setdefault(name, {})[n] = row

        # K3 without K1 inside, on either path.
        k3 = out["row_features_stats"][n]
        k3["kernel_only_ms"] = _time_ms(torch, lambda: stats_kernel(C, cm), reps, flush)
        k3["shared_path_kernel_only_ms"] = _time_ms(
            torch, lambda: stats_kernel(C, cm, path="shared"), reps, flush)
        # K4 with C left in L2 between launches, and every geometry.
        k4 = out["two_min"][n]
        k4["ms_l2_resident"] = _time_ms(torch, lambda: two_min(C, v), reps, no_flush)
        k4["variants_ms"] = _two_min_variants(torch, C, v, reps, flush, no_flush)
        k4["yardsticks"] = _two_min_yardsticks(torch, C, v, reps, flush, no_flush)
        k3["kernel_only_ms_l2_resident"] = _time_ms(
            torch, lambda: stats_kernel(C, cm), reps, no_flush)
    n = 4096
    C = _batch(torch, n, seed + 7 * n, fams=("uniform",))
    v = torch.randn((1, n), device="cuda", generator=g) * 0.3
    out["two_min"][n] = {"variants_ms": _two_min_variants(torch, C, v, 10, flush, no_flush)}
    _emit({"phase": "times", "batch": 1, "kernels": out})
    return out


def _profile(torch, fn):
    """Run ``fn`` once under torch.profiler.  Returns the kernels' rows
    (device us, name, count), heaviest first, and the host-clock ms of the
    run, which ends in a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    return rows, wall_ms


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

        rows, wall_ms = _profile(torch, lambda: pipe.predict_duals(cost))
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
    ap.add_argument("--phases", default="",
                    help="comma-separated subset of build,compare,times (no ok line)")
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
        if args.phases:
            subset = {"build": lambda: phase_build(torch, strict=False),
                      "compare": lambda: phase_compare(torch, args.seed),
                      "times": lambda: phase_times(torch, args.seed)}
            for phase in args.phases.split(","):
                subset[phase]()
            print(f"chip_smoke: partial run ({args.phases}), no ok line")
            return 0
        phase_build(torch)
        errs = phase_compare(torch, args.seed)
        pipe, c_uniform = phase_e2e(torch, args.seed)
        phase_breakdown(torch, pipe, c_uniform)
        launches, dpipe, costs = phase_device_e2e(torch, args.seed)
        phase_device_vs_cpu(torch, dpipe, args.seed)
        phase_device_breakdown(torch, dpipe, costs["uniform"])
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
