"""The benchmark's arithmetic: the card's peaks, the least time of each
kernel and of a whole step from shapes, the statistics of a window, and the
check that no JAX module was loaded.

Frozen with the benchmark, so that a change to the program cannot move its
own yardstick.  Copied from ``chip_smoke.py``: the peaks (:239-242),
``_bound_ms`` (:347, K1-K4 and the greedy bound) and
``_dual_forward_bound_ms`` (:2120).  ``chip_smoke._solver_bound_ms`` is not
copied: it charges the solver's kernels for the sweeps that the measured run
made.  Here S1-S3 are charged one read of the n x n matrix and their O(n)
vectors a launch, the least any implementation reads.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "F32_OPS_PER_S",
    "HBM_BYTES_PER_S",
    "banned_modules",
    "dual_forward_flops",
    "dual_train_flops",
    "kernel_bound_s",
    "kernel_class",
    "one_gnn_forward_flops",
    "percentile",
    "solve_instance_bound_s",
    "spread",
]

# H100 SXM data-sheet peaks (dense, no sparsity), at a 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

BANNED_TOP_LEVEL = ("jax", "jaxlib", "flax", "lapgnn_tpu")


def banned_modules(names: Iterable[str]) -> List[str]:
    """The module names whose top-level name (the part before the first
    dot), compared whole, is JAX's, jaxlib's, flax's or the JAX package's:
    ``lapgnn_tpu_torch`` passes, ``lapgnn_tpu.pipeline`` does not."""
    return sorted(name for name in names if name.split(".", 1)[0] in BANNED_TOP_LEVEL)


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of every value, by linear interpolation
    between the closest ranks (numpy's default).  An infinite value (a
    failed request) takes its place at the top."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    if lo == hi or xs[lo] == xs[hi]:
        return float(xs[lo])
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of the
    median, with ``statistics.quantiles(values, n=4)``'s quartiles."""
    import statistics

    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(q2) if q2 else math.inf


# --- kernels ---------------------------------------------------------------

# Trace names of the port's hand-written kernels -> the function whose
# bound a launch carries.  A split launch (colmin_partial + colmin_finish)
# is charged once, on its first kernel.
_KERNELS: Tuple[Tuple[str, str], ...] = (
    ("colmin_cluster", "col_min"),
    ("colmin_partial", "col_min"),
    ("colmin_finish", "none"),
    ("row_features_reg_kernel", "row_features"),
    ("row_features_smem_kernel", "row_features"),
    ("twomin_kernel", "two_min"),
    ("greedy_match_kernel", "solver"),
    ("greedy_kernel", "greedy_total"),
    ("arr_kernel", "solver"),
    ("augment_kernel", "solver"),
)


def kernel_class(trace_name: str) -> Optional[str]:
    """Which of the port's kernels a trace name is (its bound's name), or
    None for any other kernel (PyTorch's own, cuBLAS)."""
    for key, cls in _KERNELS:
        if key in trace_name:
            return cls
    return None


def kernel_bound_s(cls: str, B: int, n: int, m: int) -> float:
    """Least time of one launch on a (B, n, m) input: each input read once
    and each output written once over the HBM rate, against its float32
    operations over the float32 rate (``chip_smoke._bound_ms``, float32
    forms; K1 and K2 share their kernels' names and take K1's bound).  The
    solver's kernels (S1-S3, class ``solver``) are charged one read of the
    matrix and eight of their O(n) vectors, whatever their sweeps read."""
    f32 = 4
    if cls == "none":
        return 0.0
    if cls == "col_min":
        nbytes, ops = B * n * m * f32 + B * m * f32, B * n * m
    elif cls == "two_min":
        nbytes = B * n * m * f32 + B * m * f32 + 2 * B * n * f32 + B * n * 4
        ops = 3 * B * n * m
    elif cls == "greedy_total":
        nbytes, ops = B * n * m * f32 + B * n * f32 + B * n * 8 + B * f32, B * n * m
    elif cls == "row_features":
        nbytes, ops = B * n * m * f32 + B * n * 13 * f32, 0
    elif cls == "solver":
        nbytes, ops = B * (n * m * f32 + 8 * max(n, m) * f32), 0
    else:
        raise ValueError(f"no bound for kernel class {cls!r}")
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


# --- models ----------------------------------------------------------------

def one_gnn_forward_flops(n: int, hidden: int, layers: int, topk: int, in_dim: int = 21,
                          refine: bool = True) -> int:
    """Matrix-product FLOPs of one OneGNN forward on one (n, n) instance
    (``lapgnn_tpu_torch/models/one_gnn.py``): the input projection, two
    Linear(h, h) a residual block, the pre-output, the top-k edge MLP
    (Linear(1, h) and Linear(h, h) on n*k values) and the head
    (h -> h/2 -> 1).  Elementwise work is not counted."""
    h, hh = hidden, max(hidden // 2, 1)
    flops = 2 * n * in_dim * h + layers * 2 * (2 * n * h * h) + 2 * n * h
    if refine:
        k = topk
        flops += 2 * n * k * h + 2 * n * k * h * h
    flops += 2 * n * h * hh + 2 * n * hh
    return flops


EDGE_HIDDEN, NODE_DIM, EDGE_DIM = 128, 14, 10  # DualGNN's fixed widths


def dual_forward_flops(n: int, hidden: int, layers: int, B: int = 1) -> int:
    """Matrix-product FLOPs one DualGNN forward needs on B (n, n) instances
    (``chip_smoke._dual_forward_bound_ms``, with the output heads): per
    layer the edge MLP 2*n^2*(10*128 + 128*128 + 128*h), the two edge terms
    (one dot of width h a head and direction: 2*n^2*h each) and the two
    attention messages (2*n^2*h each), the four node projections and the
    two updates 16*n*h^2; the encoders 4*n*14*h and the heads 4*n*h.  The
    edge terms are counted as the dots they need, not as the block-diagonal
    product the model takes them in."""
    h = hidden
    per_layer = (2 * n * n * (EDGE_DIM * EDGE_HIDDEN + EDGE_HIDDEN * EDGE_HIDDEN + EDGE_HIDDEN * h)
                 + 8 * n * n * h + 16 * n * h * h)
    return B * (layers * per_layer + 4 * n * NODE_DIM * h + 4 * n * h)


def dual_train_flops(n: int, hidden: int, layers: int, B: int = 1) -> int:
    """FLOPs of one training step's model: the forward, and a backward of
    twice the forward less the gradients of the inputs, which need none (the
    first edge layer's and the encoders')."""
    fwd = dual_forward_flops(n, hidden, layers, B)
    no_input_grad = B * (layers * 2 * n * n * EDGE_DIM * EDGE_HIDDEN + 2 * 2 * n * NODE_DIM * hidden)
    return 3 * fwd - no_input_grad


def solve_instance_bound_s(n: int, hidden: int, layers: int, topk: int) -> float:
    """Least time of one instance of the serving step (``pipeline._e2e``):
    the larger of OneGNN's forward FLOPs over the float32 rate and one read
    of the n x n float32 matrix over the HBM rate."""
    return max(one_gnn_forward_flops(n, hidden, layers, topk) / F32_OPS_PER_S,
               n * n * 4 / HBM_BYTES_PER_S)


def leaf_norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
                   counted: Iterable[str]) -> Tuple[float, str]:
    """The widest gap between two sets of per-leaf norms: |prog - ref| over
    the larger of the reference leaf's norm and the median leaf's, over the
    leaves ``counted``.  Returns (gap, leaf)."""
    import statistics

    names = list(counted)
    floor = statistics.median(ref[k] for k in names)
    worst, where = 0.0, ""
    for k in names:
        g = abs(prog[k] - ref[k]) / max(ref[k], floor)
        if not g <= worst:  # a NaN is the widest gap
            worst, where = (g if g == g else math.inf), k
    return worst, where


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], counted: Iterable[str]) -> float:
    """The median over the leaves ``counted`` of |prog - ref| / ref: a
    change that every leaf shares, steady from seed to seed."""
    import statistics

    gaps = [abs(prog[k] - ref[k]) / ref[k] if ref[k] > 0 else math.inf for k in counted]
    return float(statistics.median(gaps))


def total_norm_gap(prog: Dict[str, float], ref: Dict[str, float], counted: Iterable[str]) -> float:
    """The gap between two whole norms over the leaves ``counted``, each the
    root of the sum of the squared per-leaf norms, relative to the
    reference's."""
    names = list(counted)
    p = math.sqrt(sum(prog[k] ** 2 for k in names))
    r = math.sqrt(sum(ref[k] ** 2 for k in names))
    return abs(p - r) / r if r > 0 else math.inf


# --- readers' arithmetic ---------------------------------------------------------

def mean_span_ms(rec: Dict, name: str) -> Optional[float]:
    """Mean time of a span's calls (ms); None where the run timed no such
    call."""
    times = rec.get("spans", {}).get(name)
    if not times:
        return None
    return sum(times) / len(times)


def device_idle_pct(rec: Dict) -> Optional[float]:
    """Share of the traced window in which no operation ran on the card."""
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_roofline_pct(rec: Dict) -> Optional[float]:
    """The port's kernels in the traced window: the sum of their launches'
    least times over the sum of their device times.  Every launch of these
    cells is on one (n, n) float32 instance (``rec['batch']`` of them)."""
    t = rec.get("trace")
    if not t:
        return None
    n, B = int(rec["n"]), int(rec["batch"])
    bound = spent = 0.0
    for name, (launches, seconds) in t["kernels"].items():
        cls = kernel_class(name)
        if cls is None:
            continue
        bound += launches * kernel_bound_s(cls, B, n, n)
        spent += seconds
    return 100.0 * bound / spent if spent > 0 else None


def solve_mfu_pct(rec: Dict) -> Optional[float]:
    """Instances completed in the window times the least time of one
    (``solve_instance_bound_s``), over the window, to 4 significant
    digits."""
    if not rec.get("instances") or rec["window_s"] <= 0:
        return None
    cfg = rec["config"]
    least = solve_instance_bound_s(int(rec["n"]), cfg["hidden"], cfg["layers"], cfg["topk"])
    return float(f"{100.0 * rec['instances'] * least / rec['window_s']:.4g}")


def train_mfu_pct(rec: Dict) -> Optional[float]:
    """The model FLOPs of the window's samples (``dual_train_flops``) over
    the window at the float32 rate."""
    if not rec.get("samples") or rec["window_s"] <= 0:
        return None
    cfg = rec["config"]
    flops = dual_train_flops(int(rec["n"]), cfg["hidden"], cfg["layers"])
    return 100.0 * rec["samples"] * flops / (rec["window_s"] * F32_OPS_PER_S)
