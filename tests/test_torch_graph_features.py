"""DualGNN's dense graph features as two CUDA kernels
(``ops.cuda.graph_features``, ``csrc/graph_features.cu``) and the router in
``ops.features.graph_features``.

On the CPU: the router (a CPU tensor, ``parallel.dual``'s hooks and offsets,
the reduced-cost channel with u, a C that needs a gradient and lines longer
than the kernels take all go to ``graph_features_plain`` and launch
nothing); the shared check ``check_against_plain`` passes the plain features
against themselves, NaNs and zeros of either sign included, and fails each
kind of wrong channel; the constants the kernels hard-code against the
module's.

The module imports no JAX, so its ``cuda`` cases run on the card:
``python3 -m pytest tests/test_torch_graph_features.py -m cuda -p no:cacheprovider``.
There ``check_against_plain`` holds the kernels to ``graph_features_plain``
on the same card over the pool's families, planted duplicates, mixed -0.0 /
+0.0, constant rows and a row holding NaNs, at shapes from (1, 1, 1) to
(1, 2048, 2048): bit for bit on ranks, min, max, median and MAD (through the
scaled cost and the node features), gaps, ties, the scaled cost, the zero
channel and the positional columns, where only the sign of a zero may differ
(torch's min reductions and its unstable sort of lines up to 32 long may
pick -0.0 where the kernels pick +0.0) and NaN stands for NaN; within
``ULPS`` units of the float32 epsilon of each line's scale on mean, std and
entropy, which both sides sum in their own order.  One case counts the
launches and the host syncs of a call.
"""

import importlib

import numpy as np
import pytest
import torch

from lapgnn_tpu_torch import tracing
from lapgnn_tpu_torch.data.generators import FAMILIES
from lapgnn_tpu_torch.ops import features
from lapgnn_tpu_torch.ops.features import GraphFeatures, graph_features, graph_features_plain

kgf = importlib.import_module("lapgnn_tpu_torch.ops.cuda.graph_features")
LAUNCHES = "launch.graph_features"  # the tracer's count of the kernels' launches


def _inputs(kind, B, n, m, seed):
    """(B, n, m) float32 costs: a pool family, or one of the special kinds."""
    rng = np.random.default_rng(seed)
    if kind in FAMILIES:
        k = max(n, m)
        return np.stack([FAMILIES[kind](k, rng)[:n, :m] for _ in range(B)]).astype(np.float32)
    if kind == "duplicates":  # many exact ties in every row and column
        return (rng.integers(0, 7, size=(B, n, m)) / 7.0).astype(np.float32)
    if kind == "signed_zeros":
        vals = np.array([-0.0, 0.0, -0.0, 0.0, 1.0, -1.0, 0.5], dtype=np.float32)
        return rng.choice(vals, size=(B, n, m))
    if kind == "constant_row":  # a constant row and a constant column besides
        C = rng.uniform(0.0, 1.0, size=(B, n, m)).astype(np.float32)
        C[:, 0, :] = 0.3
        C[:, :, -1] = 0.7
        return C
    if kind == "nan_row":  # a row with a NaN in every third entry, so columns with one
        C = rng.uniform(0.0, 1.0, size=(B, n, m)).astype(np.float32)
        C[:, n // 2, ::3] = np.nan
        return C
    raise ValueError(kind)


# ------------------------------------------------------------ on the CPU


KINDS = ("uniform", "noisy_linear", "sparse", "tie", "duplicates", "signed_zeros",
         "constant_row", "nan_row")


@pytest.mark.parametrize("kind", KINDS)
def test_check_against_plain_passes_the_plain_features(kind):
    """The plain features against themselves: 0 ulps everywhere, NaN for NaN
    and a zero of either sign for a zero."""
    C = torch.from_numpy(_inputs(kind, 2, 7, 6, 11))
    want = graph_features_plain(C)
    got = [t.clone() for t in want]
    got[2][..., 3] = torch.where(got[2][..., 3] == 0, -got[2][..., 3], got[2][..., 3])
    assert kgf.check_against_plain(C, got, want) == {
        f"{a}_{b}": 0.0 for a in ("row", "col") for b in ("mean", "std", "entropy")}


WRONG = {
    # name: (output, channel, how the kernels' value is made wrong)
    "edge_scaled_cost": (2, 0, "ulp"),
    "edge_col_rank": (2, 2, "ulp"),
    "edge_zero": (2, 9, "ulp"),
    "edge_row_entropy": (2, 7, "ulp"),
    "edge_col_entropy": (2, 8, "ulp"),
    "row_min": (0, 0, "ulp"),
    "col_mad": (1, 4, "ulp"),
    "row_pos": (0, 13, "ulp"),
    "row_min_nan": (0, 0, "nan"),
    "row_mean": (0, 2, "ulps"),
    "col_std": (1, 3, "ulps"),
    "col_entropy": (1, 5, "ulps"),
}


@pytest.mark.parametrize("case", sorted(WRONG))
def test_check_against_plain_fails_a_wrong_channel(case):
    """One line of one channel a little off (one ulp on an exact channel,
    past ``ULPS`` on a summed one, or NaN) fails the check."""
    out, ch, how = WRONG[case]
    C = torch.from_numpy(_inputs("uniform", 2, 7, 6, 12))
    want = graph_features_plain(C)
    got = [t.clone() for t in want]
    x = got[out][(1, 3, ..., ch)] if out == 2 else got[out][1, 3, ch:ch + 1]
    if how == "ulp":
        x.copy_(torch.nextafter(x, torch.full_like(x, float("inf"))))
    elif how == "nan":
        x.fill_(float("nan"))
    else:  # past the limit, in epsilons of the line's largest |x| or of the entropy
        stat = {2: "mean", 3: "std", 5: "entropy"}[ch]
        scale = x.abs() if stat == "entropy" else C[1].abs().amax()
        x.add_(2 * kgf.ULPS[stat] * float(np.finfo(np.float32).eps) * scale)
        if stat == "entropy":  # the edge's broadcast copy along, so that only ULPS is left
            (got[2][1, 3, :, 7] if out == 0 else got[2][1, :, 3, 8]).fill_(float(x))
    with pytest.raises(AssertionError, match="graph_features"):
        kgf.check_against_plain(C, got, want)


def test_constants_match_the_features_module():
    assert kgf.TAU == features.TAU and kgf.EPS == features.EPS
    assert kgf.POS_FREQS == features.POS_FREQS
    assert kgf.NODE_DIM == features.NODE_FEATURE_DIM
    assert kgf.EDGE_DIM == features.EDGE_FEATURE_DIM


def test_the_kernel_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="takes a contiguous CUDA float32"):
        kgf.graph_features(torch.zeros(1, 3, 3))


class _Route:
    """The router with the card stood in for: ``_on_card`` true, the
    kernels' length limit ``limit``, and the kernels replaced by a recorder
    that returns the plain features."""

    def __init__(self, monkeypatch, limit=16):
        self.kernel_calls = 0
        self.plain_calls = 0
        real_plain = features.graph_features_plain

        def kernel(C):
            self.kernel_calls += 1
            assert C.dtype == torch.float32 and C.is_contiguous()
            return tuple(real_plain(C))

        def plain(*args, **kwargs):
            self.plain_calls += 1
            return real_plain(*args, **kwargs)

        monkeypatch.setattr(features, "_on_card", lambda C: True)
        monkeypatch.setattr(features, "graph_features_max_len", lambda device: limit)
        monkeypatch.setattr(features, "_graph_features_kernel", kernel)
        monkeypatch.setattr(features, "graph_features_plain", plain)


def _hook(C):
    return C


ROUTES = {
    # name: (shape, keyword arguments, takes the kernels)
    "whole_batched": ((2, 5, 7), {}, True),
    "whole_unbatched": ((5, 7), {}, True),
    "float64": ((1, 6, 6), {"dtype": torch.float64}, True),
    "at_the_limit": ((1, 16, 3), {}, True),
    "reduced_cost_without_u": ((1, 6, 6), {"include_reduced_cost": True}, True),
    "reduced_cost_with_u": ((1, 6, 6), {"include_reduced_cost": True, "u": True}, False),
    "u_without_reduced_cost": ((1, 6, 6), {"u": True}, True),
    "row_hook": ((1, 6, 6), {"constrain_rows": _hook}, False),
    "col_hook": ((1, 6, 6), {"constrain_cols": _hook}, False),
    "offsets": ((1, 6, 6), {"offsets": (0, 1)}, False),
    "rows_over_the_limit": ((1, 17, 3), {}, False),
    "cols_over_the_limit": ((1, 3, 17), {}, False),
    "requires_grad": ((1, 6, 6), {"requires_grad": True}, False),
    "requires_grad_under_no_grad": ((1, 6, 6), {"requires_grad": True, "no_grad": True}, True),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_router_takes_the_kernels_only_for_a_whole_card_matrix(case, monkeypatch):
    shape, kwargs, kernel = ROUTES[case]
    route = _Route(monkeypatch)
    kwargs = dict(kwargs)
    dtype = kwargs.pop("dtype", torch.float32)
    grad = torch.enable_grad() if not kwargs.pop("no_grad", False) else torch.no_grad()
    C = torch.rand(shape, generator=torch.Generator().manual_seed(3)).to(dtype)
    C.requires_grad_(kwargs.pop("requires_grad", False))
    if kwargs.get("u") is True:
        kwargs["u"] = torch.rand(shape[-2])
    if "offsets" in kwargs:  # a tile at (0, 1) of a matrix one column wider
        whole = torch.cat([C, C[..., :1]], dim=-1)
        kwargs["constrain_rows"] = lambda t: whole
    with grad:
        got = graph_features(C, **kwargs)
    assert (route.kernel_calls, route.plain_calls) == ((1, 0) if kernel else (0, 1))
    want = features.graph_features_plain(C, **kwargs)  # the recorder counts this one too
    assert isinstance(got, GraphFeatures)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", ["default", "hooks", "offsets", "reduced_cost"])
def test_cpu_calls_take_the_plain_path_and_launch_nothing(case):
    C = torch.from_numpy(_inputs("uniform", 2, 9, 9, 4))
    kwargs = {
        "default": {},
        "hooks": {"constrain_rows": _hook, "constrain_cols": _hook},
        "offsets": {"constrain_rows": lambda t: torch.cat([t, t], -1),
                    "constrain_cols": lambda t: torch.cat([t, t], -2), "offsets": (9, 9)},
        "reduced_cost": {"include_reduced_cost": True, "u": torch.rand(2, 9)},
    }[case]
    before = tracing.counters().get(LAUNCHES, 0)
    got = graph_features(C, **kwargs)
    want = graph_features_plain(C, **kwargs)
    assert tracing.counters().get(LAUNCHES, 0) == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _hold(C):
    """The kernels' features of the CUDA (B, n, m) ``C`` held to the plain
    version's on the same card; returns the ulps of the summed channels."""
    return kgf.check_against_plain(C, graph_features(C), graph_features_plain(C))


SHAPES = ((1, 1, 1), (1, 2, 2), (1, 17, 17), (2, 17, 33), (2, 33, 17), (4, 512, 512),
          (1, 2048, 2048))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", KINDS)
def test_kernels_match_plain_on_card(cuda, kind, shape):
    C = torch.from_numpy(_inputs(kind, *shape, seed=sum(shape) + len(kind))).to(cuda)
    _hold(C)


@pytest.mark.cuda
def test_views_and_dtypes_on_card(cuda):
    """A transposed view and a float64 cost reach the kernels as a
    contiguous float32 copy, as the plain version reads them."""
    C = torch.from_numpy(_inputs("uniform", 1, 40, 24, 5)).to(cuda)
    _hold(C.transpose(-1, -2))
    _hold(C.double()[0])


@pytest.mark.cuda
def test_launches_and_no_host_sync_on_card(cuda):
    """Two launches a call, counted in ``launch.graph_features``; the call
    reads nothing back (``host_syncs`` unchanged, and no sync under
    ``set_sync_debug_mode("error")``)."""
    C = torch.from_numpy(_inputs("tie", 2, 64, 64, 9)).to(cuda)
    graph_features(C)  # loads the library and caches the length limit
    torch.cuda.synchronize()
    before = tracing.counters()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph_features(C)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    after = tracing.counters()
    assert after[LAUNCHES] - before[LAUNCHES] == 2
    assert after["host_syncs"] == before["host_syncs"]


@pytest.mark.cuda
def test_length_limit_on_card(cuda):
    """The kernels take rows and columns up to ``graph_features_max_len``
    (8192 on an H100) and the router sends longer ones to the plain
    version."""
    limit = kgf.graph_features_max_len(cuda)
    assert limit >= 2048
    for shape in ((1, limit, 3), (1, 3, limit)):
        _hold(torch.from_numpy(_inputs("uniform", *shape, seed=1)).to(cuda))
    before = tracing.counters().get(LAUNCHES, 0)
    graph_features(torch.rand(1, limit + 1, 2, device=cuda))
    assert tracing.counters().get(LAUNCHES, 0) == before
    with pytest.raises(ValueError, match="up to graph_features_max_len"):
        kgf.graph_features(torch.rand(1, 2, limit + 1, device=cuda))
