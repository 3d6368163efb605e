"""The port's solver front ends against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through each JAX function and its
port.  The host code is the same code on both sides (numpy, the native
``lapx.cpp`` copied into the port), so its results must be array-equal: the
CSR conversion and the native sparse solver at ``fp_version`` 1, 2 and 3
(with its infeasible case and every CSR validation error), ``lapmod_py``,
the three ``lap_compat`` calls, the four non-learned seeds and the five host
solver classes, on the ``data.generators`` families at n in {16, 64, 200}.
``TorchSolver`` / ``SeededTorchSolver`` (``device="cpu"``, float32 and
float64) against ``JAXSolver`` / ``SeededJAXSolver``: equal assignments,
costs within 64 ulp of the terms' magnitude (torch and XLA sum in another
order).  ``verify_solver_correctness`` passes on the full set and raises on
a NaN cost, a non-permutation and a disagreement.  Last, the ``two_min``
dtype rule: a float64 matrix gives the plain version's result, through the
plain version itself on the CPU and through the kernel on any other device.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapgnn_tpu.data.generators import FAMILIES
from lapgnn_tpu.solver import api as japi
from lapgnn_tpu.solver import lap_compat as jcompat
from lapgnn_tpu.solver import native as jnative
from lapgnn_tpu.solver import seed_baselines as jseeds
from lapgnn_tpu.solver.py_sparse import lapmod_py as j_lapmod_py
from lapgnn_tpu.solver.verification import _accepts_seed as j_accepts_seed
from lapgnn_tpu.solver.verification import verify_solver_correctness as j_verify
from lapgnn_tpu_torch.ops.cuda import twomin
from lapgnn_tpu_torch.solver import api as tapi
from lapgnn_tpu_torch.solver import lap_compat as tcompat
from lapgnn_tpu_torch.solver import native as tnative
from lapgnn_tpu_torch.solver import seed_baselines as tseeds
from lapgnn_tpu_torch.solver.py_sparse import check_cost, lapmod_py
from lapgnn_tpu_torch.solver.verification import _accepts_seed, verify_solver_correctness

FAMS = sorted(FAMILIES)
SIZES = [16, 64, 200]


def _cost(fam, n, seed=0):
    return FAMILIES[fam](n, np.random.default_rng(seed))


def _csr_instance(n, seed, density=0.3):
    """A feasible sparse instance: the cheapest ``density`` of a uniform
    matrix kept, plus the diagonal, the rest forbidden (1e6)."""
    C = _cost("uniform", n, seed)
    thresh = np.quantile(C, density)
    Cs = np.where(C <= thresh, C, 1e6)
    np.fill_diagonal(Cs, np.minimum(C.diagonal(), thresh))
    return Cs


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
            assert x.dtype == np.asarray(y).dtype
        else:
            assert x == y and type(x) is type(y)


# ---------------------------------------------------------------- native CSR


@pytest.mark.parametrize("fam", FAMS)
@pytest.mark.parametrize("n", SIZES)
def test_sparse_from_dense_array_equal(fam, n):
    C = _cost(fam, n, 5)
    C[0, 1] = np.inf
    C[1, 2] = np.nan
    _equal(tnative.sparse_from_dense(C), jnative.sparse_from_dense(C))
    _equal(tnative.sparse_from_dense(C, 0.5), jnative.sparse_from_dense(C, 0.5))


@pytest.mark.parametrize("fp", [1, 2, 3])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("density", [0.05, 0.3, 0.8])
def test_lapmod_native_array_equal(fp, n, density):
    Cs = _csr_instance(n, 11 * n + fp, density)
    rp, ci, vals = tnative.sparse_from_dense(Cs, 1e5)
    got = tnative.lapmod_native(n, rp, ci, vals, return_duals=True, fp_version=fp)
    want = jnative.lapmod_native(n, rp, ci, vals, return_duals=True, fp_version=fp)
    _equal(got, want)
    # and optimal: SciPy on the matrix with forbidden entries at 1e6
    import scipy.optimize

    r, c = scipy.optimize.linear_sum_assignment(Cs)
    assert abs(got[2] - Cs[r, c].sum()) <= 1e-12 * max(1.0, Cs[r, c].sum())


def test_lapmod_native_infeasible_raises_on_both():
    n = 6
    C = np.full((n, n), 1e6)
    C[:, 0] = 1.0  # every row can take only column 0
    rp, ci, vals = tnative.sparse_from_dense(C)
    with pytest.raises(tnative.NativeSolveError, match="-3"):
        tnative.lapmod_native(n, rp, ci, vals)
    with pytest.raises(jnative.NativeSolveError, match="-3"):
        jnative.lapmod_native(n, rp, ci, vals)


def _bad_csr():
    n = 4
    rp, ci, vals = tnative.sparse_from_dense(_cost("uniform", n, 3))
    short_rp = rp[:-1]
    down_rp = rp.copy()
    down_rp[2] = down_rp[1] - 1
    start_rp = rp + 1
    over_rp = rp.copy()
    over_rp[-1] += 3
    neg_ci = ci.copy()
    neg_ci[5] = -1
    big_ci = ci.copy()
    big_ci[7] = n
    return n, {
        "row_ptr_length": (short_rp, ci, vals),
        "row_ptr_decreasing": (down_rp, ci, vals),
        "row_ptr_start": (start_rp, ci, vals),
        "row_ptr_past_buffers": (over_rp, ci, vals),
        "col_idx_negative": (rp, neg_ci, vals),
        "col_idx_past_n": (rp, big_ci, vals),
        "values_short": (rp, ci, vals[:-2]),
    }


@pytest.mark.parametrize("case", sorted(_bad_csr()[1]))
def test_lapmod_native_csr_validation_raises_as_jax(case):
    n, cases = _bad_csr()
    args = cases[case]
    with pytest.raises(ValueError) as got:
        tnative.lapmod_native(n, *args)
    with pytest.raises(ValueError) as want:
        jnative.lapmod_native(n, *args)
    assert str(got.value) == str(want.value)


def test_native_available():
    assert tnative.native_available() is True


# ---------------------------------------------------------------- py_sparse


@pytest.mark.parametrize("n", SIZES)
def test_lapmod_py_array_equal(n):
    Cs = _csr_instance(n, 3 * n)
    rp, ci, vals = tnative.sparse_from_dense(Cs, 1e5)
    got = lapmod_py(n, rp, ci, vals)
    _equal(got, j_lapmod_py(n, rp, ci, vals))
    assert abs(got[2] - tnative.lapmod_native(n, rp, ci, vals)[2]) <= 1e-12 * max(1.0, got[2])


def test_lapmod_py_errors_as_jax():
    with pytest.raises(ValueError, match="negative"):
        check_cost(np.array([1.0, -1.0]))
    with pytest.raises(ValueError, match="below"):
        check_cost(np.array([1.0, 2e6]))
    n = 3
    C = np.full((n, n), 1e6)
    C[:, 0] = 1.0
    rp, ci, vals = tnative.sparse_from_dense(C)
    for fn in (lapmod_py, j_lapmod_py):
        with pytest.raises(ValueError, match="no perfect matching"):
            fn(n, rp, ci, vals)
        with pytest.raises(ValueError, match="n\\+1"):
            fn(n, rp[:-1], ci, vals)


# ---------------------------------------------------------------- lap_compat


@pytest.mark.parametrize("fam", FAMS)
@pytest.mark.parametrize("n", SIZES)
def test_lapjv_square_array_equal(fam, n):
    C = _cost(fam, n, 21)
    _equal(tcompat.lapjv(C), jcompat.lapjv(C))
    _equal(tcompat.lapjv(C, return_cost=False), jcompat.lapjv(C, return_cost=False))


@pytest.mark.parametrize("shape", [(16, 24), (24, 16), (64, 200), (200, 64)])
def test_lapjv_extend_cost_array_equal(shape):
    C = np.random.default_rng(sum(shape)).random(shape)
    _equal(tcompat.lapjv(C, extend_cost=True), jcompat.lapjv(C, extend_cost=True))
    for fn in (tcompat.lapjv, jcompat.lapjv):
        with pytest.raises(ValueError, match="Square cost array expected"):
            fn(C)
        with pytest.raises(ValueError, match="Square cost array expected"):
            fn(C, cost_limit=0.5)


@pytest.mark.parametrize("shape", [(16, 16), (16, 24), (64, 64), (200, 64)])
@pytest.mark.parametrize("limit", [0.05, 0.5])
def test_lapjv_cost_limit_array_equal(shape, limit):
    C = np.random.default_rng(shape[0] + 7 * shape[1]).random(shape)
    got = tcompat.lapjv(C, extend_cost=True, cost_limit=limit)
    _equal(got, jcompat.lapjv(C, extend_cost=True, cost_limit=limit))
    if limit < 0.1:
        assert (got[1] == -1).any()  # the tight limit leaves rows unmatched


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("fp", [tcompat.FP_1, tcompat.FP_2, tcompat.FP_DYNAMIC])
def test_lapmod_compat_array_equal(n, fp):
    Cs = _csr_instance(n, 5 * n + fp)
    rp, ci, vals = tnative.sparse_from_dense(Cs, 1e5)
    got = tcompat.lapmod(n, vals, rp, ci, fp_version=fp)
    _equal(got, jcompat.lapmod(n, vals, rp, ci, fp_version=fp))
    _equal(tcompat.lapmod(n, vals, rp, ci, return_cost=False),
           jcompat.lapmod(n, vals, rp, ci, return_cost=False))


def test_lapmod_compat_errors_as_jax():
    n = 4
    rp, ci, vals = tnative.sparse_from_dense(_cost("uniform", n, 2))
    bad = [
        (0, vals, rp, ci),
        (n, vals, rp[:-1], ci),
        (n, vals[:0], np.zeros(n + 1, np.int64), ci[:0]),
        (n, vals - 2.0, rp, ci),
        (n, vals + 2e6, rp, ci),
    ]
    for args in bad:
        with pytest.raises(ValueError) as got:
            tcompat.lapmod(*args)
        with pytest.raises(ValueError) as want:
            jcompat.lapmod(*args)
        assert type(got.value) is type(want.value)
    assert (tcompat.LARGE, tcompat.FP_1, tcompat.FP_2, tcompat.FP_DYNAMIC) == (
        jcompat.LARGE, jcompat.FP_1, jcompat.FP_2, jcompat.FP_DYNAMIC)


@pytest.mark.parametrize("shape", [(16, 16), (64, 64), (200, 200), (16, 24), (64, 16)])
def test_lapjv_seeded_compat_array_equal(shape):
    rng = np.random.default_rng(shape[0] * 3 + shape[1])
    C = rng.random(shape)
    u = rng.random(shape[0]) * 0.1
    v = rng.random(shape[1]) * 0.1
    _equal(tcompat.lapjv_seeded(C, u, v), jcompat.lapjv_seeded(C, u, v))
    for fn in (tcompat.lapjv_seeded, jcompat.lapjv_seeded):
        with pytest.raises(ValueError, match="seed lengths"):
            fn(C, u[:-1], v)


# ---------------------------------------------------------------- seeds


@pytest.mark.parametrize("fam", FAMS)
@pytest.mark.parametrize("n", SIZES)
def test_seed_baselines_array_equal(fam, n):
    C = _cost(fam, n, 9)
    _equal(tseeds.seed_row_col_minima(C), jseeds.seed_row_col_minima(C))
    _equal(tseeds.seed_rank1_analytic(C), jseeds.seed_rank1_analytic(C))
    _equal(tseeds.seed_greedy_matching(C, rng=np.random.default_rng(1)),
           jseeds.seed_greedy_matching(C, rng=np.random.default_rng(1)))
    _equal(tseeds.seed_noisy_optimal(C, rng=np.random.default_rng(2)),
           jseeds.seed_noisy_optimal(C, rng=np.random.default_rng(2)))


# ---------------------------------------------------------------- solver classes

HOST_CLASSES = [
    ("SciPySolver", {}),
    ("LAPSolver", {}),
    ("SeededLAPSolver", {}),
    ("LAPMODSolver", {}),
    ("LAPMODSolver", {"forbidden_threshold": 0.6, "sentinel": 100.0, "fp_version": 1}),
    ("WarmStartLAPSolver", {}),
    ("WarmStartLAPSolver", {"backend": "scipy"}),
]


@pytest.mark.parametrize("fam", FAMS)
@pytest.mark.parametrize("n", SIZES)
def test_host_solver_classes_array_equal(fam, n):
    C = _cost(fam, n, 13)
    u, v = tseeds.seed_row_col_minima(C)
    for cls, kw in HOST_CLASSES:
        got_s, want_s = getattr(tapi, cls)(**kw), getattr(japi, cls)(**kw)
        assert got_s.name == want_s.name
        if _accepts_seed(got_s.solve):
            got, want = got_s.solve(C, u=u, v=v), want_s.solve(C, u=u, v=v)
        else:
            got, want = got_s.solve(C), want_s.solve(C)
        _equal(got, want)


@pytest.mark.parametrize("n", [16, 64])
def test_lapmod_solver_routes(n):
    """Sparse route on a feasible instance; the dense answer with a scaled
    sentinel when the allowed edges admit no perfect matching (costs above
    1e6 are rescaled on the sparse route)."""
    C = _csr_instance(n, 3)
    s = tapi.LAPMODSolver(forbidden_threshold=1e5)
    _equal(s.solve(C), japi.LAPMODSolver(forbidden_threshold=1e5).solve(C))
    assert s.last_route == "sparse"
    big = _cost("uniform", n, 4) * 5e6
    s = tapi.LAPMODSolver(forbidden_threshold=np.inf)
    _equal(s.solve(big), japi.LAPMODSolver(forbidden_threshold=np.inf).solve(big))
    assert s.last_route == "sparse"
    bad = _cost("uniform", n, 5)
    bad[:, 1:] = 2e6
    bad[0, 1:] = 0.5  # row 0 alone reaches columns 1..n-1
    s = tapi.LAPMODSolver()
    got = s.solve(bad)
    _equal(got, japi.LAPMODSolver().solve(bad))
    assert s.last_route == "dense_fallback"


@functools.lru_cache(maxsize=None)
def _jax_solvers(dtype_name):
    dt = {"float32": jnp.float32, "float64": jnp.float64}[dtype_name]
    return japi.JAXSolver(dtype=dt), japi.SeededJAXSolver(dtype=dt)


def _ulp_tol(C, x, dtype):
    terms = np.abs(np.asarray(C, np.float64)[np.arange(len(x)), x]).sum()
    return 64 * np.finfo(dtype).eps * max(terms, np.finfo(dtype).tiny)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fam", FAMS)
def test_torch_solvers_match_jax(dtype, fam):
    """One n (48) for every family: JAX compiles once a dtype."""
    n = 48
    C = _cost(fam, n, 31)
    u, v = tseeds.seed_rank1_analytic(C)
    tdt = getattr(torch, dtype)
    j_cold, j_seeded = _jax_solvers(dtype)
    t_cold = tapi.TorchSolver(dtype=tdt, device="cpu")
    t_seeded = tapi.SeededTorchSolver(dtype=tdt, device="cpu")
    assert (t_cold.name, t_seeded.name) == ("torch", "seeded_torch")
    for got, want in ((t_cold.solve(C), j_cold.solve(C)),
                      (t_seeded.solve(C, u=u, v=v), j_seeded.solve(C, u=u, v=v)),
                      (t_seeded.solve(C), j_seeded.solve(C))):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == np.int64
        assert abs(got[2] - want[2]) <= _ulp_tol(C, got[1], getattr(np, dtype))


def test_torch_solvers_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for cls in (tapi.TorchSolver, tapi.SeededTorchSolver):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
        assert cls(device="cpu").dtype == torch.float32


# ---------------------------------------------------------------- verification


def _full_set():
    return [tapi.SciPySolver(), tapi.LAPSolver(), tapi.SeededLAPSolver(),
            tapi.TorchSolver(dtype=torch.float64, device="cpu"),
            tapi.SeededTorchSolver(dtype=torch.float64, device="cpu"),
            tapi.LAPMODSolver(), tapi.WarmStartLAPSolver()]


@pytest.mark.parametrize("fam", ["uniform", "sparse", "tie"])
def test_verify_solver_correctness_full_set(fam):
    C = _cost(fam, 40, 17)
    u, v = tseeds.seed_row_col_minima(C)
    got = verify_solver_correctness(C, _full_set(), u=u, v=v)
    assert list(got) == ["scipy", "lap", "seeded_lap", "torch", "seeded_torch",
                         "lapmod", "warmstart_reduced"]
    want = j_verify(C, u=u, v=v)
    assert got["scipy"] == want["scipy"] and got["seeded_lap"] == want["seeded_lap"]
    assert verify_solver_correctness(C) == want  # the default set


class _Bad:
    def __init__(self, name, how):
        self.name, self.how = name, how

    def solve(self, C):
        n = C.shape[0]
        rows, cols = np.arange(n), np.arange(n)
        cost = float(C[rows, cols].sum())
        if self.how == "nan":
            return rows, cols, float("nan")
        if self.how == "not_permutation":
            cols = cols.copy()
            cols[1] = cols[0]
            return rows, cols, float(C[rows, cols].sum())
        return rows, cols, cost  # the identity: not optimal


@pytest.mark.parametrize("how, match", [("nan", "reported cost"),
                                        ("not_permutation", "not a permutation"),
                                        ("disagrees", "disagreement")])
def test_verify_solver_correctness_raises_as_jax(how, match):
    C = _cost("uniform", 24, 4)
    for verify in (verify_solver_correctness, j_verify):
        with pytest.raises(AssertionError, match=match):
            verify(C, [tapi.SciPySolver(), _Bad("bad", how)])


def test_verify_solver_correctness_nan_in_cost_fails():
    """A NaN row: every assignment's recomputed cost is NaN, so the gate
    fails (NaN compares false) on both sides, even for a solver that reports
    that NaN itself."""
    C = _cost("uniform", 12, 4)
    C[3, :] = np.nan
    for verify in (verify_solver_correctness, j_verify):
        with pytest.raises(AssertionError, match="reported cost"):
            verify(C, [_Bad("identity", "disagrees")])


def _seeded(C, u=None, v=None):
    return C


def _kwargs(C, **kw):
    return C


def _u_only(C, u=None):
    return C


def _plain(C):
    return C


@pytest.mark.parametrize("fn, accepts", [
    (_seeded, True), (_kwargs, True), (_u_only, False), (_plain, False),
    (max, False), (tapi.SeededTorchSolver.solve, True), (tapi.TorchSolver.solve, False),
    (functools.partial(_seeded, u=None), True),
])
def test_accepts_seed_as_jax(fn, accepts):
    assert _accepts_seed(fn) is accepts
    assert j_accepts_seed(fn) is accepts


# ---------------------------------------------------------------- two_min dtype


def test_two_min_float64_takes_the_plain_version_on_every_device():
    """A float64 matrix gives ``two_min_plain``'s result: on the CPU through
    the plain version (no launch); on any other device float64 and float32
    alike reach the kernel, whose wrapper raises for a device it cannot
    launch on (the meta device stands in for the GPU) and never answers with
    the plain version instead."""
    rng = np.random.default_rng(0)
    C = torch.from_numpy(rng.random((3, 20, 20)))
    v = torch.from_numpy(rng.random((3, 20)))
    got = twomin.two_min(C, v)
    want = twomin.two_min_plain(C, v)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[0].dtype == torch.float64 and got[2].dtype == torch.int32
    before = twomin.two_min.launches
    for dt in (torch.float64, torch.float32):
        with pytest.raises(ValueError, match="unsupported device meta"):
            twomin.two_min(C.to("meta", dt), v.to("meta", dt))
    assert twomin.two_min.launches == before
    # the float32 CPU path is unchanged (the card's side of the rule is
    # tests/test_torch_kernels.py::test_two_min_float64_launches_the_kernel_on_card)
    got32 = twomin.two_min(C.float(), v.float())
    for g, w in zip(got32, twomin.two_min_plain(C.float(), v.float())):
        assert torch.equal(g, w)
