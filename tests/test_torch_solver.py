"""The port's device solver (``lapgnn_tpu_torch.solver``) against the JAX one.

Inputs are float32, made with numpy from a seed and handed to both; JAX runs
on the CPU (its Pallas kernel in interpret mode, as tests/test_pallas.py runs
it) and is checked to compute in float32 too, so every constant is rounded
alike.  Assignments and fallback flags must be equal and the duals v equal
bit for bit.  The float32 solver is exact up to its polish threshold
``8 * eps32 * (1 + max|C|)`` per row, so its cost is held to SciPy's optimum
within n times that (the tie family's 1e-6 jitter lies below it; the
pipeline's float64 certificate restores exactness there).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize
import torch

from lapgnn_tpu.data.generators import FAMILIES
from lapgnn_tpu.ops.pallas import pallas_two_min
from lapgnn_tpu.solver import jv as jjv
from lapgnn_tpu.solver import seeded as jseeded
from lapgnn_tpu_torch.ops.cuda import two_min
from lapgnn_tpu_torch.ops.cuda.twomin import two_min_plain
from lapgnn_tpu_torch.solver import jv as tjv
from lapgnn_tpu_torch.solver import seeded as tseeded
from test_golden import GOLDEN

SLICE_FAMS = ["uniform", "noisy_linear", "sparse", "tie"]
GATES = ["density", "free_rows", "both", "never"]
N = 64

_j_seeded = jax.jit(jseeded.lapjv_seeded_single, static_argnames=("gate",))
_j_arr = jax.jit(jseeded.jacobi_arr, static_argnames=("max_rounds",))


def _cost(fam, n, seed):
    return FAMILIES[fam](n, np.random.default_rng(seed)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _np(a):
    return np.asarray(a)


def _bits(a):
    a = _np(a)
    assert a.dtype == np.float32, a.dtype
    return a.view(np.uint32)


def _assert_matching_equal(jm, tm):
    np.testing.assert_array_equal(_np(jm.col_of_row), tm.col_of_row.numpy())
    np.testing.assert_array_equal(_np(jm.row_of_col), tm.row_of_col.numpy())
    np.testing.assert_array_equal(_bits(jm.v), _bits(tm.v))


def _scipy_cost(C):
    C64 = np.asarray(C, np.float64)
    r, c = scipy.optimize.linear_sum_assignment(C64)
    return float(C64[r, c].sum())


def _assert_f32_optimal(C, x):
    """A permutation whose float64 cost is SciPy's optimum within the
    float32 solver's polish threshold per row."""
    n = C.shape[0]
    assert sorted(x.tolist()) == list(range(n))
    got = float(np.asarray(C, np.float64)[np.arange(n), x].sum())
    bound = n * 8 * np.finfo(np.float32).eps * (1 + np.abs(C).max())
    assert got - _scipy_cost(C) <= bound


# ---------------------------------------------------------------- pieces


@pytest.mark.parametrize("rnd", [1, 2, 7, 4093, 123456789])
def test_hash_scores_bit_equal(rnd):
    want = _np(jseeded._hash_scores(N, jnp.asarray(rnd, jnp.int32)))
    got = tseeded._hash_scores(N, rnd).numpy()
    assert want.dtype == got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() <= 0x7FFFFFFE


@pytest.mark.parametrize("case", ["random", "all_tight"])
def test_greedy_tight_matching_equal(case):
    if case == "random":
        tight = np.random.default_rng(6).random((N, N)) < 0.15
    else:
        tight = np.ones((N, N), bool)
    jx, jy = jseeded.greedy_tight_matching(jnp.asarray(tight))
    stats = tjv.SolveStats()
    tx, ty = tseeded.greedy_tight_matching(_t(tight), stats)
    np.testing.assert_array_equal(tx.numpy(), _np(jx))
    np.testing.assert_array_equal(ty.numpy(), _np(jy))
    assert stats.greedy_rounds >= 1 and stats.host_syncs == stats.greedy_rounds
    if case == "all_tight":
        assert sorted(tx.tolist()) == list(range(N))


@pytest.mark.parametrize("fam", ["uniform", "tie", "metric", "sparse"])
def test_column_reduction_and_jacobi_arr_equal(fam, monkeypatch):
    """column_reduction and jacobi_arr give the JAX Matchings; jacobi_arr
    through K4's plain version and through the JAX module's in-line
    three-pass bid give the same Matching."""
    C = _cost(fam, N, 3)
    Cj, Ct = jnp.asarray(C), _t(C)
    jm, tm = jjv.column_reduction(Cj), tjv.column_reduction(Ct)
    _assert_matching_equal(jm, tm)

    want = _j_arr(Cj, jm, max_rounds=32)
    got = tseeded.jacobi_arr(Ct, tm, max_rounds=32)
    _assert_matching_equal(want, got)

    def three_pass(C, v):
        red = C - v[None, :]
        j1 = torch.argmin(red, dim=1)
        min1 = torch.take_along_dim(red, j1[:, None], dim=1)[:, 0]
        cols = torch.arange(C.shape[-1])[None, :]
        min2 = torch.where(cols == j1[:, None], float("inf"), red).amin(1)
        return min1, min2, j1

    monkeypatch.setattr(tseeded, "two_min", three_pass)
    _assert_matching_equal(want, tseeded.jacobi_arr(Ct, tm, max_rounds=32))


def test_n1_column_reduction_finite_duals():
    m = tjv.column_reduction(torch.tensor([[3.5]]))
    assert int(m.col_of_row[0]) == 0 and torch.isfinite(m.v).all()


@pytest.mark.parametrize("fam", ["uniform", "tie", "metric"])
def test_augment_all_sweep_equal(fam):
    C = _cost(fam, N, 4)
    Cj, Ct = jnp.asarray(C), _t(C)
    want = jjv.augment_all_sweep(Cj, jjv.column_reduction(Cj))
    stats = tjv.SolveStats()
    got = tjv.augment_all_sweep(Ct, tjv.column_reduction(Ct), stats)
    _assert_matching_equal(want, got)
    _assert_f32_optimal(C, got.col_of_row.numpy())
    # one sync per round's condition, per sweep, and two per round's flip
    assert stats.host_syncs == 1 + stats.aug_rounds * 3 + stats.sweeps
    assert stats.flip_steps >= stats.aug_rounds


@pytest.mark.parametrize("flip", ["disjoint", "single"])
def test_flip_paths_cap_and_fallback(flip):
    """A sink whose path runs past _PATH_CAP hops is skipped; when every
    candidate is, the first sink's path is flipped uncapped (jv.py:514-530),
    as ``_flip_single_path`` flips it.  Rows 1..80 hold columns 0..79 (row r
    holds column r - 1), row 0 is free, and both candidate sinks lead
    through row 80 down the chain to row 0: 81 hops each."""
    n = 96
    x = np.full(n, -1, np.int64)
    y = np.full(n, -1, np.int64)
    pred = np.zeros(n, np.int64)
    for r in range(1, 81):
        x[r], y[r - 1] = r - 1, r
    pred[:80] = np.arange(80)
    pred[[85, 90]] = 80
    cand = np.zeros(n, bool)
    cand[[85, 90]] = True
    jargs = [jnp.asarray(a, jnp.int32) for a in (x, y, pred)]
    stats = tjv.SolveStats()
    if flip == "disjoint":
        want = jjv._flip_disjoint_paths(*jargs, jnp.asarray(cand))
        got = tjv._flip_disjoint_paths(_t(x), _t(y), _t(pred), _t(cand), stats)
    else:
        want = jjv._flip_single_path(*jargs, jnp.asarray(85, jnp.int32))
        got = tjv._flip_single_path(_t(x), _t(y), _t(pred), 85, stats)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    assert got[0][0].item() == 0 and got[1][85].item() == 80  # the chain flipped
    assert stats.flip_steps == (64 + 64 + 81 if flip == "disjoint" else 81)
    assert stats.host_syncs == 2


# ---------------------------------------------------------------- K4


@pytest.mark.parametrize("fam", ["uniform", "tie", "sparse"])
@pytest.mark.parametrize("n", [64, 128])
def test_two_min_plain_bit_equal_pallas(fam, n):
    C = _cost(fam, n, 5)
    v = np.random.default_rng(n).normal(0, 0.2, n).astype(np.float32)
    w1, w2, wj = pallas_two_min(jnp.asarray(C), jnp.asarray(v), interpret=True)
    g1, g2, gj = two_min(_t(C), _t(v))
    assert gj.dtype == torch.int32
    np.testing.assert_array_equal(gj.numpy(), _np(wj))
    np.testing.assert_array_equal(_bits(g1.numpy()), _bits(w1))
    np.testing.assert_array_equal(_bits(g2.numpy()), _bits(w2))


def test_two_min_plain_special_rows_and_batch():
    """Ties give min2 == min1; +-inf order as numbers; a NaN counts as the
    smallest (first NaN wins) and makes min2 NaN only if another NaN is in
    the row; a batch equals its instances."""
    inf, nan = float("inf"), float("nan")
    C = torch.tensor([
        [3.0, 1.0, 1.0, 2.0],
        [inf, -inf, 0.0, -inf],
        [inf, inf, inf, inf],
        [2.0, nan, 0.5, 1.0],
        [nan, 1.0, nan, 0.0],
    ])
    min1, min2, arg = two_min_plain(C, torch.zeros(4))
    assert arg.tolist() == [1, 1, 0, 1, 0]
    assert min1[:3].tolist() == [1.0, -inf, inf] and min2[:3].tolist() == [1.0, -inf, inf]
    assert torch.isnan(min1[3:]).all() and min2[3].item() == 0.5 and torch.isnan(min2[4])
    Cb = torch.rand(3, 8, 8)
    vb = torch.rand(3, 8)
    batched = two_min_plain(Cb, vb)
    for b in range(3):
        for part, whole in zip(two_min_plain(Cb[b], vb[b]), batched):
            assert torch.equal(part, whole[b])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [257, 1024])
def test_two_min_kernel_matches_plain_on_card(cuda, n):
    C = np.stack([_cost("uniform", n, 19), _cost("tie", n, 20)])
    C[0, 3, 5] = np.inf
    C[0, 4, [2, 9]] = -np.inf
    C[1, 7, 11] = np.nan
    v = np.random.default_rng(21).normal(0, 0.3, (2, n)).astype(np.float32)
    Cd, vd = _t(C).to(cuda), _t(v).to(cuda)
    before = two_min.launches
    got = two_min(Cd, vd)
    assert two_min.launches == before + 1
    want = two_min_plain(Cd, vd)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        assert torch.equal(g[ok].view(torch.int32), w[ok].view(torch.int32))
    with pytest.raises(TypeError):
        two_min(Cd.double(), vd.double())
    with pytest.raises(ValueError):
        two_min(Cd, vd[:, :-1].contiguous())


# ---------------------------------------------------------------- whole solves


@pytest.fixture(scope="module")
def seeded_cases():
    """Per family: the matrix, a min-trick seed and a garbage seed."""
    out = {}
    for k, fam in enumerate(SLICE_FAMS):
        C = _cost(fam, N, 30 + k)
        rng = np.random.default_rng(40 + k)
        u = (C.min(1) + rng.normal(0, 0.02, N)).astype(np.float32)
        seeds = {
            "min_trick": (u, (C - u[:, None]).min(0)),
            "garbage": (rng.normal(0, 100, N).astype(np.float32),
                        rng.normal(0, 100, N).astype(np.float32)),
        }
        out[fam] = (C, seeds)
    return out


@pytest.mark.parametrize("gate", GATES)
@pytest.mark.parametrize("seed_kind", ["min_trick", "garbage"])
@pytest.mark.parametrize("fam", SLICE_FAMS)
def test_seeded_single_matches_jax(seeded_cases, fam, seed_kind, gate):
    C, seeds = seeded_cases[fam]
    u, v = seeds[seed_kind]
    want = _j_seeded(jnp.asarray(C), jnp.asarray(u), jnp.asarray(v), gate=gate)
    stats = tjv.SolveStats()
    got = tseeded.lapjv_seeded_single(_t(C), _t(u), _t(v), gate=gate, stats=stats)
    np.testing.assert_array_equal(got.col_of_row.numpy(), _np(want.col_of_row))
    np.testing.assert_array_equal(got.row_of_col.numpy(), _np(want.row_of_col))
    assert bool(got.used_fallback) == bool(want.used_fallback)
    np.testing.assert_array_equal(_bits(got.v), _bits(want.v))
    assert _np(want.cost).dtype == np.float32
    # summation order of the f32 cost differs from XLA's
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-6)
    _assert_f32_optimal(C, got.col_of_row.numpy())
    assert stats.host_syncs > stats.greedy_rounds + stats.arr_rounds + stats.sweeps


def test_garbage_seed_takes_the_fallback(seeded_cases):
    C, seeds = seeded_cases["uniform"]
    stats = tjv.SolveStats(timed=True)
    res = tseeded.lapjv_seeded_single(_t(C), *map(_t, seeds["garbage"]), gate="density",
                                      stats=stats)
    assert bool(res.used_fallback)
    assert set(stats.stage_ms) == {"project_tighten", "greedy", "arr", "augment", "polish"}
    assert stats.greedy_rounds >= 1 and stats.arr_rounds >= 1
    with pytest.raises(ValueError):
        tseeded.lapjv_seeded_single(_t(C), *map(_t, seeds["garbage"]), gate="x")


def test_seeded_batch_equals_single(seeded_cases):
    Cs = np.stack([seeded_cases[f][0] for f in ("uniform", "sparse")])
    us = np.stack([seeded_cases[f][1]["min_trick"][0] for f in ("uniform", "sparse")])
    vs = np.stack([seeded_cases[f][1]["min_trick"][1] for f in ("uniform", "sparse")])
    batch = tseeded.lapjv_seeded_batch(_t(Cs), _t(us), _t(vs), gate="both")
    for b in range(2):
        one = tseeded.lapjv_seeded_single(_t(Cs[b]), _t(us[b]), _t(vs[b]), gate="both")
        for part, whole in zip(one, batch):
            assert torch.equal(part, whole[b])


@pytest.mark.parametrize("name,C,opt,atol", GOLDEN, ids=[g[0] for g in GOLDEN])
def test_lapjv_single_matches_golden(name, C, opt, atol):
    """The cold solve in float64 on the CPU reproduces the hard-coded optima
    (tests/test_golden.py), to the JAX solver's tolerance there."""
    x, y, cost = tjv.lapjv_single(torch.from_numpy(C))
    assert abs(float(cost) - opt) <= max(atol, 1e-9 * opt)
    np.testing.assert_array_equal(y[x].numpy(), np.arange(C.shape[0]))


def test_lapjv_batch_matches_jax():
    Cs = np.stack([_cost("uniform", 32, 50), _cost("metric", 32, 51)])
    jx, jy, jc = jjv.lapjv_batch(jnp.asarray(Cs))
    tx, ty, tc = tjv.lapjv_batch(_t(Cs))
    np.testing.assert_array_equal(tx.numpy(), _np(jx))
    np.testing.assert_array_equal(ty.numpy(), _np(jy))
    np.testing.assert_allclose(tc.numpy(), _np(jc), rtol=1e-6)


def test_nan_row_returns_instead_of_hanging():
    """A NaN row: every loop is bounded, so the solve returns a partial
    matching or a NaN cost, never a silently wrong finite answer."""
    n = 16
    C = np.random.default_rng(0).uniform(0, 1, (n, n)).astype(np.float32)
    C[3, :] = np.nan
    u = np.zeros(n, np.float32)
    v = np.nanmin(C, axis=0).astype(np.float32)
    t0 = time.time()
    res = tseeded.lapjv_seeded_single(_t(C), _t(u), _t(v), gate="never")
    assert time.time() - t0 < 60.0
    assert (res.col_of_row < 0).any() or torch.isnan(res.cost)
