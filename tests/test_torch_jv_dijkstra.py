"""The port's pop-at-a-time Dijkstra augmenters against the JAX ones.

``augment_all`` and ``augment_all_multisource`` (``lapgnn_tpu_torch.solver.jv``)
are held bit for bit to ``lapgnn_tpu.solver.jv``'s on the same float32
inputs: the assignment (x, y) and the column duals v.  Each starts from the
same matching, made by JAX: its ``column_reduction``, and a greedy partial
matching (``greedy_tight_matching`` on the tight edges of the row and column
minima), on the eight generator families at n in {16, 64, 200}.  A NaN entry
and an all-inf row must stop both within their bounds (n + 1 rounds of at
most n + 1 pops) with JAX's partial result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapgnn_tpu.data.generators import FAMILIES
from lapgnn_tpu.solver import jv as jjv
from lapgnn_tpu.solver import seeded as jseeded
from lapgnn_tpu_torch.solver import jv as tjv
from lapgnn_tpu_torch.solver import augment_all, augment_all_multisource

SIZES = [16, 64, 200]
AUGMENTERS = {
    "augment_all": (jax.jit(jjv.augment_all), augment_all),
    "augment_all_multisource": (jax.jit(jjv.augment_all_multisource), augment_all_multisource),
}


def _cost(fam, n):
    return FAMILIES[fam](n, np.random.default_rng(1000 + n)).astype(np.float32)


_column_reduction = jax.jit(jjv.column_reduction)


@jax.jit
def _greedy_start(C):
    v = jnp.min(C, axis=0)
    u = jnp.min(C - v[None, :], axis=1)
    x, y = jseeded.greedy_tight_matching(jnp.abs(C - u[:, None] - v[None, :]) <= 1e-6)
    return jjv.Matching(x, y, v)


def _start(C, kind):
    Cj = jnp.asarray(C)
    return _column_reduction(Cj) if kind == "column_reduction" else _greedy_start(Cj)


def _to_torch(m):
    return tjv.Matching(*(torch.from_numpy(np.array(a, copy=True)).to(
        torch.int64 if np.asarray(a).dtype.kind == "i" else torch.float32) for a in m))


def _assert_equal(jm, tm):
    np.testing.assert_array_equal(np.asarray(jm.col_of_row), tm.col_of_row.numpy())
    np.testing.assert_array_equal(np.asarray(jm.row_of_col), tm.row_of_col.numpy())
    jv_ = np.asarray(jm.v)
    assert jv_.dtype == np.float32
    np.testing.assert_array_equal(jv_.view(np.uint32), tm.v.numpy().view(np.uint32))


def _run(C, start, name):
    j_aug, t_aug = AUGMENTERS[name]
    jm = j_aug(jnp.asarray(C), start)
    stats = tjv.SolveStats()
    tm = t_aug(torch.from_numpy(C), _to_torch(start), stats)
    return jm, tm, stats


@pytest.mark.parametrize("name", list(AUGMENTERS))
@pytest.mark.parametrize("start", ["column_reduction", "greedy"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_augmenter_bit_equal_to_jax(fam, n, start, name):
    C = _cost(fam, n)
    s = _start(C, start)
    jm, tm, stats = _run(C, s, name)
    _assert_equal(jm, tm)
    x = tm.col_of_row.numpy()
    assert sorted(x.tolist()) == list(range(n)), "the matching is not complete"
    assert stats.aug_rounds == int((np.asarray(s.col_of_row) < 0).sum())  # one row a round


def _poisoned(kind, n=16):
    C = _cost("uniform", n)
    if kind == "nan":
        C[3, 5] = np.nan
    else:
        C[7, :] = np.inf
    return C


@pytest.mark.parametrize("name", list(AUGMENTERS))
@pytest.mark.parametrize("kind", ["nan", "inf_row"])
def test_poisoned_input_stops_within_bounds(kind, name):
    n = 16
    C = _poisoned(kind, n)
    s = _start(C, "column_reduction")
    jm, tm, stats = _run(C, s, name)
    np.testing.assert_array_equal(np.asarray(jm.col_of_row), tm.col_of_row.numpy())
    np.testing.assert_array_equal(np.asarray(jm.row_of_col), tm.row_of_col.numpy())
    np.testing.assert_array_equal(np.asarray(jm.v), tm.v.numpy())  # NaN == NaN here
    assert stats.aug_rounds <= n + 1
    assert stats.pops <= stats.aug_rounds * (n + 1)
    assert stats.flip_steps <= stats.aug_rounds * (n + 1)
