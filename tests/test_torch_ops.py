"""The port's ops and kernels' plain versions against the JAX package.

Inputs come from ``lapgnn_tpu.data.generators.FAMILIES`` with numpy seeds,
as float32; JAX runs on the CPU, its Pallas kernels in interpret mode as
tests/test_pallas.py runs them.  Tests marked ``cuda`` hold each hand-written
kernel against its plain version on the card and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lapgnn_tpu.data.generators import FAMILIES
from lapgnn_tpu.ops import dual as jdual
from lapgnn_tpu.ops import features as jfeat
from lapgnn_tpu.ops import rank1 as jrank1
from lapgnn_tpu.ops import sinkhorn as jsink
from lapgnn_tpu.ops.pallas import pallas_col_min, pallas_min_trick
from lapgnn_tpu.ops.pallas.features import pallas_row_features_stats
from lapgnn_tpu.train.loss import clip_cost_sentinels as j_clip
from lapgnn_tpu_torch.ops import dual as tdual
from lapgnn_tpu_torch.ops import features as tfeat
from lapgnn_tpu_torch.ops import rank1 as trank1
from lapgnn_tpu_torch.ops import sinkhorn as tsink
from lapgnn_tpu_torch.ops.cuda import WRAPPERS, col_min, min_trick, row_features_stats, two_min
from lapgnn_tpu_torch.ops.cuda.colmin import col_min_plain, min_trick_plain
from lapgnn_tpu_torch.ops.cuda.features import (
    _from_key,
    _to_key,
    row_features_stats_plain,
)
from lapgnn_tpu_torch.ops.cuda.twomin import two_min_plain
from lapgnn_tpu_torch.ops.sentinels import clip_cost_sentinels as t_clip

KERNEL_FAMS = ["uniform", "noisy_linear", "tie", "sparse", "metric"]
SEED_FAMS = ["uniform", "noisy_linear", "tie", "sparse"]
# K3 against its transcription and the sort path: float sums run in another
# order (the tolerance of tests/test_pallas.py's parity test).
K3_RTOL, K3_ATOL = 2e-5, 2e-6


def _cost(fam, n, seed=0):
    return FAMILIES[fam](n, np.random.default_rng(seed)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# ---------------------------------------------------------------- kernels' plain versions


@pytest.mark.parametrize("fam", KERNEL_FAMS)
@pytest.mark.parametrize("n", [31, 64])
def test_col_min_plain_bit_equal_pallas(fam, n):
    C = _cost(fam, n)
    want = np.asarray(pallas_col_min(jnp.asarray(C), interpret=True))
    got = col_min(_t(C)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("fam", KERNEL_FAMS)
@pytest.mark.parametrize("n", [31, 64])
def test_min_trick_plain_bit_equal_pallas(fam, n):
    C = _cost(fam, n)
    u = np.random.default_rng(1).normal(0, 0.3, n).astype(np.float32)
    want = np.asarray(pallas_min_trick(jnp.asarray(C), jnp.asarray(u), interpret=True))
    got = min_trick(_t(C), _t(u)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("fam", KERNEL_FAMS)
@pytest.mark.parametrize("n", [31, 64])
def test_row_features_stats_plain_matches_pallas(fam, n):
    C = _cost(fam, n)
    want = np.asarray(pallas_row_features_stats(jnp.asarray(C), interpret=True))
    got = row_features_stats(_t(C)).numpy()
    assert got.shape == (n, 13)
    np.testing.assert_allclose(got, want, rtol=K3_RTOL, atol=K3_ATOL)


@pytest.mark.parametrize("fam", KERNEL_FAMS)
@pytest.mark.parametrize("n", [31, 64])
def test_row_features_matches_jax(fam, n):
    C = _cost(fam, n)
    want = np.asarray(jfeat.row_features(jnp.asarray(C)))
    got = tfeat.row_features(_t(C)).numpy()
    assert got.shape == (n, 21)
    np.testing.assert_allclose(got, want, rtol=K3_RTOL, atol=K3_ATOL)


def test_fast_row_features_batched_matches_sort_path():
    """The router on a CPU batch (K3's plain version + positional channels)
    against the port's independent sort-based row_features."""
    C = np.stack([_cost("uniform", 48, 2), _cost("tie", 48, 3)])
    got = tfeat.fast_row_features(_t(C)).numpy()
    want = tfeat.row_features(_t(C)).numpy()
    assert got.shape == (2, 48, 21)
    # difficulty: span/(m-1) here, the mean of sorted differences there
    np.testing.assert_allclose(got, want, rtol=K3_RTOL, atol=K3_ATOL)


def test_positional_encodings_match_jax():
    for n in (1, 7, 64):
        np.testing.assert_allclose(
            tfeat.positional_encodings(n).numpy(),
            np.asarray(jfeat.positional_encodings(n)),
            rtol=1e-6, atol=1e-6,
        )


def test_key_map_matches_jax_and_splits_signed_zero():
    from lapgnn_tpu.ops.pallas.features import _from_key as j_from_key
    from lapgnn_tpu.ops.pallas.features import _to_key as j_to_key

    x = np.array([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, np.inf], np.float32)
    want = np.asarray(j_to_key(jnp.asarray(x))).astype(np.int64)
    got = _to_key(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[3] < got[4]  # -0.0 sorts strictly below +0.0
    assert np.all(np.diff(got) > 0)
    back = _from_key(_to_key(_t(x))).numpy()
    np.testing.assert_array_equal(back.view(np.uint32), x.view(np.uint32))
    np.testing.assert_array_equal(
        back.view(np.uint32),
        np.asarray(j_from_key(jnp.asarray(want.astype(np.uint32)))).view(np.uint32),
    )


@pytest.mark.parametrize("n", [32, 33])
def test_row_features_stats_plain_exact_selection(n, rng):
    """Median/MAD by bisection are exact on near-tie rows (1e-7 apart) and
    on rows holding both signed zeros, odd and even m."""
    base = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    C = np.repeat(base, n, axis=1) + rng.integers(0, 3, (n, n)).astype(np.float32) * 1e-7
    C[0, : n // 2] = -0.0
    C[0, n // 2 :] = 0.0
    got = row_features_stats(_t(C)).numpy()
    want = np.asarray(pallas_row_features_stats(jnp.asarray(C), interpret=True))
    np.testing.assert_array_equal(got[:, 4], want[:, 4])
    med = np.median(C.astype(np.float64), axis=1)
    mad = np.median(np.abs(C.astype(np.float64) - med[:, None]), axis=1)
    np.testing.assert_allclose(got[:, 4], np.maximum(mad, 1e-9).astype(np.float32), atol=2e-7)


def test_row_features_stats_plain_single_column():
    """m < 2 forces gap and competition to zero; k = min(10, m)."""
    C = np.random.default_rng(4).uniform(0, 1, (5, 1)).astype(np.float32)
    got = row_features_stats_plain(_t(C), col_min_plain(_t(C))).numpy()
    want = np.asarray(pallas_row_features_stats(jnp.asarray(C), interpret=True))
    np.testing.assert_allclose(got, want, rtol=K3_RTOL, atol=K3_ATOL)
    assert np.all(got[:, 6:8] == 0.0)


def test_cpu_calls_do_not_count_launches():
    before = [w.launches for w in WRAPPERS]
    C = _t(_cost("uniform", 16))
    col_min(C)
    min_trick(C, torch.zeros(16))
    row_features_stats(C)
    assert [w.launches for w in WRAPPERS] == before


def test_wrappers_reject_other_devices():
    C = torch.zeros((4, 4), device="meta")
    with pytest.raises(ValueError):
        col_min(C)
    with pytest.raises(ValueError):
        min_trick(C, torch.zeros(4, device="meta"))
    with pytest.raises(ValueError):
        row_features_stats(C)


# ---------------------------------------------------------------- dual math and seed policy


@pytest.mark.parametrize("fam", SEED_FAMS)
def test_fast_min_trick_batched_matches_jax(fam):
    C = np.stack([_cost(fam, 64, 5), _cost(fam, 64, 6)])
    u = np.random.default_rng(7).normal(0, 0.3, (2, 64)).astype(np.float32)
    want = np.asarray(jdual.min_trick_v(jnp.asarray(C), jnp.asarray(u)))
    got = tdual.fast_min_trick(_t(C), _t(u)).numpy()
    np.testing.assert_array_equal(got, want)


def test_min_trick_v_masked_and_center_gauge_match_jax():
    C = _cost("uniform", 24)
    u = np.random.default_rng(8).normal(0, 0.3, 24).astype(np.float32)
    mask = np.arange(24) < 17
    np.testing.assert_array_equal(
        tdual.min_trick_v(_t(C), _t(u), _t(mask)).numpy(),
        np.asarray(jdual.min_trick_v(jnp.asarray(C), jnp.asarray(u), jnp.asarray(mask))),
    )
    for m in (None, mask):
        want = jdual.center_gauge(jnp.asarray(u), None if m is None else jnp.asarray(m))
        got = tdual.center_gauge(_t(u), None if m is None else _t(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("fam", SEED_FAMS)
def test_robust_normalize_matches_jax(fam):
    C = np.stack([_cost(fam, 64, 9), _cost("uniform", 64, 10)])
    jc, jmn, ja = jdual.robust_normalize(jnp.asarray(C))
    tc, tmn, ta = tdual.robust_normalize(_t(C))
    # one f32 subtraction and division per entry: a few ulps
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tmn.numpy(), np.asarray(jmn))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_robust_normalize_all_sentinel_instance():
    C = np.full((1, 8, 8), 1e6, np.float32)
    C[0, 0, 0] = 2e6
    jc, jmn, ja = jdual.robust_normalize(jnp.asarray(C))
    tc, tmn, ta = tdual.robust_normalize(_t(C))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tmn.numpy(), np.asarray(jmn))


@pytest.mark.parametrize("fam", ["sparse", "uniform"])
def test_clip_cost_sentinels_matches_jax(fam):
    C = np.stack([_cost(fam, 64, 11), np.full((64, 64), 1e6, np.float32)])
    np.testing.assert_array_equal(
        t_clip(_t(C)).numpy(), np.asarray(j_clip(jnp.asarray(C)))
    )
    mask = np.ones((2, 64), bool)
    mask[:, 50:] = False
    np.testing.assert_array_equal(
        t_clip(_t(C), _t(mask)).numpy(),
        np.asarray(j_clip(jnp.asarray(C), jnp.asarray(mask))),
    )


@pytest.mark.parametrize("fam", SEED_FAMS)
def test_rank1_duals_match_jax(fam):
    C = np.stack([_cost(fam, 64, 12)])
    ju, jv = jrank1.rank1_duals(jnp.asarray(C))
    tu, tv = trank1.rank1_duals(_t(C))
    # six power iterations and a cumsum in f32, summed in another order:
    # relative to the instance's cost scale
    scale = float(np.abs(C[C < 5e5]).max())
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=2e-5 * scale, rtol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=2e-5 * scale, rtol=1e-4)


def _unit_scale(C):
    """Families rescaled to [0, 1] so one absolute tolerance fits all."""
    real = C < 5e5
    lo, hi = C[real].min(), C[real].max()
    return np.where(real, (C - lo) / max(hi - lo, 1e-12), C).astype(np.float32)


@pytest.mark.parametrize("fam", SEED_FAMS)
def test_sinkhorn_refine_matches_jax(fam):
    """atol 1e-4 on [0, 1]-scale costs: 64 log-sum-exp sweeps at
    temperatures down to 4e-4 * scale amplify float32 rounding of C/eps
    (~1e-7 relative, times up to 2500) before eps scales it back."""
    C = _unit_scale(_cost(fam, 64, 13))[None]
    u0 = np.random.default_rng(14).normal(0, 0.1, (1, 64)).astype(np.float32)
    ju, jv = jsink.sinkhorn_refine(jnp.asarray(C), jnp.asarray(u0))
    tu, tv = tsink.sinkhorn_refine(_t(C), _t(u0))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    # and the projected pair is exactly feasible for the true matrix
    red = C[0] - tu.numpy()[0][:, None] - tv.numpy()[0][None, :]
    assert red.min() >= 0.0


def test_sinkhorn_cold_finish_rung_at_large_n(monkeypatch):
    """The colder rung joins the default ladder from n >= 4096 (lowered
    here so the check stays small), exactly as in the JAX version."""
    seen = []
    real = tsink._robust_scale

    def spy(c):
        seen.append(c.shape[-1])
        return real(c)

    monkeypatch.setattr(tsink, "COLD_FINISH_MIN_N", 32)
    monkeypatch.setattr(tsink, "_robust_scale", spy)
    C = _t(_cost("uniform", 32))[None]
    u_cold, _ = tsink.sinkhorn_refine(C, torch.zeros(1, 32))
    u_plain, _ = tsink.sinkhorn_refine(C, torch.zeros(1, 32), eps_schedule=list(tsink.DEFAULT_EPS_SCHEDULE) + [8e-5])
    np.testing.assert_array_equal(u_cold.numpy(), u_plain.numpy())
    assert seen == [32, 32]


@pytest.mark.parametrize("fam", SEED_FAMS)
def test_auto_select_seed_matches_jax(fam):
    """The selected pair's dual objective agrees to 1e-4 relative (the
    selection may take another candidate on a near-tie of objectives)."""
    C = _unit_scale(_cost(fam, 64, 15))[None]
    u = np.random.default_rng(16).normal(0, 0.1, (1, 64)).astype(np.float32)
    ju, jv = jsink.auto_select_seed(jnp.asarray(C), jnp.asarray(u))
    tu, tv = tsink.auto_select_seed(_t(C), _t(u))
    jobj = float(np.asarray(ju).sum() + np.asarray(jv).sum())
    tobj = float(tu.sum() + tv.sum())
    assert abs(tobj - jobj) <= 1e-4 * max(1.0, abs(jobj))
    red = C[0] - tu.numpy()[0][:, None] - tv.numpy()[0][None, :]
    assert red.min() >= 0.0


def test_uniq_argmin_and_veto_match_jax():
    C = _cost("tie", 64, 17)[None]
    rng = np.random.default_rng(18)
    u = rng.normal(0, 0.1, (1, 64)).astype(np.float32)
    v = rng.normal(0, 0.1, (1, 64)).astype(np.float32)
    want = np.asarray(jsink.uniq_argmin_count(jnp.asarray(C), jnp.asarray(u), jnp.asarray(v)))
    got = tsink.uniq_argmin_count(_t(C), _t(u), _t(v)).numpy()
    np.testing.assert_array_equal(got, want)
    uniq = np.array([[40, 10], [20, 30], [64, 5]])
    np.testing.assert_array_equal(
        tsink.collision_veto_mask(_t(uniq), 64).numpy(),
        np.asarray(jsink.collision_veto_mask(jnp.asarray(uniq), 64)),
    )


# ---------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("n", [7, 33, 257, 1001, 1024])
def test_kernels_match_plain_versions_on_card(cuda, n):
    C = np.stack([_cost("uniform", n, 19), _cost("tie", n, 20)])
    u = np.random.default_rng(21).normal(0, 0.3, (2, n)).astype(np.float32)
    Cd, ud = _t(C).to(cuda), _t(u).to(cuda)
    assert torch.equal(col_min(Cd), col_min_plain(Cd))
    assert torch.equal(min_trick(Cd, ud), min_trick_plain(Cd, ud))
    got = row_features_stats(Cd)
    want = row_features_stats_plain(Cd, col_min_plain(Cd))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=K3_RTOL, atol=K3_ATOL)
    k4, p4 = two_min(Cd, ud), two_min_plain(Cd, ud)
    assert all(torch.equal(a, b) for a, b in zip(k4, p4))


@pytest.mark.cuda
def test_kernel_wrappers_count_and_validate_on_card(cuda):
    C = torch.rand(64, 64, device=cuda)
    before = col_min.launches
    col_min(C)
    assert col_min.launches == before + 1
    with pytest.raises(TypeError):
        col_min(C.double())
    with pytest.raises(ValueError):
        col_min(C.t())
    with pytest.raises(ValueError):
        min_trick(C, torch.zeros(63, device=cuda))


# ---------------------------------------------------------------- the port's copy of the families


@pytest.mark.parametrize("fam", sorted(FAMILIES))
@pytest.mark.parametrize("n", [17, 64])
def test_port_families_equal_jax_families(fam, n):
    """The port's FAMILIES registry draws the same matrices from the same
    numpy seed as the JAX package's, bit for bit."""
    from lapgnn_tpu_torch.data.generators import FAMILIES as TFAMILIES

    assert sorted(TFAMILIES) == sorted(FAMILIES)
    want = FAMILIES[fam](n, np.random.default_rng(n))
    got = TFAMILIES[fam](n, np.random.default_rng(n))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
