"""The seed policy's Sinkhorn ladder as one kernel (``ops.cuda.sinkhorn``,
``csrc/sinkhorn.cu``) and its dispatch in ``ops.sinkhorn.sinkhorn_refine``.

On the CPU: ``sinkhorn_by_blocks``, a plain transcription of the kernel's
order (lanes over groups of four columns, the blocks' partials a column and
their merge), against the eager loop within the module's stated tolerance,
and its projected pair exactly feasible; the pieces of that order against
``torch.logsumexp`` on NaN, infinite and ragged rows; the launch geometry;
the dispatch (a CPU tensor and a row partition of several ranks keep the
eager loop, any other float32 tensor with the whole partition goes to the
kernel's wrapper); what the wrapper refuses.

The module imports no JAX, so its ``cuda`` cases run on the card:
``python3 -m pytest tests/test_torch_sinkhorn_kernel.py -m cuda``.  There
the kernel is held against the eager loop on the same card (both layouts,
ragged n, the colder rung at n = 4096), its projections bit-equal to the
eager minima on its own ladder's v, the seed policy's pick against the
eager path's on the benchmark's serving pool, and its launch counts.
"""

import numpy as np
import pytest
import torch

import lapgnn_tpu_torch.ops.cuda as cuda_ops
from lapgnn_tpu_torch import tracing
from lapgnn_tpu_torch.data.generators import FAMILIES
from lapgnn_tpu_torch.ops import sinkhorn as tsink
from lapgnn_tpu_torch.ops.cuda import sinkhorn as ksink
from lapgnn_tpu_torch.ops.cuda.augment import MAX_SMEM
from lapgnn_tpu_torch.ops.partition import WHOLE, RowPartition
from lapgnn_tpu_torch.ops.sentinels import clip_cost_sentinels

SEED_FAMS = ["uniform", "noisy_linear", "tie", "sparse"]
LAUNCHES = "launch.sinkhorn_ladder"  # the tracer's count of the kernel's launches
INF, NAN = float("inf"), float("nan")
_EAGER = tsink.sinkhorn_ladder_eager


def _batch(fam, n, B, seed=0):
    return torch.from_numpy(np.stack([
        FAMILIES[fam](n, np.random.default_rng(seed + k)).astype(np.float32) for k in range(B)]))


def _ladder_inputs(C, seed=9):
    """What ``sinkhorn_refine`` hands the ladder: the clipped matrix, the
    scale, float32 row duals and the default rungs at this n."""
    B, n, _ = C.shape
    u0 = torch.from_numpy(np.random.default_rng(seed).normal(0, 0.1, (B, n)).astype(np.float32))
    cost_r = clip_cost_sentinels(C)
    rungs = tsink.DEFAULT_EPS_SCHEDULE
    if n >= tsink.COLD_FINISH_MIN_N:
        rungs = rungs + (tsink.COLD_FINISH_EPS,)
    eps_rel = torch.tensor(rungs, dtype=torch.float32).tolist()
    return cost_r, u0.to(C.device), tsink._robust_scale(cost_r), eps_rel


def _within(got, want, cost_r):
    """|got - want| within the module's tolerance everywhere."""
    tol = ksink.tolerance(cost_r).to(got.device)
    return bool(((got - want).abs() <= tol).all())


def _feasible(C, u, v):
    return float((C - u[..., :, None] - v[..., None, :]).amin()) >= 0.0


# ------------------------------------------------- the kernel's order on the CPU


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n", [64, 300])
@pytest.mark.parametrize("fam", SEED_FAMS)
def test_by_blocks_matches_plain_loop(fam, n, B):
    C = _batch(fam, n, B, seed=21)
    cost_r, u0, scale, eps_rel = _ladder_inputs(C)
    want = ksink.sinkhorn_ladder_plain(cost_r, C, u0, scale, eps_rel, tsink.DEFAULT_ITERS_PER_EPS)
    got = ksink.sinkhorn_by_blocks(cost_r, C, u0, scale, eps_rel, tsink.DEFAULT_ITERS_PER_EPS)
    assert _within(got[0], want[0], cost_r) and _within(got[1], want[1], cost_r)
    assert _feasible(C, *got)


def _special_rows(n):
    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.normal(0, 30, (7, n)).astype(np.float32))
    z[1, 3 % n] = NAN
    z[2, n - 1] = INF
    z[3] = -INF
    z[4, :] = -INF
    z[4, n // 2] = 5.0
    z[5, 0] = INF
    z[5, min(1, n - 1)] = NAN
    z[6] = 1e30
    return z


@pytest.mark.parametrize("n", [1, 5, 64, 131, 300])
def test_lane_logsumexp_matches_torch(n):
    z = _special_rows(n)
    got = ksink._row_lse_by_lanes(z)
    want = torch.logsumexp(z, -1)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = torch.isfinite(want)
    assert torch.equal(got[~fin & ~torch.isnan(want)], want[~fin & ~torch.isnan(want)])
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-6, atol=0)


@pytest.mark.parametrize("n,rows,blocks", [(1, 1, 1), (7, 3, 3), (64, 1, 64), (300, 3, 100),
                                           (300, 16, 19)])
def test_block_partials_match_torch(n, rows, blocks):
    z = _special_rows(n).T.contiguous()[None].expand(2, n, 7).contiguous()
    z = torch.cat([z, z[:, :, :1]], -1)  # (2, n, 8): columns with the special values
    m, s = ksink._col_partials(z, rows, blocks)
    got = ksink._merge_partials(m, s, blocks)
    want = torch.logsumexp(z, -2)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = torch.isfinite(want)
    special = ~fin & ~torch.isnan(want)
    assert torch.equal(got[special], want[special])
    torch.testing.assert_close(got[fin], want[fin], rtol=2e-6, atol=0)


# ------------------------------------------------- geometry


@pytest.mark.parametrize("n", [1, 2, 33, 64, 131, 300, 1000, 2048, 2700, 4096, 8192, 20000])
@pytest.mark.parametrize("sms", [132, 114, 7])
def test_geometry_spreads_every_row(n, sms):
    rows = -(-n // min(n, sms))
    cols = -(-n // -(-n // rows))
    fits = (cols <= ksink.THREADS
            and ksink.sinkhorn_smem_bytes(n, rows, False) + ksink.STATIC_SMEM <= MAX_SMEM)
    if not fits:
        with pytest.raises(ValueError):
            ksink.sinkhorn_geometry(n, sms)
        return
    g = ksink.sinkhorn_geometry(n, sms)
    assert g.blocks <= min(n, sms)
    assert (g.blocks - 1) * g.rows < n <= g.blocks * g.rows
    assert -(-n // g.blocks) <= ksink.THREADS
    assert g.smem_bytes + ksink.STATIC_SMEM <= MAX_SMEM
    assert g.smem_bytes == ksink.sinkhorn_smem_bytes(n, g.rows, g.resident)


def test_geometry_layouts():
    g = ksink.sinkhorn_geometry(2048, 132)
    assert (g.blocks, g.rows, g.resident) == (128, 16, True)
    assert not ksink.sinkhorn_geometry(4096, 132).resident
    assert not ksink.sinkhorn_geometry(2048, 132, layout="streamed").resident
    with pytest.raises(ValueError):
        ksink.sinkhorn_geometry(4096, 132, layout="resident")
    with pytest.raises(ValueError):
        ksink.sinkhorn_geometry(64, 132, layout="tiled")
    with pytest.raises(ValueError):
        ksink.sinkhorn_geometry(60_000, 132)  # v no longer fits shared memory


# ------------------------------------------------- dispatch and refusals


def test_cpu_tensor_takes_the_plain_loop():
    C = _batch("noisy_linear", 48, 2, seed=5)
    u0 = torch.zeros(2, 48)
    before = tracing.counters().get(LAUNCHES, 0)
    got = tsink.sinkhorn_refine(C, u0)
    cost_r, _, scale, eps_rel = _ladder_inputs(C)
    want = tsink.sinkhorn_ladder_eager(cost_r, C, u0, scale, eps_rel, tsink.DEFAULT_ITERS_PER_EPS)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert tracing.counters().get(LAUNCHES, 0) == before


class _Block(RowPartition):
    """A row block that combines nothing: the eager loop's row-partition
    path, on one process."""


def _routes(monkeypatch, part, dtype=torch.float32):
    """Which way ``sinkhorn_refine`` sends a tensor off the CPU (``meta``,
    shapes only): the kernel's wrapper or the eager loop."""
    seen = []

    def wrapper(*args):
        seen.append("kernel")
        return args[2], args[2]

    def eager(*args):
        seen.append("eager")
        return _EAGER(*args)

    monkeypatch.setattr(cuda_ops, "sinkhorn_ladder", wrapper)
    monkeypatch.setattr(tsink, "sinkhorn_ladder_eager", eager)
    C = torch.empty((2, 64, 64), dtype=dtype, device="meta")
    tsink.sinkhorn_refine(C, torch.empty((2, 64), device="meta"), part=part)
    return seen


def test_dispatch_by_device_dtype_and_partition(monkeypatch):
    assert _routes(monkeypatch, WHOLE) == ["kernel"]
    assert _routes(monkeypatch, _Block()) == ["eager"]
    assert _routes(monkeypatch, WHOLE, torch.float64) == ["eager"]


def _args(B=2, n=16, dtype=torch.float32):
    C = torch.rand((B, n, n), dtype=dtype)
    return C, C.clone(), torch.zeros((B, n), dtype=dtype), torch.ones(B, dtype=dtype)


@pytest.mark.parametrize("bad", ["float64", "cost_float64", "u0_float64", "non_contiguous",
                                 "u0_shape", "scale_shape", "cost_r_shape", "not_square",
                                 "two_dims", "rungs", "cpu"])
def test_wrapper_refuses(bad):
    cost_r, cost, u0, scale = _args()
    eps = [0.05, 0.01]
    if bad == "float64":
        cost_r, cost, u0, scale = _args(dtype=torch.float64)
    elif bad == "cost_float64":
        cost = cost.double()
    elif bad == "u0_float64":
        u0 = u0.double()
    elif bad == "non_contiguous":
        cost = cost.transpose(1, 2)
    elif bad == "u0_shape":
        u0 = u0[:, :-1].contiguous()
    elif bad == "scale_shape":
        scale = scale[:1]
    elif bad == "cost_r_shape":
        cost_r = cost_r[:1].contiguous()
    elif bad == "not_square":
        cost_r, cost = cost_r[:, :-1].contiguous(), cost[:, :-1].contiguous()
    elif bad == "two_dims":
        cost_r, cost = cost_r[0], cost[0]
    elif bad == "rungs":
        eps = [0.01] * (ksink.MAX_RUNGS + 1)
    before = tracing.counters().get(LAUNCHES, 0)
    with pytest.raises((TypeError, ValueError)):
        ksink.sinkhorn_ladder_kernel(cost_r, cost, u0, scale, eps, 8)
    assert tracing.counters().get(LAUNCHES, 0) == before


# ------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _on_card(fam, n, B, cuda, seed):
    C = _batch(fam, n, B, seed).to(cuda)
    return (C, *_ladder_inputs(C, seed + 100))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n", [64, 1000, 2048, 4096])
@pytest.mark.parametrize("fam", SEED_FAMS)
def test_kernel_matches_plain_loop_on_card(cuda, fam, n, B):
    C, cost_r, u0, scale, eps_rel = _on_card(fam, n, B, cuda, 31)
    iters = tsink.DEFAULT_ITERS_PER_EPS
    got = ksink.sinkhorn_ladder_kernel(cost_r, C, u0, scale, eps_rel, iters)
    want = ksink.sinkhorn_ladder_plain(cost_r, C, u0, scale, eps_rel, iters)
    torch.cuda.synchronize()
    assert _within(got[0], want[0], cost_r) and _within(got[1], want[1], cost_r)
    assert _feasible(C, *got)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ksink.LAYOUTS)
@pytest.mark.parametrize("n", [1, 5, 301, 1000])
def test_both_layouts_and_ragged_rows_on_card(cuda, n, layout):
    C, cost_r, u0, scale, eps_rel = _on_card("noisy_linear", n, 2, cuda, 41)
    got = ksink.sinkhorn_ladder_kernel(cost_r, C, u0, scale, eps_rel, 8, layout=layout)
    want = ksink.sinkhorn_ladder_plain(cost_r, C, u0, scale, eps_rel, 8)
    torch.cuda.synchronize()
    assert _within(got[0], want[0], cost_r) and _within(got[1], want[1], cost_r)
    assert _feasible(C, *got)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ksink.LAYOUTS)
@pytest.mark.parametrize("n", [64, 301, 2048])
def test_projections_bit_equal_to_eager_minima_on_card(cuda, n, layout):
    C, cost_r, u0, scale, eps_rel = _on_card("sparse", n, 2, cuda, 51)
    u, v, ladder = ksink.sinkhorn_ladder_kernel(cost_r, C, u0, scale, eps_rel, 8, layout=layout,
                                                keep_ladder=True)
    u_want = (C - ladder[..., None, :]).amin(-1)
    v_want = (C - u_want[..., :, None]).amin(-2)
    torch.cuda.synchronize()
    assert torch.equal(u, u_want) and torch.equal(v, v_want)


@pytest.mark.cuda
def test_special_values_on_card(cuda):
    """A NaN in a row or an infinite entry come out where the eager loop has
    them (NaN as one class, infinities equal), the rest within tolerance."""
    C = _batch("uniform", 96, 3, 61)
    C[0, 5, :] = NAN
    C[1, :, 7] = INF
    C = C.to(cuda)
    cost_r, u0, scale, eps_rel = _ladder_inputs(C, 62)
    got = ksink.sinkhorn_ladder_kernel(cost_r, C, u0, scale, eps_rel, 8)
    want = ksink.sinkhorn_ladder_plain(cost_r, C, u0, scale, eps_rel, 8)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.isinf(a), torch.isinf(b))
        fin = torch.isfinite(b)
        assert torch.equal(a[torch.isinf(b)], b[torch.isinf(b)])
        tol = ksink.tolerance(torch.nan_to_num(cost_r, nan=0.0, posinf=0.0)).to(cuda)
        assert bool(((a - b).abs() <= tol)[fin].all())


@pytest.mark.cuda
def test_static_smem_within_the_geometry_on_card(cuda):
    from lapgnn_tpu_torch.ops.cuda._lib import KERNEL_LIBS

    static = KERNEL_LIBS["sinkhorn"].load().lapgnn_sinkhorn_static_smem()
    assert 0 <= static <= ksink.STATIC_SMEM


@pytest.mark.cuda
def test_launch_counts_on_card(cuda):
    C = _batch("uniform", 256, 1, 71).to(cuda)
    u = C.amin(-1)
    before = tracing.counters().get(LAUNCHES, 0)
    for k in range(3):
        tsink.auto_select_seed(C, u)
        assert tracing.counters().get(LAUNCHES, 0) == before + k + 1


def _serving_pool(seed, n=2048):
    """Cell one_gnn_default.solve-2048-closed's pool: four instances each of
    uniform, noisy_linear, sparse and tie, drawn by the benchmark's own
    families."""
    from lapbench import families

    names = [f for f in ("uniform", "noisy_linear", "sparse", "tie") for _ in range(4)]
    return families.draw(names, n, seed, np.dtype("float32"))


@pytest.mark.cuda
def test_seed_policy_picks_as_the_eager_path_on_card(cuda, monkeypatch):
    """On the serving pool the kernel's refined candidate leaves the seed
    policy's pick where the eager ladder leaves it."""
    from pathlib import Path

    from lapgnn_tpu_torch.ops.dual import robust_normalize
    from lapgnn_tpu_torch.ops.features import fast_row_features
    from lapgnn_tpu_torch.pipeline import WarmStartPipeline
    from lapgnn_tpu_torch.train import build_model_from_meta, load_checkpoint

    ckpt = Path(__file__).resolve().parent.parent / "artifacts" / "one_gnn_default"
    params, meta, _ = load_checkpoint(ckpt)
    pipe = WarmStartPipeline(build_model_from_meta(meta), params, device=cuda,
                             normalize_costs=True)
    differ = []
    for k, (fam, C_np) in enumerate(_serving_pool(4_200_019_019)):
        C = torch.from_numpy(C_np).to(cuda)[None]
        with torch.inference_mode():
            cn, mn, a = robust_normalize(C)
            u = pipe.model(fast_row_features(cn), cost=cn)["u"] * a[..., None] + mn[..., None]
            _, _, objs_k, best_k = tsink.seed_candidates(C, u)
            with monkeypatch.context() as m:
                m.setattr(cuda_ops, "sinkhorn_ladder", ksink.sinkhorn_ladder_plain)
                _, _, objs_e, best_e = tsink.seed_candidates(C, u)
        if int(best_k) != int(best_e):
            differ.append((k, fam, int(best_k), int(best_e), objs_k[:, 0].tolist(),
                           objs_e[:, 0].tolist()))
    assert differ == []
