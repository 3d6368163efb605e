"""Entropic (log-domain Sinkhorn) dual refinement and the 'auto' seed policy.

Port of ``lapgnn_tpu/ops/sinkhorn.py``.  A few log-domain Sinkhorn sweeps
under a temperature ladder drive any starting duals toward a LAP dual
optimum (within O(eps * n)); the final min-trick projections make the pair
exactly feasible for the true matrix.  ``auto_select_seed`` picks among the
model seed, the rank-1 seed and the refined seed by dual objective under the
unique-argmin collision veto.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from .. import tracing
from .dual import fast_min_trick
from .partition import WHOLE, RowPartition
from .rank1 import rank1_duals
from .sentinels import clip_cost_sentinels

__all__ = [
    "sinkhorn_refine",
    "sinkhorn_ladder_eager",
    "auto_select_seed",
    "seed_candidates",
    "uniq_argmin_count",
    "collision_veto_mask",
    "DEFAULT_EPS_SCHEDULE",
]

# Relative-to-scale temperature ladder, 4 rungs x 8 sweeps (see the JAX
# module for how it was tuned).
DEFAULT_EPS_SCHEDULE: Tuple[float, ...] = (0.05, 0.01, 0.002, 4e-4)
DEFAULT_ITERS_PER_EPS = 8
# Colder finishing rung appended to the default ladder at n >= 4096.
COLD_FINISH_EPS = 8e-5
COLD_FINISH_MIN_N = 4096


def _robust_scale(cost: torch.Tensor, part: RowPartition = WHOLE) -> torch.Tensor:
    """Per-instance spread q90 - q10 on a strided subsample of <= 65536
    entries, floored at 1e-6.  With a row partition ``part`` the sample
    strides every row and holds them in their global order."""
    n_r, n_c = cost.shape[-2] * part.size, cost.shape[-1]
    red = 1
    while (n_r // red) * (n_c // red) > 65536:
        red *= 2
    sample = part.sample_rows(cost[..., ::red], red).reshape(cost.shape[0], -1)
    q = _quantiles(sample, (0.1, 0.9))
    return torch.clamp_min(q[1] - q[0], 1e-6)


def _quantiles(a: torch.Tensor, qs: Sequence[float]) -> torch.Tensor:
    """Linear-interpolated quantiles of the rows of ``a``, (len(qs), B), in
    ``jnp.quantile``'s arithmetic: a row holding a NaN is all NaN, the
    position is q * (N - 1), the weights are ``hi_w = pos - floor(pos)`` and
    ``lo_w = 1 - hi_w``, the result ``lo * lo_w + hi * hi_w`` rounded to the
    input's dtype.  The position and the interpolation run in float64, as
    ``jnp.quantile`` runs them on a float64 ``q`` (JAX with x64 on, as its
    tests run); with x64 off JAX computes them in float32, which can round
    the result one ulp apart.  The positions and weights depend on the
    shape alone, so the host computes them, in the same float64 steps, and
    the device only gathers and interpolates: nothing is copied to it."""
    m = a.shape[-1]
    a = torch.where(torch.isnan(a).any(-1, keepdim=True), torch.nan, a)
    srt = torch.sort(a, dim=-1).values
    out = []
    for q in qs:
        pos = float(q) * float(m - 1)
        lo_i = min(max(math.floor(pos), 0), m - 1)
        hi_i = min(max(math.ceil(pos), 0), m - 1)
        hi_w = pos - math.floor(pos)
        lo_w = 1.0 - hi_w
        lo = srt[:, lo_i].to(torch.float64)
        hi = srt[:, hi_i].to(torch.float64)
        out.append(lo * lo_w + hi * hi_w)
    return torch.stack(out).to(a.dtype)


def sinkhorn_refine(
    cost: torch.Tensor,
    u0: torch.Tensor,
    eps_schedule: Sequence[float] = DEFAULT_EPS_SCHEDULE,
    iters_per_eps: int = DEFAULT_ITERS_PER_EPS,
    clip_sentinels: bool = True,
    part: RowPartition = WHOLE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine row duals ``u0`` toward dual optimality; returns feasible (u, v).

    ``cost`` is (B, n, n) or (n, n), ``u0`` matches.  Costs
    ``2 * len(eps_schedule) * iters_per_eps`` reads of C (64 at the defaults).
    With a row partition ``part`` cost and u hold its rows: each row pass is
    local, each column pass a logsumexp combined over every row.

    A float32 cost on the card with the whole partition runs the ladder and
    the projections as one kernel (``ops.cuda.sinkhorn_ladder``, within its
    stated tolerance of this loop); a CPU tensor, another dtype or a row
    block of several ranks runs the eager loop (``sinkhorn_ladder_eager``)."""
    if cost.ndim == 2:
        u, v = sinkhorn_refine(
            cost[None], u0[None], eps_schedule, iters_per_eps, clip_sentinels, part
        )
        return u[0], v[0]
    if tuple(eps_schedule) == DEFAULT_EPS_SCHEDULE and cost.shape[-1] >= COLD_FINISH_MIN_N:
        eps_schedule = DEFAULT_EPS_SCHEDULE + (COLD_FINISH_EPS,)
    cost_f = cost.to(torch.float32)
    cost_r = clip_cost_sentinels(cost_f, part=part) if clip_sentinels else cost_f
    scale = _robust_scale(cost_r, part)
    u = u0.to(torch.float32)
    eps_rel = torch.tensor(eps_schedule, dtype=torch.float32).tolist()
    if cost.device.type != "cpu" and cost.dtype == torch.float32 and part is WHOLE:
        from .cuda import sinkhorn_ladder

        return sinkhorn_ladder(cost_r.contiguous(), cost.contiguous(), u.contiguous(), scale,
                               eps_rel, iters_per_eps)
    return sinkhorn_ladder_eager(cost_r, cost, u, scale, eps_rel, iters_per_eps, part)


def sinkhorn_ladder_eager(
    cost_r: torch.Tensor,
    cost: torch.Tensor,
    u: torch.Tensor,
    scale: torch.Tensor,
    eps_rel: Sequence[float],
    iters_per_eps: int,
    part: RowPartition = WHOLE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ladder as eager passes: (B, n, n) float32 ``cost_r`` (the matrix
    the ladder reads), the true ``cost``, float32 row duals ``u`` (B, n),
    the (B,) ``scale``, the rungs' temperatures relative to it.  One
    blocking copy a rung (its temperature)."""
    scale = scale[:, None, None]
    v = part.min((cost_r - u[..., :, None]).amin(-2))
    for eps_r in eps_rel:
        eps = tracing.to_device(eps_r, cost.device, torch.float32) * scale
        eps1 = eps[..., 0]
        for _ in range(iters_per_eps):
            u = -eps1 * torch.logsumexp((v[..., None, :] - cost_r) / eps, dim=-1)
            v = -eps1 * part.logsumexp((u[..., :, None] - cost_r) / eps)
    # Exact feasibility on the true matrix in its own dtype: the entropic
    # duals carry O(eps) slack violations, which the alternating min-trick
    # projection removes.
    u = (cost - v.to(cost.dtype)[..., None, :]).amin(-1)
    v = part.min((cost - u[..., :, None]).amin(-2))
    return u, v


def collision_veto_mask(uniq: torch.Tensor, n: int) -> torch.Tensor:
    """(K, ...) unique-argmin counts -> mask of candidates within n/4 of the
    per-instance best (the best is always kept)."""
    return uniq >= uniq.amax(0, keepdim=True) - n // 4


def uniq_argmin_count(
    cost: torch.Tensor, u: torch.Tensor, v: torch.Tensor, part: RowPartition = WHOLE
) -> torch.Tensor:
    """Number of distinct per-row argmin columns of the reduced matrix (B,),
    over every row of the row partition ``part``: each row marks its argmin
    column, and the marks are merged by a maximum.  ``torch.argmin`` returns
    the first minimal index, as ``jnp.argmin`` does."""
    am = torch.argmin(cost - u[..., :, None] - v[..., None, :], dim=-1)
    seen = torch.zeros(am.shape[:-1] + cost.shape[-1:], dtype=torch.int32, device=cost.device)
    return part.max(seen.scatter_(-1, am, 1)).sum(-1)


def _take(stacked: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """stacked (K, B, n), idx (B,) -> (B, n) with row b from candidate idx[b]."""
    return stacked[idx, torch.arange(stacked.shape[1], device=stacked.device)]


def auto_select_seed(
    cost: torch.Tensor,
    u_gnn: torch.Tensor,
    min_trick: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    part: RowPartition = WHOLE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serving 'auto' seed policy: rank-1 candidate beside the model
    seed, Sinkhorn refinement of the objective winner, then a three-way
    selection by dual objective under the collision veto.

    The two candidates' min-trick projections go through ``min_trick``,
    by default ``fast_min_trick`` (kernel K2 on a CUDA tensor); the DualGNN
    evaluation passes the plain ``ops.dual.min_trick_v``, as the JAX
    evaluation does.  With a row partition ``part`` cost and u_gnn hold its
    rows, and ``min_trick`` must combine over every row (``part.min_trick``)."""
    if cost.ndim == 2:
        u, v = auto_select_seed(cost[None], u_gnn[None], min_trick, part)
        return u[0], v[0]
    us, vs, _, best = seed_candidates(cost, u_gnn, min_trick, part)
    return _take(us, best), _take(vs, best)


def seed_candidates(
    cost: torch.Tensor,
    u_gnn: torch.Tensor,
    min_trick: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    part: RowPartition = WHOLE,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """``auto_select_seed``'s three candidates on a (B, n, n) batch, the
    model's, the rank-1 and the refined: (K, B, n) u and v, their (K, B)
    dual objectives and the (B,) index of the one it serves."""
    if min_trick is None:
        min_trick = fast_min_trick

    def objective(u, v):
        return part.sum(u.sum(-1)) + v.sum(-1)

    u_r1, _ = rank1_duals(cost, part=part)
    us = [u_gnn, u_r1]
    vs = [min_trick(cost, u) for u in us]
    objs = [objective(u, v) for u, v in zip(us, vs)]
    pick01 = torch.stack(objs, 0).argmax(0)  # first maximum on ties, as jnp
    u_sk, v_sk = sinkhorn_refine(cost, _take(torch.stack(us, 0), pick01), part=part)

    us.append(u_sk)
    vs.append(v_sk)
    objs.append(objective(u_sk, v_sk))
    uniq = torch.stack([uniq_argmin_count(cost, u, v, part) for u, v in zip(us, vs)], 0)
    ok = collision_veto_mask(uniq, cost.shape[-1])
    objs = torch.stack(objs, 0)
    best = torch.where(ok, objs, -torch.inf).argmax(0)
    return torch.stack(us, 0), torch.stack(vs, 0), objs, best
