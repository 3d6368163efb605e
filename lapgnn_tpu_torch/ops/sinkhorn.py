"""Entropic (log-domain Sinkhorn) dual refinement and the 'auto' seed policy.

Port of ``lapgnn_tpu/ops/sinkhorn.py``.  A few log-domain Sinkhorn sweeps
under a temperature ladder drive any starting duals toward a LAP dual
optimum (within O(eps * n)); the final min-trick projections make the pair
exactly feasible for the true matrix.  ``auto_select_seed`` picks among the
model seed, the rank-1 seed and the refined seed by dual objective under the
unique-argmin collision veto.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from .dual import fast_min_trick
from .rank1 import rank1_duals
from .sentinels import clip_cost_sentinels

__all__ = [
    "sinkhorn_refine",
    "auto_select_seed",
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


def _robust_scale(cost: torch.Tensor) -> torch.Tensor:
    """Per-instance spread q90 - q10 on a strided subsample of <= 65536
    entries, floored at 1e-6.  ``torch.quantile`` interpolates linearly, as
    ``jnp.quantile`` does by default."""
    n_r, n_c = cost.shape[-2], cost.shape[-1]
    red = 1
    while (n_r // red) * (n_c // red) > 65536:
        red *= 2
    sample = cost[..., ::red, ::red].reshape(cost.shape[0], -1)
    q = torch.quantile(
        sample, torch.tensor([0.1, 0.9], dtype=sample.dtype, device=sample.device), dim=-1
    )
    return torch.clamp_min(q[1] - q[0], 1e-6)


def sinkhorn_refine(
    cost: torch.Tensor,
    u0: torch.Tensor,
    eps_schedule: Sequence[float] = DEFAULT_EPS_SCHEDULE,
    iters_per_eps: int = DEFAULT_ITERS_PER_EPS,
    clip_sentinels: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Refine row duals ``u0`` toward dual optimality; returns feasible (u, v).

    ``cost`` is (B, n, n) or (n, n), ``u0`` matches.  Costs
    ``2 * len(eps_schedule) * iters_per_eps`` reads of C (64 at the defaults)."""
    if cost.ndim == 2:
        u, v = sinkhorn_refine(
            cost[None], u0[None], eps_schedule, iters_per_eps, clip_sentinels
        )
        return u[0], v[0]
    if tuple(eps_schedule) == DEFAULT_EPS_SCHEDULE and cost.shape[-1] >= COLD_FINISH_MIN_N:
        eps_schedule = DEFAULT_EPS_SCHEDULE + (COLD_FINISH_EPS,)
    cost_f = cost.to(torch.float32)
    cost_r = clip_cost_sentinels(cost_f) if clip_sentinels else cost_f
    scale = _robust_scale(cost_r)[:, None, None]

    u = u0.to(torch.float32)
    v = (cost_r - u[..., :, None]).amin(-2)
    for eps_rel in torch.tensor(eps_schedule, dtype=torch.float32).tolist():
        eps = torch.tensor(eps_rel, dtype=torch.float32, device=cost.device) * scale
        eps1 = eps[..., 0]
        for _ in range(iters_per_eps):
            u = -eps1 * torch.logsumexp((v[..., None, :] - cost_r) / eps, dim=-1)
            v = -eps1 * torch.logsumexp((u[..., :, None] - cost_r) / eps, dim=-2)
    # Exact feasibility on the true matrix in its own dtype: the entropic
    # duals carry O(eps) slack violations, which the alternating min-trick
    # projection removes.
    u = (cost - v.to(cost.dtype)[..., None, :]).amin(-1)
    v = (cost - u[..., :, None]).amin(-2)
    return u, v


def collision_veto_mask(uniq: torch.Tensor, n: int) -> torch.Tensor:
    """(K, ...) unique-argmin counts -> mask of candidates within n/4 of the
    per-instance best (the best is always kept)."""
    return uniq >= uniq.amax(0, keepdim=True) - n // 4


def uniq_argmin_count(cost: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Number of distinct per-row argmin columns of the reduced matrix (B,).
    ``torch.argmin`` returns the first minimal index, as ``jnp.argmin`` does."""
    am = torch.argmin(cost - u[..., :, None] - v[..., None, :], dim=-1)
    s = torch.sort(am, dim=-1).values
    return 1 + (s[..., 1:] != s[..., :-1]).sum(-1)


def _take(stacked: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """stacked (K, B, n), idx (B,) -> (B, n) with row b from candidate idx[b]."""
    return stacked[idx, torch.arange(stacked.shape[1], device=stacked.device)]


def auto_select_seed(
    cost: torch.Tensor, u_gnn: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The serving 'auto' seed policy: rank-1 candidate beside the model
    seed, Sinkhorn refinement of the objective winner, then a three-way
    selection by dual objective under the collision veto.

    The two candidates' min-trick projections go through ``fast_min_trick``
    (kernel K2 on a CUDA tensor)."""
    if cost.ndim == 2:
        u, v = auto_select_seed(cost[None], u_gnn[None])
        return u[0], v[0]

    u_r1, _ = rank1_duals(cost)
    us = [u_gnn, u_r1]
    vs = [fast_min_trick(cost, u) for u in us]
    objs = [u.sum(-1) + v.sum(-1) for u, v in zip(us, vs)]
    pick01 = torch.stack(objs, 0).argmax(0)  # first maximum on ties, as jnp
    u_sk, v_sk = sinkhorn_refine(cost, _take(torch.stack(us, 0), pick01))

    us.append(u_sk)
    vs.append(v_sk)
    objs.append(u_sk.sum(-1) + v_sk.sum(-1))
    uniq = torch.stack([uniq_argmin_count(cost, u, v) for u, v in zip(us, vs)], 0)
    ok = collision_veto_mask(uniq, cost.shape[-1])
    obj = torch.where(ok, torch.stack(objs, 0), -torch.inf)
    best = obj.argmax(0)
    return _take(torch.stack(us, 0), best), _take(torch.stack(vs, 0), best)

