"""Analytic dual seeds for rank-1-dominant cost matrices.

Port of ``lapgnn_tpu/ops/rank1.py`` (``rank1_fit``, ``rank1_duals``,
``select_best_seed``).  For
``M_ij = a_i * b_j`` with ``a`` sorted ascending and ``b`` descending the
permuted matrix is Monge, the identity matching is optimal, and

    u_(1) = 0,  u_(i+1) = u_(i) + (a_(i+1) - a_(i)) * b_(i+1),  v_(j) = a_(j) b_(j) - u_(j)

is a feasible tight dual pair.  ``jnp.argsort`` is stable, so the sorts here
are ``torch.argsort(..., stable=True)``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from .dual import fast_min_trick
from .partition import WHOLE, RowPartition

__all__ = ["rank1_fit", "rank1_duals", "rank1_duals_from_factors", "select_best_seed"]


def _normalized(y: torch.Tensor, part: RowPartition = WHOLE) -> torch.Tensor:
    return y / torch.clamp_min(part.norm(y), 1e-30)


def rank1_fit(
    C: torch.Tensor, iters: int = 6, part: RowPartition = WHOLE
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best rank-1 fit of the mean-centered cost, ``C ≈ delta + a bᵀ``, by a
    power iteration.  Returns ``(a, b, delta)`` of shapes (..., n), (..., n), (...).

    With a row partition ``part`` C holds its rows: ``a`` is theirs, the
    row-side norms and the column-side matvec are summed over every row."""
    Cf = C.to(torch.float32)
    delta = part.mean(Cf)
    R = Cf - delta[..., None, None]
    n = R.shape[-1]
    x0 = 1.0 / torch.sqrt(torch.tensor(float(n), dtype=torch.float32))
    x = torch.full(R.shape[:-2] + (n,), float(x0), dtype=torch.float32, device=C.device)
    for _ in range(iters):
        y = _normalized(torch.einsum("...ij,...j->...i", R, x), part)
        x = _normalized(part.sum(torch.einsum("...ij,...i->...j", R, y)))
    y = _normalized(torch.einsum("...ij,...j->...i", R, x), part)
    s = part.sum(torch.einsum("...i,...ij,...j->...", y, R, x))
    return y * s[..., None], x, delta


def rank1_duals(
    C: torch.Tensor, iters: int = 6, part: RowPartition = WHOLE
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form optimal duals of the rank-1(+constant) fit of ``C``.

    Accepts (n, n) or (B, n, n).  The pair is feasible for the fit, not
    necessarily for ``C``: project v with the min-trick before seeding.
    With a row partition ``part`` u is for C's rows and v for every column;
    the row factor is gathered for its sort, one (n,) vector an instance."""
    a, b, delta = rank1_fit(C, iters=iters, part=part)
    u, v = rank1_duals_from_factors(part.gather(a), b, delta, C.dtype)
    return part.local(u), v


def rank1_duals_from_factors(
    a: torch.Tensor, b: torch.Tensor, delta: torch.Tensor, dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The closed-form duals of ``delta + a bᵀ`` (``rank1_duals`` after its
    fit); (u, v) in ``dtype``."""
    pi = torch.argsort(a, dim=-1, stable=True)
    qi = torch.argsort(-b, dim=-1, stable=True)
    As = torch.gather(a, -1, pi)
    Bs = torch.gather(b, -1, qi)
    du = torch.diff(As, dim=-1) * Bs[..., 1:]
    u_s = torch.cat([torch.zeros_like(As[..., :1]), torch.cumsum(du, dim=-1)], dim=-1)
    v_s = As * Bs - u_s
    u = torch.gather(u_s, -1, torch.argsort(pi, dim=-1, stable=True))
    v = torch.gather(v_s, -1, torch.argsort(qi, dim=-1, stable=True))
    return (u + delta[..., None]).to(dtype), v.to(dtype)


def select_best_seed(
    cost: torch.Tensor,
    u_candidates: Sequence[torch.Tensor],
    min_trick: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    collision_veto: bool = False,
    part: RowPartition = WHOLE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-instance argmax of the dual objective over candidate row duals,
    each projected to a feasible pair by ``min_trick`` (default
    ``ops.dual.fast_min_trick``, kernel K2 on a CUDA tensor).  With
    ``collision_veto`` a candidate whose unique-argmin count trails the best
    by more than n/4 is disqualified first (``ops.sinkhorn``).  Returns the
    winning ``(u, v)``; (n, n) or (B, n, n).  With a row partition ``part``
    cost and the candidates hold its rows, and ``min_trick`` must combine
    over every row (``part.min_trick``)."""
    if min_trick is None:
        min_trick = fast_min_trick
    if cost.ndim == 2:
        u, v = select_best_seed(
            cost[None], tuple(u[None] for u in u_candidates), min_trick, collision_veto, part
        )
        return u[0], v[0]

    us = torch.stack(tuple(u_candidates), 0)  # (K, B, n)
    vs = torch.stack([min_trick(cost, u) for u in u_candidates], 0)
    obj = part.sum(us.sum(-1)) + vs.sum(-1)  # (K, B)
    if collision_veto and len(u_candidates) > 1:
        from .sinkhorn import collision_veto_mask, uniq_argmin_count

        uniq = torch.stack([uniq_argmin_count(cost, u, v, part) for u, v in zip(us, vs)], 0)
        obj = torch.where(collision_veto_mask(uniq, cost.shape[-1]), obj, -torch.inf)
    best = obj.argmax(0)  # first maximum on ties, as jnp.argmax
    ar = torch.arange(us.shape[1], device=us.device)
    return us[best, ar], vs[best, ar]
