"""Analytic dual seeds for rank-1-dominant cost matrices.

Port of ``lapgnn_tpu/ops/rank1.py`` (``rank1_fit``, ``rank1_duals``).  For
``M_ij = a_i * b_j`` with ``a`` sorted ascending and ``b`` descending the
permuted matrix is Monge, the identity matching is optimal, and

    u_(1) = 0,  u_(i+1) = u_(i) + (a_(i+1) - a_(i)) * b_(i+1),  v_(j) = a_(j) b_(j) - u_(j)

is a feasible tight dual pair.  ``jnp.argsort`` is stable, so the sorts here
are ``torch.argsort(..., stable=True)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rank1_fit", "rank1_duals"]


def _normalized(y: torch.Tensor) -> torch.Tensor:
    return y / torch.clamp_min(torch.linalg.vector_norm(y, dim=-1, keepdim=True), 1e-30)


def rank1_fit(
    C: torch.Tensor, iters: int = 6
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best rank-1 fit of the mean-centered cost, ``C ≈ delta + a bᵀ``, by a
    power iteration.  Returns ``(a, b, delta)`` of shapes (..., n), (..., n), (...)."""
    Cf = C.to(torch.float32)
    delta = Cf.mean((-2, -1))
    R = Cf - delta[..., None, None]
    n = R.shape[-1]
    x0 = 1.0 / torch.sqrt(torch.tensor(float(n), dtype=torch.float32))
    x = torch.full(R.shape[:-2] + (n,), float(x0), dtype=torch.float32, device=C.device)
    for _ in range(iters):
        y = _normalized(torch.einsum("...ij,...j->...i", R, x))
        x = _normalized(torch.einsum("...ij,...i->...j", R, y))
    y = _normalized(torch.einsum("...ij,...j->...i", R, x))
    s = torch.einsum("...i,...ij,...j->...", y, R, x)
    return y * s[..., None], x, delta


def rank1_duals(C: torch.Tensor, iters: int = 6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form optimal duals of the rank-1(+constant) fit of ``C``.

    Accepts (n, n) or (B, n, n).  The pair is feasible for the fit, not
    necessarily for ``C``: project v with the min-trick before seeding."""
    a, b, delta = rank1_fit(C, iters=iters)
    pi = torch.argsort(a, dim=-1, stable=True)
    qi = torch.argsort(-b, dim=-1, stable=True)
    As = torch.gather(a, -1, pi)
    Bs = torch.gather(b, -1, qi)
    du = torch.diff(As, dim=-1) * Bs[..., 1:]
    u_s = torch.cat([torch.zeros_like(As[..., :1]), torch.cumsum(du, dim=-1)], dim=-1)
    v_s = As * Bs - u_s
    u = torch.gather(u_s, -1, torch.argsort(pi, dim=-1, stable=True))
    v = torch.gather(v_s, -1, torch.argsort(qi, dim=-1, stable=True))
    return (u + delta[..., None]).to(C.dtype), v.to(C.dtype)
