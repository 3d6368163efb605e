"""Plain reference of a OneGNN progressive training step, in float32 PyTorch.

Written from the model's published description (the original system's
``gnn/one_gnn.py:18-160``: a residual MLP stack over 21 row features, then a
sparse refinement over the k smallest reduced costs C - u_pre of each row)
and the loss and optimizer it is trained with (``gnn/train_one_gnn.py:137-226``:
the primal gap from the greedy upper bound, the feasibility hinge, 0.1 u-MSE,
the min-trick v; AdamW behind global-norm clipping).  Plain ``torch``
operations and autograd, in the order the mathematics states them; no kernel,
no fused product, no cache.  Imports nothing of the program, of JAX or of the
rest of the benchmark: the greedy bound is handed in by the caller.

Departures from the source, each what the served artifact was trained with:

  * each instance is rescaled first (``robust_normalize``: C' = (C - min) /
    (max - min) over the entries below the 0.5e6 sentinel, clipped at 3) and
    its target duals with it, u' = (u - min) / (max - min);
  * the primal gap is divided by n (``normalize_gap``);
  * the greedy bound visits the rows in ascending order of their least
    reduced cost, each taking its cheapest unused column (no duplicate
    repair: no duplicate arises);
  * the features are computed on the device from the batch, and every
    instance of a batch has the same n: no padding, no mask;
  * dropout masks come from the caller's seeded generator, one uniform draw
    per site in the order of the forward (each block after fc1's GELU and
    after fc2, the refinement's message, the head after its GELU), kept
    where the draw is below 1 - rate, as the configuration's dropout draws
    them; the global RNG is never read;
  * AdamW is optax's ``chain(clip_by_global_norm, adamw)``: weight decay is
    added to the Adam update, not applied to the weights first;
  * the refinement takes the k smallest entries by a full sort of each row;
    costs are finite (no invalid top-k entry to mask).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Reference", "forward", "one_gnn_loss", "robust_normalize", "row_features"]

SENTINEL = 0.5e6
CLIP = 3.0
EPS = 1e-9
LN_EPS = 1e-5
POS_FREQS = (1, 2, 4, 8)
K_SMALLEST = 10


# --- the instance and its features -------------------------------------------

def robust_normalize(C: torch.Tensor, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, n, m) costs and (B, n) target duals in the rescaled space."""
    real = C < SENTINEL
    any_real = real.flatten(-2).any(-1)[:, None, None]
    mn = torch.where(real, C, torch.inf).amin((-2, -1), keepdim=True)
    mx = torch.where(real, C, -torch.inf).amax((-2, -1), keepdim=True)
    mn = torch.where(any_real, mn, C.amin((-2, -1), keepdim=True))
    mx = torch.where(any_real, mx, C.amax((-2, -1), keepdim=True))
    a = torch.clamp_min(mx - mn, 1e-12)
    return torch.clamp_max((C - mn) / a, CLIP), (u - mn[..., 0]) / a[..., 0]


def _median_sorted(s: torch.Tensor) -> torch.Tensor:
    m = s.shape[-1]
    return s[..., m // 2] if m % 2 else 0.5 * (s[..., m // 2 - 1] + s[..., m // 2])


def _positions(n: int, device) -> torch.Tensor:
    """sin and cos of 2 pi pos f / (n - 1) for f in 1, 2, 4, 8, side by side
    per frequency: (n, 8)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    freqs = torch.tensor(POS_FREQS, dtype=torch.float32, device=device)[None, :]
    angle = 2.0 * math.pi * pos * freqs / float(max(1, n - 1))
    return torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).reshape(n, 2 * len(POS_FREQS))


def row_features(C: torch.Tensor) -> torch.Tensor:
    """(B, n, m) costs -> (B, n, 21): each row's min, max, mean, population
    std, MAD (floored at EPS), entropy of softmax(-C), gap between its two
    least entries, that gap over the row's range, mean and population std of
    its 10 least entries, the inverse of the mean gap between consecutive
    sorted entries, the share of entries within 10% of its minimum, the share
    of its entries that are their column's minimum; then 8 positional
    encodings."""
    B, n, m = C.shape
    srt = torch.sort(C, dim=-1).values
    med = _median_sorted(srt)
    spread = torch.sort((srt - med[..., None]).abs(), dim=-1).values
    mad = torch.clamp_min(_median_sorted(spread), EPS)
    mn = C.amin(-1)
    e = torch.exp(-(C - mn[..., None]))
    p = e / (e.sum(-1, keepdim=True) + EPS)
    entropy = -(p * torch.log(p + EPS)).sum(-1)
    gap = srt[..., 1] - srt[..., 0]
    competition = gap / (srt[..., -1] - srt[..., 0] + EPS)
    difficulty = 1.0 / ((srt[..., 1:] - srt[..., :-1]).mean(-1) + EPS)
    least = srt[..., :min(K_SMALLEST, m)]
    near_best = (C <= mn[..., None] * 1.1).to(torch.float32).mean(-1)
    col_best = (C == C.amin(-2, keepdim=True)).to(torch.float32).sum(-1) / m
    stats = torch.stack([mn, C.amax(-1), C.mean(-1), C.std(-1, correction=0), mad, entropy,
                         gap, competition, least.mean(-1), least.std(-1, correction=0), difficulty,
                         near_best, col_best], dim=-1)
    return torch.cat([stats, _positions(n, C.device).expand(B, n, 2 * len(POS_FREQS))], dim=-1)


# --- the model -----------------------------------------------------------------

def _dense(x, p, name):
    return x @ p[name + "/kernel"] + p[name + "/bias"]


def _norm(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[name + "/scale"], p[name + "/bias"], eps=LN_EPS)


def _dropout(x, rate, gen):
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device, dtype=x.dtype) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def forward(p: Dict[str, torch.Tensor], feat: torch.Tensor, cost: torch.Tensor, layers: int,
            topk: int, rate: float, gen: Optional[torch.Generator]):
    """Row duals u (B, n), mean-centred per instance, and the pre-output
    u_pre (B, n) that the refinement reads."""
    gelu = F.gelu
    h = _norm(gelu(_dense(feat, p, "input_proj")), p, "input_norm")
    for i in range(layers):
        name = f"block_{i}/"
        y = _dropout(gelu(_dense(h, p, name + "fc1")), rate, gen)
        y = _dropout(_dense(y, p, name + "fc2"), rate, gen)
        h = _norm(h + y, p, name + "norm")
    u_pre = _dense(h, p, "pre_out")[..., 0]
    # the refinement: the k least reduced costs of each row, softmax(-value)
    # weighting an MLP embedding of each value
    k = min(topk, cost.shape[-1])
    values = torch.sort(cost - u_pre[..., :, None], dim=-1).values[..., :k]
    weights = torch.softmax(-values, dim=-1)
    emb = _dense(gelu(_dense(values[..., None], p, "edge_fc1")), p, "edge_fc2")
    message = (weights[..., None] * emb).sum(-2)
    h = h + _norm(_dropout(message, rate, gen), p, "message_norm")
    y = _dropout(gelu(_dense(h, p, "head_fc1")), rate, gen)
    u = _dense(y, p, "head_fc2")[..., 0]
    return u - u.mean(-1, keepdim=True), u_pre


# --- the loss --------------------------------------------------------------------

def one_gnn_loss(cost: torch.Tensor, u: torch.Tensor, u_target: torch.Tensor,
                 greedy: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
    """mean(primal gap / n) + mean(hinge) + 0.1 mean(MSE(u, u*)), with
    v = min_i (C_ij - u_i), the dual lower bound sum u + sum v, and
    ``greedy(cost, reduced)`` the primal upper bound (no gradient).  Returns
    the loss and the batch means of its parts."""
    B, n, m = cost.shape
    v = (cost - u[..., :, None]).amin(-2)
    dual_lower = u.sum(-1) + v.sum(-1)
    feas = torch.relu(u[..., :, None] + v[..., None, :] - cost).sum((-2, -1)) / float(n * m)
    reduced = (cost - u[..., :, None] - v[..., None, :]).detach()
    gap = greedy(cost.detach(), reduced) - dual_lower
    u_reg = ((u - u_target) ** 2).sum(-1) / float(n)
    loss = (gap / float(n)).mean() + feas.mean() + 0.1 * u_reg.mean()
    return loss, {"u_mse": float(u_reg.detach().mean()), "feas": float(feas.detach().mean()),
                  "primal_gap": float(gap.detach().mean())}


# --- training ----------------------------------------------------------------------

class Reference:
    """The reference training run: ``steps(batches, dropout_seed)`` from the
    checkpoint's weights (flax names, numpy arrays), optax's
    clip_by_global_norm then adamw at a constant learning rate, its matrix
    products in float32 with TF32 off (``tf32=True`` computes them in TF32:
    the control's precision)."""

    def __init__(self, params: Dict[str, np.ndarray], layers: int, topk: int, dropout: float,
                 lr: float, weight_decay: float, grad_clip: float, device: torch.device,
                 greedy: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], tf32: bool = False,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.names = sorted(params)
        self.p = {k: torch.tensor(params[k], dtype=torch.float32, device=device)
                  for k in self.names}
        self.layers, self.topk, self.rate = layers, topk, dropout
        self.lr, self.wd, self.clip = lr, weight_decay, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.greedy, self.tf32 = greedy, tf32
        self.device = device
        self.mu = {k: torch.zeros_like(t) for k, t in self.p.items()}
        self.nu = {k: torch.zeros_like(t) for k, t in self.p.items()}
        self.count = 0

    def loss_and_grads(self, cost, u_target, gen):
        params = {k: t.detach().requires_grad_(True) for k, t in self.p.items()}
        cost, u_target = robust_normalize(cost, u_target)
        with torch.no_grad():
            feat = row_features(cost)
        u, u_pre = forward(params, feat, cost, self.layers, self.topk, self.rate, gen)
        loss, parts = one_gnn_loss(cost, u, u_target, self.greedy)
        grads = torch.autograd.grad(loss, [params[k] for k in self.names], allow_unused=True)
        parts["loss"] = float(loss.detach())
        parts["out"] = torch.cat([u_pre, u], -1).detach()
        return parts, {k: (torch.zeros_like(self.p[k]) if g is None else g)
                       for k, g in zip(self.names, grads)}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step; returns the clipped gradients it applied."""
        norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
        scale = 1.0 if norm < self.clip else self.clip / norm
        clipped = {k: g * scale for k, g in grads.items()}
        self.count += 1
        for k, g in clipped.items():
            self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * g
            self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g * g
            mu_hat = self.mu[k] / (1 - self.b1 ** self.count)
            nu_hat = self.nu[k] / (1 - self.b2 ** self.count)
            self.p[k] = self.p[k] - self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps)
                                               + self.wd * self.p[k])
        return clipped

    def steps(self, batches: List[Tuple[torch.Tensor, torch.Tensor]], dropout_seed: int):
        """Run the batches with dropout from a generator on the batches'
        device seeded with ``dropout_seed``; returns (each step's loss and
        its parts, with ``out`` the model's u_pre and u side by side, the
        first clipped gradient's norms, the change's norms after each
        step), the norms by leaf name."""
        gen = torch.Generator(device=self.device).manual_seed(int(dropout_seed))
        start = {k: t.clone() for k, t in self.p.items()}
        parts, first, changes = [], None, []
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            for cost, u_target in batches:
                step_parts, grads = self.loss_and_grads(cost, u_target, gen)
                clipped = self.update(grads)
                parts.append(step_parts)
                if first is None:
                    first = {k: float(g.norm()) for k, g in clipped.items()}
                changes.append({k: float((self.p[k] - start[k]).norm()) for k in self.names})
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        return parts, first, changes
