"""Learning-rate schedule and optimizer: linear warmup then cosine decay;
AdamW behind global-norm clipping.

Port of ``lapgnn_tpu/train/schedule.py`` (``warmup_cosine`` :15,
``make_optimizer`` :35), which builds both from optax.  The port writes
optax's arithmetic out:

  * ``warmup_cosine`` is ``optax.warmup_cosine_decay_schedule`` with
    ``init_value=0``: the first update (step 0) has a learning rate of 0;
  * ``AdamW.step`` applies, leaf by leaf, ``clip_by_global_norm`` (the
    gradients scale by ``max_norm / norm`` only when ``norm >= max_norm``;
    ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``), then
    ``scale_by_adam`` (bias-corrected moments, ``eps`` outside the root),
    then ``add_decayed_weights`` (``+ wd * p`` on every leaf), then the
    step ``-lr``: ``p += -lr * (adam + wd * p)``.  ``torch.optim.AdamW``
    would scale p by ``(1 - lr * wd)`` first, which rounds differently.

The moments stay on the parameters' device and nothing is read back to
the host, so a step queues without a synchronisation.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch

__all__ = ["AdamW", "make_optimizer", "warmup_cosine"]

Schedule = Callable[[int], float]


def warmup_cosine(
    base_lr: float,
    warmup_steps: int,
    total_steps: int,
    min_lr: float = 0.0,
) -> Schedule:
    """Linear warmup from 0 to ``base_lr`` over ``warmup_steps``, then cosine
    decay to ``min_lr`` at ``total_steps``; a function of the step count."""
    warmup_steps = max(1, warmup_steps)
    total_steps = max(warmup_steps + 1, total_steps)
    decay_steps = total_steps - warmup_steps
    alpha = 0.0 if base_lr == 0.0 else min_lr / base_lr

    def schedule(step: int) -> float:
        if step < warmup_steps:
            frac = 1.0 - min(max(step, 0), warmup_steps) / warmup_steps
            return (0.0 - base_lr) * frac + base_lr
        count = min(float(step - warmup_steps), float(decay_steps))
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return base_lr * ((1.0 - alpha) * cosine + alpha)

    return schedule


class AdamW:
    """optax ``chain(clip_by_global_norm(grad_clip), adamw(lr, weight_decay))``
    over a list of parameters, updated in place.

    ``step(grads)`` takes one gradient per parameter (zeros for a parameter
    the loss does not reach: optax decays and moves it all the same).  The
    schedule is read at the count of earlier steps, as optax reads it."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        lr: Schedule | float,
        weight_decay: float = 1e-4,
        grad_clip: float = 1.0,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ):
        self.params: List[torch.Tensor] = list(params)
        self.lr = lr if callable(lr) else (lambda step, _lr=float(lr): _lr)
        self.weight_decay = float(weight_decay)
        self.grad_clip = float(grad_clip)
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        g_norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
        factor = torch.where(g_norm < self.grad_clip, 1.0, self.grad_clip / g_norm)
        return torch._foreach_mul(grads, factor)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = [g.detach() for g in grads]
        if len(grads) != len(self.params):
            raise ValueError(f"AdamW.step: {len(grads)} gradients for {len(self.params)} parameters")
        g = self._clip(grads)
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) * g + b1 * mu; nu = (1 - b2) * g^2 + b2 * nu
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        k = self.count + 1
        mu_hat = torch._foreach_div(self.mu, 1.0 - b1**k)
        nu_hat = torch._foreach_div(self.nu, 1.0 - b2**k)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(upd, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_mul_(upd, -self.lr(self.count))
        torch._foreach_add_(self.params, upd)
        self.count += 1

    def state_dict(self) -> Dict[str, object]:
        return {
            "count": self.count,
            "mu": [m.detach().cpu() for m in self.mu],
            "nu": [v.detach().cpu() for v in self.nu],
        }

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.count = int(state["count"])
        self.mu = [m.to(p.device, p.dtype).clone() for m, p in zip(state["mu"], self.params)]
        self.nu = [v.to(p.device, p.dtype).clone() for v, p in zip(state["nu"], self.params)]


def make_optimizer(
    params: Sequence[torch.Tensor],
    lr: Schedule | float,
    weight_decay: float = 1e-4,
    grad_clip: float = 1.0,
) -> AdamW:
    """AdamW with global-norm clipping over ``params``."""
    return AdamW(params, lr, weight_decay=weight_decay, grad_clip=grad_clip)
