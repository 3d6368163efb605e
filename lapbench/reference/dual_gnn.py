"""Plain reference of a DualGNN training step, in float32 PyTorch.

Written from the model's published description (the original system's
``gnn/dual_gnn.py:146-204``, bipartite GATv2-style attention over all n^2
edges) and the loss and optimizer it is trained with: dense graph features,
the DualGNN forward, the dual loss with its greedy primal bound, its
regression terms and sentinel clipping, and optax's
``chain(clip_by_global_norm, adamw)``.  Plain ``torch`` operations and
autograd, in the order the mathematics states them; no kernel, no fused
product, no cache.  Imports nothing of the program or of JAX.

The weights are read from the checkpoint's raw ``params.msgpack`` by this
file's own reader (flax's msgpack layout), so nothing the program loaded
reaches the reference.  Dropout masks are drawn as the configuration's
dropout draws them: one seed a layer from the caller's CPU generator, a
device generator seeded with it, and one uniform draw per dropout site in
the order of the forward (edge MLP, row attention, column attention, row
update, column update), kept where the draw is below 1 - rate.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Reference", "graph_features", "read_msgpack_params"]

BIG = 1.0e6
TAU = 1e-3
EPS = 1e-9
POS_FREQS = (1, 2, 4, 8)
LN_EPS = 1e-5


# --- the checkpoint ----------------------------------------------------------

def read_msgpack_params(data: bytes) -> Dict[str, np.ndarray]:
    """flax's ``msgpack_serialize`` output -> {"a/b/c": array}: nested maps
    with string keys; an array is an ext value of type 1 whose payload is
    msgpack ``[shape, dtype name, bytes]``."""
    pos = 0

    def take(k):
        nonlocal pos
        out = data[pos:pos + k]
        pos += k
        return out

    def unpack(fmt):
        return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]

    def value():
        b = take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return {value(): value() for _ in range(b & 0x0F)}
        if 0x90 <= b <= 0x9F:
            return [value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in sized:
            return bytes(take(unpack(sized[b])))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return take(unpack(strs[b])).decode()
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in nums:
            return unpack(nums[b])
        if b in (0xDC, 0xDD):
            return [value() for _ in range(unpack(">H" if b == 0xDC else ">I"))]
        if b in (0xDE, 0xDF):
            return {value(): value() for _ in range(unpack(">H" if b == 0xDE else ">I"))}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext or b in (0xC7, 0xC8, 0xC9):
            size = fixext[b] if b in fixext else unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = unpack(">b")
            payload = take(size)
            if code != 1:
                raise ValueError(f"unsupported msgpack ext type {code}")
            shape, dtype, raw = read_value(payload)
            return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
        raise ValueError(f"unsupported msgpack byte 0x{b:02x}")

    def read_value(payload):
        nonlocal data, pos
        saved = data, pos
        data, pos = payload, 0
        try:
            return value()
        finally:
            data, pos = saved

    tree = value()
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = v

    walk(tree.get("params", tree), "")
    return flat


# --- features ------------------------------------------------------------------

def _median_sorted(s: torch.Tensor) -> torch.Tensor:
    m = s.shape[-1]
    return s[..., m // 2] if m % 2 else 0.5 * (s[..., m // 2 - 1] + s[..., m // 2])


def _stats(C: torch.Tensor, dim: int):
    """min, max, mean, population std, median, MAD (floored at EPS) and the
    entropy of softmax(-C), along ``dim``."""
    srt = torch.sort(C.movedim(dim, -1), dim=-1).values
    med = _median_sorted(srt)
    mad = torch.clamp_min(_median_sorted(torch.sort((srt - med[..., None]).abs(), dim=-1).values), EPS)
    e = torch.exp(-(C - C.amin(dim, keepdim=True)))
    p = e / (e.sum(dim, keepdim=True) + EPS)
    ent = -(p * torch.log(p + EPS)).sum(dim)
    return C.amin(dim), C.amax(dim), C.mean(dim), C.std(dim, correction=0), med, mad, ent


def _ranks(C: torch.Tensor, dim: int) -> torch.Tensor:
    """Rank of each entry along ``dim`` (ties by position), over len - 1."""
    X = C.movedim(dim, -1)
    n = X.shape[-1]
    order = torch.argsort(X, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(n, device=C.device).expand_as(order))
    return (ranks.to(torch.float32) / torch.tensor(float(max(n - 1, 1)), device=C.device)).movedim(-1, dim)


def _positions(n: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    freqs = torch.tensor(POS_FREQS, dtype=torch.float32, device=device)[None, :]
    angle = 2.0 * math.pi * pos * freqs / float(max(1, n - 1))
    return torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).reshape(n, 2 * len(POS_FREQS))


def graph_features(C: torch.Tensor):
    """(B, n, m) costs -> row features (B, n, 14), column features
    (B, m, 14), edge features (B, n, m, 10): per node min, max, mean, std,
    MAD, entropy and 8 positional encodings; per edge the cost scaled by its
    row's median and MAD, its row and column ranks, its gaps to the row and
    column minima, the row's and column's shares of near-minimal entries
    (within TAU), the row's and column's entropies, and a zero channel."""
    B, n, m = C.shape
    r_mn, r_mx, r_mean, r_std, r_med, r_mad, r_ent = _stats(C, -1)
    c_mn, c_mx, c_mean, c_std, c_med, c_mad, c_ent = _stats(C, -2)
    row_tie = ((C - r_mn[..., :, None]) <= TAU).to(torch.float32).sum(-1) / torch.tensor(float(m), device=C.device)
    col_tie = ((C - c_mn[..., None, :]) <= TAU).to(torch.float32).sum(-2) / torch.tensor(float(n), device=C.device)
    edge = torch.stack([
        (C - r_med[..., :, None]) / r_mad[..., :, None],
        _ranks(C, -1),
        _ranks(C, -2),
        C - r_mn[..., :, None],
        C - c_mn[..., None, :],
        row_tie[..., :, None].expand(B, n, m),
        col_tie[..., None, :].expand(B, n, m),
        r_ent[..., :, None].expand(B, n, m),
        c_ent[..., None, :].expand(B, n, m),
        torch.zeros_like(C),
    ], dim=-1)
    row = torch.cat([torch.stack([r_mn, r_mx, r_mean, r_std, r_mad, r_ent], -1),
                     _positions(n, C.device).expand(B, n, 8)], -1)
    col = torch.cat([torch.stack([c_mn, c_mx, c_mean, c_std, c_mad, c_ent], -1),
                     _positions(m, C.device).expand(B, m, 8)], -1)
    return row, col, edge


# --- the model -----------------------------------------------------------------

def _dense(x, p, name):
    y = x @ p[name + "/kernel"]
    b = p.get(name + "/bias")
    return y if b is None else y + b


def _norm(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[name + "/scale"], p[name + "/bias"], eps=LN_EPS)


def _dropout(x, rate, gen):
    if gen is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device, dtype=x.dtype) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _attention(src, dst, edge, bias, values, rate, gen):
    """Receiver i attends over senders j: score (B, n_i, n_j, H), softmax
    over j, then the values of the senders (B, n_j, H, D)."""
    score = F.leaky_relu(dst[:, :, None, :] + src[:, None, :, :] + edge + bias, 0.2)
    w = torch.softmax(score, dim=2)
    w = torch.where(torch.isfinite(w), w, 0.0)
    w = _dropout(w, rate, gen)
    msg = torch.einsum("bijh,bjhd->bihd", w, values)
    return msg.reshape(msg.shape[0], msg.shape[1], -1)


def forward(p: Dict[str, torch.Tensor], row_feat, col_feat, edge_feat, layers: int, heads: int,
            rate: float, dropout_gen: Optional[torch.Generator]):
    """u (B, n) mean-centred and v_hint (B, m) shifted by the mean of u."""
    gelu = F.gelu
    row = _norm(gelu(_dense(row_feat, p, "row_encoder_fc")), p, "row_encoder_norm")
    col = _norm(gelu(_dense(col_feat, p, "col_encoder_fc")), p, "col_encoder_norm")
    B, n, m = edge_feat.shape[:3]
    for i in range(layers):
        name = f"layer_{i}/"
        gen = None
        if dropout_gen is not None and rate > 0.0:
            seed = int(torch.randint(0, 2**62, (1,), generator=dropout_gen).item())
            gen = torch.Generator(edge_feat.device).manual_seed(seed)
        e = _dropout(gelu(_dense(edge_feat, p, name + "edge_fc1")), rate, gen)
        e = gelu(_dense(e, p, name + "edge_fc2"))
        e = _dense(e, p, name + "edge_fc3")
        hidden = e.shape[-1]
        D = hidden // heads
        eh = e.view(B, n, m, heads, D)
        a_row, a_col = p[name + "attn_row"], p[name + "attn_col"]
        r_edge = torch.einsum("bijhd,hd->bijh", eh, a_row[:, 2])
        c_edge = torch.einsum("bijhd,hd->bjih", eh, a_col[:, 2])
        rp = _dense(row, p, name + "row_proj").view(B, n, heads, D)
        cp = _dense(col, p, name + "col_proj").view(B, m, heads, D)
        rv = _dense(row, p, name + "row_val").view(B, n, heads, D)
        cv = _dense(col, p, name + "col_val").view(B, m, heads, D)
        row_msg = _attention((cp * a_row[:, 1]).sum(-1), (rp * a_row[:, 0]).sum(-1), r_edge,
                             p[name + "attn_row_bias"], cv, rate, gen)
        col_msg = _attention((rp * a_col[:, 1]).sum(-1), (cp * a_col[:, 0]).sum(-1), c_edge,
                             p[name + "attn_col_bias"], rv, rate, gen)
        ru = _dropout(gelu(_dense(torch.cat([row, row_msg], -1), p, name + "row_update")), rate, gen)
        cu = _dropout(gelu(_dense(torch.cat([col, col_msg], -1), p, name + "col_update")), rate, gen)
        row = _norm(row + ru, p, name + "row_norm")
        col = _norm(col + cu, p, name + "col_norm")
    u = _dense(row, p, "row_out")[..., 0]
    v_hint = _dense(col, p, "col_out")[..., 0]
    mean_u = u.mean(-1, keepdim=True)
    return u - mean_u, v_hint + mean_u


# --- the loss --------------------------------------------------------------------

@torch.no_grad()
def greedy_upper(cost: torch.Tensor, reduced: torch.Tensor) -> torch.Tensor:
    """Rows in ascending order of their least reduced cost (ties by
    position) each take their cheapest unused column by reduced cost (the
    first on ties) and add its cost; float32 sums in visiting order."""
    B, n, _ = cost.shape
    order = torch.argsort(reduced.amin(-1), dim=-1, stable=True)
    ar = torch.arange(B, device=cost.device)
    used = torch.zeros((B, n), dtype=torch.bool, device=cost.device)
    total = torch.zeros(B, dtype=torch.float32, device=cost.device)
    for t in range(n):
        row = order[:, t]
        j = torch.where(used, torch.inf, reduced[ar, row]).argmin(-1)
        used[ar, j] = True
        total = total + cost[ar, row, j]
    return total


def dual_loss(cost, u, v_hint, u_target):
    """mean(primal gap / n) + mean(hinge) + 0.1 mean(MSE(v_hint, v)) +
    0.1 mean(gauge-free MSE(u, u*)), on the sentinel-clipped matrix, with
    v = min_i (C_ij - u_i) and the greedy bound as the primal.  Returns the
    loss and the batch means of its regression term, hinge and primal gap."""
    finite = cost < 0.5 * BIG
    fmax = torch.where(finite, cost, -torch.inf).amax((-2, -1), keepdim=True)
    fmax = torch.where(torch.isfinite(fmax), fmax, torch.inf)
    cost = torch.minimum(cost, fmax)
    B, n, m = cost.shape
    v = (cost - u[..., :, None]).amin(-2)
    dual_lower = u.sum(-1) + v.sum(-1)
    feas = torch.relu(u[..., :, None] + v[..., None, :] - cost).sum((-2, -1)) / float(n * m)
    reduced = (cost - u[..., :, None] - v[..., None, :]).detach()
    gap = greedy_upper(cost.detach(), reduced) - dual_lower
    v_reg = ((v_hint - v) ** 2).sum(-1) / float(n)
    diff = u - u_target
    u_reg = ((diff - diff.sum(-1, keepdim=True) / float(n)) ** 2).sum(-1) / float(n)
    loss = (gap / float(n)).mean() + feas.mean() + 0.1 * v_reg.mean() + 0.1 * u_reg.mean()
    return loss, {"v_mse": float(v_reg.detach().mean()), "feas": float(feas.detach().mean()),
                  "primal_gap": float(gap.detach().mean())}


# --- training ----------------------------------------------------------------------

class Reference:
    """The reference training run: ``steps(batches)`` from the checkpoint's
    weights, with optax's clip_by_global_norm then adamw at a constant
    learning rate."""

    def __init__(self, params: Dict[str, np.ndarray], layers: int, heads: int, dropout: float,
                 lr: float, weight_decay: float, grad_clip: float, device: torch.device,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.names = sorted(params)
        self.p = {k: torch.tensor(params[k], dtype=torch.float32, device=device) for k in self.names}
        self.layers, self.heads, self.rate = layers, heads, dropout
        self.lr, self.wd, self.clip = lr, weight_decay, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = {k: torch.zeros_like(t) for k, t in self.p.items()}
        self.nu = {k: torch.zeros_like(t) for k, t in self.p.items()}
        self.count = 0

    def loss_and_grads(self, cost, u_target, dropout_gen):
        params = {k: t.detach().requires_grad_(True) for k, t in self.p.items()}
        with torch.no_grad():
            row, col, edge = graph_features(cost)
        u, v_hint = forward(params, row, col, edge, self.layers, self.heads, self.rate, dropout_gen)
        loss, parts = dual_loss(cost, u, v_hint, u_target)
        grads = torch.autograd.grad(loss, [params[k] for k in self.names], allow_unused=True)
        parts["loss"] = float(loss.detach())
        parts["out"] = torch.cat([u, v_hint], -1).detach()
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
        """Run the batches; returns (each step's loss and its parts, with
        ``out`` the model's outputs u and v_hint side by side, the first
        clipped gradient's norms, the change's norms after each step), the
        norms by leaf name."""
        gen = torch.Generator().manual_seed(int(dropout_seed))
        start = {k: t.clone() for k, t in self.p.items()}
        parts, first, changes = [], None, []
        for cost, u_target in batches:
            step_parts, grads = self.loss_and_grads(cost, u_target, gen)
            clipped = self.update(grads)
            parts.append(step_parts)
            if first is None:
                first = {k: float(g.norm()) for k, g in clipped.items()}
            changes.append({k: float((self.p[k] - start[k]).norm()) for k in self.names})
        return parts, first, changes
