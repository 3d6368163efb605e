"""K3 row-feature statistics: CUDA kernel and its plain version.

Replaces ``lapgnn_tpu/ops/pallas/features.py:pallas_row_features_stats``
(:193, body ``_feature_kernel`` :119): the 13 statistic channels of the 21-D
OneGNN row features (``STAT_CHANNELS``) in one read of C, with exact median,
MAD and k=10 selection by a 32-step bisection on order-isomorphic uint32 keys.

Bound on this card: the kernel is held to its bytes bound (C read once,
``B*n*m*4`` bytes, 13 floats a row written); in practice the selection's
compare passes (96 compares per element) and the moment passes (expf twice,
logf, a division) bound it: several times the time the card needs to stream
C.  Design (``csrc/features.cu``): the row lives in
registers as keys, 64 a lane.  One warp owns a row of m <= 2048 (eight rows a
block, no barrier anywhere); 2, 4 or 8 warps share a longer row up to 16384
and exchange their partial counts through shared memory once per step.  The
median's and the rank-k selection share their 32 steps; the MAD's follows on
keys computed once.  Rows beyond 16384 take the shared-memory path (one block
a row, the row staged in dynamic shared memory) up to the card's limit (m
about 58K on an H100); longer rows raise.  ``row_features_geometry`` is the
launch geometry the wrapper hands to the kernel.

``row_features_stats_plain`` transcribes the JAX kernel body, bisection and
all, so it compares one to one with ``pallas_row_features_stats``; the
sort-based ``ops.features.row_features`` is a second, independent reference.
``joint_select_padded`` transcribes the kernel's own selection arithmetic
(two ranks in the same 32 steps over an index-masked padded tile) for the CPU
tests.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .colmin import col_min

__all__ = [
    "STAT_CHANNELS",
    "RowFeaturesGeometry",
    "joint_select_padded",
    "median_from_padded",
    "pad_to_tile",
    "row_features_geometry",
    "row_features_stats",
    "row_features_stats_plain",
    "selections_padded",
    "stats_kernel",
]

EPS = 1e-9

STAT_CHANNELS = (
    "min", "max", "mean", "std", "mad", "entropy", "second_best_gap",
    "competition", "k_mean", "k_std", "difficulty", "near_best",
    "is_col_best",
)

# uint32 keys are held in int64: torch has no full set of unsigned ops.
_SIGN = 0x80000000
_FULL = 0xFFFFFFFF


def _to_key(x: torch.Tensor) -> torch.Tensor:
    """Order-isomorphic f32 -> uint32 (in int64): negatives bit-inverted,
    positives sign-flipped (``_to_key``).  +0.0 and -0.0 get different keys,
    exactly as in the JAX kernel."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & _FULL
    return torch.where((u & _SIGN) != 0, _FULL - u, u | _SIGN)


def _from_key(k: torch.Tensor) -> torch.Tensor:
    u = torch.where((k & _SIGN) != 0, k ^ _SIGN, _FULL - k)
    u = torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)
    return u.view(torch.float32)


def _kth_key(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Exact rank-k (1-indexed) smallest key along the last axis."""
    prefix = torch.zeros(keys.shape[:-1], dtype=torch.int64, device=keys.device)
    for bit in range(31, -1, -1):
        cand = prefix | (1 << bit)
        cnt = (keys < cand[..., None]).sum(-1)
        prefix = torch.where(cnt >= k, prefix, cand)
    return prefix


def _next_distinct_or_same(keys, kth_key, rank: int):
    kk = kth_key[..., None]
    le = (keys <= kk).sum(-1)
    bigger = torch.where(keys > kk, keys, torch.full_like(keys, _FULL)).amin(-1)
    return torch.where(le >= rank + 1, kth_key, bigger)


def _median_from_keys(keys, m: int):
    mid = m // 2
    if m % 2 == 1:
        return _from_key(_kth_key(keys, mid + 1))
    lo_key = _kth_key(keys, mid)
    hi_key = _next_distinct_or_same(keys, lo_key, mid)
    return 0.5 * (_from_key(lo_key) + _from_key(hi_key))


def row_features_stats_plain(C: torch.Tensor, colmin: torch.Tensor) -> torch.Tensor:
    """(…, n, m) f32 and its (…, m) column minima -> (…, n, 13)."""
    m = C.shape[-1]
    k = min(10, m)
    inv_m = 1.0 / m

    r_min = C.amin(-1)
    r_max = C.amax(-1)
    mean = C.sum(-1) * inv_m
    dm = C - mean[..., None]
    std = torch.sqrt(torch.clamp_min((dm * dm).sum(-1) * inv_m, 0.0))

    e = torch.exp(-(C - r_min[..., None]))
    p = e / (e.sum(-1, keepdim=True) + EPS)
    entropy = -(p * torch.log(p + EPS)).sum(-1)

    near = (C <= r_min[..., None] * 1.1).to(C.dtype).sum(-1) * inv_m

    min_cnt = (C == r_min[..., None]).sum(-1)
    above = torch.where(C > r_min[..., None], C, torch.inf).amin(-1)
    second = torch.where(min_cnt > 1, r_min, above)
    gap = second - r_min
    span = r_max - r_min
    competition = gap / (span + EPS)

    if m >= 2:
        difficulty = 1.0 / (span / (m - 1) + EPS)
    else:
        difficulty = torch.zeros_like(r_min)

    keys = _to_key(C)
    med = _median_from_keys(keys, m)
    dkeys = _to_key(torch.abs(C - med[..., None]))
    mad = torch.clamp_min(_median_from_keys(dkeys, m), EPS)

    t_key = _kth_key(keys, k)
    T = _from_key(t_key)
    below = keys < t_key[..., None]
    c_lt = below.sum(-1)
    take = (k - c_lt).to(C.dtype)
    ks1 = torch.where(below, C, 0.0).sum(-1) + take * T
    k_mean = ks1 / k
    d = C - k_mean[..., None]
    ksd = torch.where(below, d * d, 0.0).sum(-1)
    dT = T - k_mean
    k_std = torch.sqrt(torch.clamp_min((ksd + take * dT * dT) / k, 0.0))

    is_col_best = (C == colmin[..., None, :]).to(C.dtype).sum(-1) * inv_m

    if m < 2:
        gap = torch.zeros_like(r_min)
        competition = torch.zeros_like(r_min)

    return torch.stack(
        [r_min, r_max, mean, std, mad, entropy, gap, competition,
         k_mean, k_std, difficulty, near, is_col_best],
        dim=-1,
    )


# Launch geometry of ``csrc/features.cu`` (its constants, mirrored).
ITEMS_PER_LANE = 64
ROWS_PER_BLOCK = 8  # one-warp rows in a block
MAX_WARPS_PER_ROW = 8
REGISTERS_PATH_MAX_M = ITEMS_PER_LANE * 32 * MAX_WARPS_PER_ROW
SHARED_PATH_THREADS = 256
SHARED_PATH_STATIC_BYTES = 96  # one float, int and uint32 partial per warp
H100_SHARED_BYTES_PER_BLOCK = 232448  # 227 KB, the opt-in limit


@dataclass(frozen=True)
class RowFeaturesGeometry:
    """How the kernel is launched for rows of m floats.

    ``path`` is ``"registers"`` (``warps_per_row`` warps hold the row as 64
    keys a lane) or ``"shared"`` (``warps_per_row`` 0: one block of 256
    threads, the row in dynamic shared memory).  ``vector`` selects 16-byte
    loads."""

    path: str
    warps_per_row: int
    items_per_lane: int
    vector: bool
    threads: int
    rows_per_block: int
    smem_bytes: int

    def blocks(self, rows: int) -> int:
        return -(-rows // self.rows_per_block)


def row_features_geometry(
    m: int,
    aligned: bool,
    smem_limit: int = H100_SHARED_BYTES_PER_BLOCK,
    path: str | None = None,
) -> RowFeaturesGeometry:
    """The path a row length takes.  ``aligned``: the bases of C and of the
    column minima are 16-byte aligned (16-byte loads also need m % 4 == 0).
    ``smem_limit`` is the card's shared memory per block; ``path`` forces
    ``"shared"`` where the registers path would be taken (for timing the
    two side by side).  Raises ValueError for a row no path holds."""
    if m < 1:
        raise ValueError(f"row_features_stats: m={m}")
    if path not in (None, "registers", "shared"):
        raise ValueError(f"row_features_stats: unknown path {path!r}")
    warps = 1
    while ITEMS_PER_LANE * 32 * warps < m:
        warps *= 2
    if path != "shared" and m <= REGISTERS_PATH_MAX_M:
        return RowFeaturesGeometry(
            path="registers",
            warps_per_row=warps,
            items_per_lane=ITEMS_PER_LANE,
            vector=bool(aligned) and m % 4 == 0,
            threads=32 * (ROWS_PER_BLOCK if warps == 1 else warps),
            rows_per_block=ROWS_PER_BLOCK if warps == 1 else 1,
            # the warps' exchange slots; a one-warp row needs none
            smem_bytes=16 * warps if warps > 1 else 0,
        )
    if path == "registers":
        raise ValueError(
            f"row_features_stats: a row of m={m} floats exceeds the registers "
            f"path ({REGISTERS_PATH_MAX_M})"
        )
    smem = 4 * m + SHARED_PATH_STATIC_BYTES
    if smem > smem_limit:
        raise ValueError(
            f"row_features_stats: a row of m={m} floats exceeds the "
            f"{(smem_limit - SHARED_PATH_STATIC_BYTES) // 4}-float shared-memory "
            "limit of this card"
        )
    return RowFeaturesGeometry(
        path="shared", warps_per_row=0, items_per_lane=0, vector=False,
        threads=SHARED_PATH_THREADS, rows_per_block=1, smem_bytes=smem,
    )


def pad_to_tile(keys: torch.Tensor, geometry: RowFeaturesGeometry, fill: int = _FULL):
    """(…, m) keys -> ((…, T, items) padded tile, (T, items) validity): the
    registers path's slot layout.  Slot i of thread t holds element
    ``(q*T + t)*4 + c`` with ``i = 4q + c`` (vector) or ``i*T + t`` (scalar);
    slots past the row's end hold ``fill``."""
    m = keys.shape[-1]
    T = 32 * geometry.warps_per_row
    t = torch.arange(T, device=keys.device)[:, None]
    i = torch.arange(geometry.items_per_lane, device=keys.device)[None, :]
    j = ((i // 4) * T + t) * 4 + i % 4 if geometry.vector else i * T + t
    valid = j < m
    tile = keys[..., j.clamp(max=m - 1)]
    return torch.where(valid, tile, torch.full_like(tile, fill)), valid


def _count_below(tile: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """Keys of each tile below ``cand`` (!= 0), counted as the kernel does:
    the carry of key + (2^32 - cand) marks a key not below it, and the rest
    of the slots, padding never among them, are below."""
    carry = (tile + ((1 << 32) - cand[..., None, None])) >> 32
    return tile.shape[-1] * tile.shape[-2] - carry.sum((-1, -2))


def joint_select_padded(tile: torch.Tensor, rank_a: int, rank_b: int):
    """The kernel's selection step: the rank-``rank_a`` and rank-``rank_b``
    smallest keys of each padded tile in the same 32 bisection steps, two
    candidates and two counts per pass over every slot (padding holds
    0xFFFFFFFF, never below a candidate).  Also returns the number of keys
    below the rank-``rank_b`` key: the count at the step that last raised
    its prefix."""
    pa = torch.zeros(tile.shape[:-2], dtype=torch.int64, device=tile.device)
    pb = pa.clone()
    below_b = pa.clone()
    for bit in range(31, -1, -1):
        ca, cb = pa | (1 << bit), pb | (1 << bit)
        na, nb = _count_below(tile, ca), _count_below(tile, cb)
        pa = torch.where(na >= rank_a, pa, ca)
        below_b = torch.where(nb < rank_b, nb, below_b)
        pb = torch.where(nb < rank_b, cb, pb)
    return pa, pb, below_b


def median_from_padded(tile: torch.Tensor, valid: torch.Tensor, m: int, sel: torch.Tensor):
    """The kernel's median from the selected key ``sel`` (rank mid+1 for odd
    m, rank mid for even m).  ``le`` masks by index: padding would count as
    <= lo when lo is 0xFFFFFFFF itself; ``bigger`` needs no mask."""
    if m % 2 == 1:
        return _from_key(sel)
    lo = sel[..., None, None]
    le = ((tile <= lo) & valid).sum((-1, -2))
    bigger = torch.where(tile > lo, tile, torch.full_like(tile, _FULL)).amin((-1, -2))
    hi = torch.where(le >= m // 2 + 1, sel, bigger)
    return 0.5 * (_from_key(sel) + _from_key(hi))


def selections_padded(C: torch.Tensor, geometry: RowFeaturesGeometry):
    """(median, rank-k key, keys below it, MAD before its clamp) of each row
    of C as the registers path computes them: for the CPU tests."""
    m = C.shape[-1]
    mid = m // 2
    rank_a = mid + 1 if m % 2 == 1 else mid
    tile, valid = pad_to_tile(_to_key(C), geometry)
    pa, t_key, c_lt = joint_select_padded(tile, rank_a, min(10, m))
    med = median_from_padded(tile, valid, m, pa)
    dtile, _ = pad_to_tile(_to_key(torch.abs(C - med[..., None])), geometry)
    pd, _, _ = joint_select_padded(dtile, rank_a, rank_a)
    return med, t_key, c_lt, median_from_padded(dtile, valid, m, pd)


def _launch(Cb: torch.Tensor, colmin: torch.Tensor, geometry: RowFeaturesGeometry) -> torch.Tensor:
    """Launch the statistics kernel on a (B, n, m) CUDA batch with its
    (B, m) column minima."""
    from ._lib import KERNEL_LIBS, check, ptr, stream_ptr

    B, n, m = Cb.shape
    lib = KERNEL_LIBS["features"].load()
    out = torch.empty((B, n, len(STAT_CHANNELS)), dtype=torch.float32, device=Cb.device)
    with torch.cuda.device(Cb.device):
        rc = lib.lapgnn_row_features_stats(
            ptr(Cb), ptr(colmin), ptr(out), B, n, m, min(10, m),
            geometry.warps_per_row, int(geometry.vector),
            stream_ptr(Cb.device),
        )
    check(rc, "row_features_stats kernel")
    row_features_stats.launches += 1
    return out


def _shared_limit(device: torch.device) -> int:
    """Shared memory a block of the shared path may use on this card."""
    from ._lib import KERNEL_LIBS, check

    lib = KERNEL_LIBS["features"].load()
    with torch.cuda.device(device):
        max_m = lib.lapgnn_row_features_max_m(device.index or 0)
    if max_m < 0:
        check(-max_m, "row_features_stats shared-memory query")
    return 4 * max_m + SHARED_PATH_STATIC_BYTES


def stats_kernel(
    C: torch.Tensor,
    colmin: torch.Tensor | None = None,
    *,
    path: str | None = None,
) -> torch.Tensor:
    """The statistics kernel on a CUDA tensor, (n, m) or (B, n, m).

    ``colmin`` ((m,) or (B, m)) are C's column minima; left out, K1
    (``col_min``) computes them first.  ``path`` reaches
    ``row_features_geometry``, to time one path beside the other."""
    if C.device.type != "cuda":
        raise ValueError(f"row_features_stats: unsupported device {C.device}")
    if C.dtype != torch.float32:
        raise TypeError(f"row_features_stats: C must be float32, got {C.dtype}")
    if C.ndim not in (2, 3):
        raise ValueError(
            f"row_features_stats: C must be (n, m) or (B, n, m), got {tuple(C.shape)}"
        )
    if not C.is_contiguous():
        raise ValueError("row_features_stats: C must be contiguous")
    Cb = C if C.ndim == 3 else C[None]
    B, n, m = Cb.shape
    if n < 1 or m < 1:
        raise ValueError(f"row_features_stats: empty matrix {tuple(C.shape)}")
    if B * n >= 2**31:
        raise ValueError("row_features_stats: B*n exceeds the grid limit")
    if colmin is None:
        colmin = col_min(Cb)
    else:
        colmin = colmin.reshape(B, m)
        if colmin.device != C.device or colmin.dtype != torch.float32 or not colmin.is_contiguous():
            raise ValueError("row_features_stats: colmin must be contiguous float32 on C's device")
    needs_limit = m > REGISTERS_PATH_MAX_M or path == "shared"
    geometry = row_features_geometry(
        m,
        aligned=Cb.data_ptr() % 16 == 0 and colmin.data_ptr() % 16 == 0,
        smem_limit=_shared_limit(Cb.device) if needs_limit else H100_SHARED_BYTES_PER_BLOCK,
        path=path,
    )
    out = _launch(Cb, colmin, geometry)
    return out if C.ndim == 3 else out[0]


def row_features_stats(C: torch.Tensor) -> torch.Tensor:
    """K3: (n, m) -> (n, 13) or (B, n, m) -> (B, n, 13) statistics block.

    is-col-best needs the column minima: they come from K1 (``col_min``)
    inside this wrapper, as ``pallas_col_min`` does inside the TPU wrapper,
    so K1 runs once per call.  A CUDA tensor launches the kernel or raises;
    only a CPU tensor takes the plain versions."""
    if C.device.type == "cpu":
        return row_features_stats_plain(C, col_min(C))
    return stats_kernel(C)


row_features_stats.launches = 0
