"""Launch geometry and arithmetic of the port's K1 / K2, K3 and K4 kernels.

The CUDA sources only compile on a card, so what can be held here is what
surrounds them: the geometry each wrapper hands to its kernel (which path a
row length and an alignment take, threads, shared memory), and plain torch
transcriptions of the kernels' own arithmetic (K3: two ranks selected in the
same 32 bisection steps over an index-masked padded tile, counted by carries;
K4: integer order keys and the two smallest (key, column) pairs; K1 / K2: the
merge tree of stripes, warps and cluster ranks under ``nan_min``) against the
plain versions the kernels are compared with on the card.  Tests marked
``cuda`` run the kernels at the ragged shapes and skip without a card.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lapgnn_tpu_torch.ops.cuda import row_features_stats, two_min
from lapgnn_tpu_torch.ops.cuda.colmin import (
    LONG_STRIPE,
    MAX_BLOCKS,
    SMS,
    col_min_by_tiles,
    col_min_geometry,
    col_min_kernel,
    col_min_plain,
    min_trick_plain,
)
from lapgnn_tpu_torch.ops.cuda.features import (
    H100_SHARED_BYTES_PER_BLOCK,
    _kth_key,
    _median_from_keys,
    _to_key,
    pad_to_tile,
    row_features_geometry,
    row_features_stats_plain,
    selections_padded,
)
from lapgnn_tpu_torch.ops.cuda.twomin import (
    L2_BYTES,
    order_key,
    two_min_by_keys,
    two_min_geometry,
    two_min_kernel,
    two_min_plain,
)

MAX_THREADS = 1024
# the longest row the shared-memory path holds on an H100
MAX_M = (H100_SHARED_BYTES_PER_BLOCK - 96) // 4
BOUNDARY_M = [1, 2, 3, 4, 5, 7, 10, 11, 31, 32, 33, 127, 128, 1000, 1001, 2047, 2048,
              2049, 4095, 4096, 4097, 8191, 8192, 8193, 16383, 16384, 16385, 20000,
              32768, MAX_M]
SELECT_M = [1, 2, 9, 10, 11, 31, 32, 33, 1000, 1001]
K3_RTOL, K3_ATOL = 2e-5, 2e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int64 if t.dtype == torch.float64 else torch.int32)


# ---------------------------------------------------------------- K3 geometry


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m", BOUNDARY_M)
def test_row_features_geometry_at_boundaries(m, aligned):
    g = row_features_geometry(m, aligned)
    assert g.threads <= MAX_THREADS and g.threads % 32 == 0
    assert g.smem_bytes <= H100_SHARED_BYTES_PER_BLOCK
    assert g.vector == (aligned and m % 4 == 0 and g.path == "registers")
    if m <= 16384:
        assert g.path == "registers" and g.items_per_lane == 64
        capacity = g.items_per_lane * 32 * g.warps_per_row
        assert capacity >= m
        assert g.warps_per_row == 1 or capacity // 2 < m  # no warp more than needed
        assert g.warps_per_row in (1, 2, 4, 8)
        assert g.rows_per_block == (8 if g.warps_per_row == 1 else 1)
        assert g.threads == 32 * g.warps_per_row * g.rows_per_block
    else:
        assert g.path == "shared" and g.warps_per_row == 0 and g.rows_per_block == 1
        assert g.smem_bytes >= 4 * m
    assert g.blocks(2048) == -(-2048 // g.rows_per_block)


def test_row_features_geometry_every_m_gets_a_path_or_raises():
    """m = 1 .. 65536: a path within the block limits up to the shared-memory
    limit of the card, ValueError beyond it; the supported range is the
    earlier kernel's."""
    for m in range(1, 65537):
        for aligned in (True, False):
            if m > MAX_M:
                with pytest.raises(ValueError):
                    row_features_geometry(m, aligned)
                continue
            g = row_features_geometry(m, aligned)
            assert g.threads <= MAX_THREADS and g.smem_bytes <= H100_SHARED_BYTES_PER_BLOCK
            assert not g.vector or (aligned and m % 4 == 0)
            assert (g.path == "registers") == (m <= 16384)


def test_row_features_geometry_forced_paths_and_limits():
    assert row_features_geometry(2048, True, path="shared").path == "shared"
    assert row_features_geometry(2048, True, path="registers").warps_per_row == 1
    with pytest.raises(ValueError):
        row_features_geometry(16385, True, path="registers")
    with pytest.raises(ValueError):
        row_features_geometry(20000, True, smem_limit=48 * 1024)  # a smaller card
    with pytest.raises(ValueError):
        row_features_geometry(0, True)
    with pytest.raises(ValueError):
        row_features_geometry(8, True, path="tile")


@pytest.mark.parametrize("m,aligned", [(7, False), (8, True), (33, False), (2048, True),
                                       (2052, True), (4100, True), (4099, False)])
def test_pad_to_tile_holds_each_element_once_in_a_prefix(m, aligned):
    """Every element of the row sits in exactly one slot, and a thread's valid
    slots are a prefix of its slots: the kernel masks by ``i < nv``."""
    g = row_features_geometry(m, aligned)
    keys = torch.arange(m, dtype=torch.int64)[None]
    tile, valid = pad_to_tile(keys, g, fill=-1)
    assert tile.shape == (1, 32 * g.warps_per_row, g.items_per_lane)
    assert sorted(tile[0][valid].tolist()) == list(range(m))
    assert bool((tile[0][~valid] == -1).all())
    nv = valid.sum(-1)
    slots = torch.arange(g.items_per_lane)[None, :]
    assert torch.equal(valid, slots < nv[:, None])
    if g.vector:
        assert bool((nv % 4 == 0).all())


# ---------------------------------------------------------------- K3 selection arithmetic


def _selection_rows(m, seed):
    """Rows that try the selections: continuous, heavy ties, all equal, +-0.0
    mixed, +-inf, near-ties one ulp apart, negative values."""
    rng = np.random.default_rng(seed)
    rows = [
        rng.uniform(0, 1, m),
        np.floor(rng.uniform(0, 1, m) * 4) / 4,
        np.full(m, 0.25),
        np.where(rng.uniform(0, 1, m) < 0.5, -0.0, 0.0),
        rng.normal(0, 1, m),
        np.nextafter(np.float32(0.5), np.float32(1.0)) * np.ones(m),
    ]
    C = np.stack(rows).astype(np.float32)
    C[5, ::2] = 0.5
    C[3, 0] = -1.0
    if m > 2:
        C[0, 1] = np.inf
        C[4, 2] = -np.inf
        C[3, m - 1] = 1.0
    return torch.from_numpy(C)


def _check_selections(C, aligned):
    m = C.shape[-1]
    g = row_features_geometry(m, aligned)
    keys = _to_key(C)
    med, t_key, c_lt, mad = selections_padded(C, g)
    want_med = _median_from_keys(keys, m)
    assert torch.equal(_bits(med), _bits(want_med))
    want_t = _kth_key(keys, min(10, m))
    assert torch.equal(t_key, want_t)
    assert torch.equal(c_lt, (keys < want_t[..., None]).sum(-1))
    want_mad = _median_from_keys(_to_key(torch.abs(C - want_med[..., None])), m)
    assert torch.equal(_bits(mad), _bits(want_mad))
    return torch.clamp_min(mad, 1e-9)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m", SELECT_M)
def test_joint_selection_over_padded_tile_equals_kth_key(m, aligned):
    """Two ranks in the same 32 steps, counted by carries over a tile padded
    with 0xFFFFFFFF, give the keys of ``_kth_key`` / ``_median_from_keys``;
    the MAD of the plain version follows bit for bit."""
    C = _selection_rows(m, seed=m)
    mad = _check_selections(C, aligned)
    plain = row_features_stats_plain(C, col_min_plain(C))
    assert torch.equal(_bits(mad), _bits(plain[..., 4]))


@pytest.mark.parametrize("m", [2049, 4100, 9000])
def test_joint_selection_when_warps_share_a_row(m):
    C = _selection_rows(m, seed=m)[:3]
    assert row_features_geometry(m, True).warps_per_row > 1
    _check_selections(C, aligned=True)


def test_selection_when_the_answer_is_the_padding_key():
    """A NaN with every mantissa bit set has the key 0xFFFFFFFF, the
    padding's.  The selections over the padded tile still equal those over
    the row alone: padding is never below a candidate, and the median's
    ``le`` count masks it by index."""
    C = torch.tensor([[0x7FFFFFFF] * 6, [0x7FFFFFFF, 0x3F000000] * 3],
                     dtype=torch.int32).view(torch.float32)
    keys = _to_key(C)
    assert int(keys[0, 0]) == 0xFFFFFFFF
    g = row_features_geometry(6, False)
    tile, valid = pad_to_tile(keys, g)
    assert int((tile == 0xFFFFFFFF).sum()) > 12 > int(valid.sum()) - 1
    _check_selections(C, aligned=False)


_POOL = [0.0, -0.0, 0.25, 0.5, -0.5, 1.0, 1.0000001, -1.0, 3.5, 1e-30, -1e-30,
         float("inf"), float("-inf")]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.one_of(st.sampled_from(_POOL),
                          st.floats(width=32, allow_nan=False, allow_infinity=True)),
                min_size=1, max_size=70),
       st.booleans())
def test_joint_selection_property(values, aligned):
    C = torch.tensor([values], dtype=torch.float32)
    _check_selections(C, aligned)


# ---------------------------------------------------------------- K4 geometry


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m", BOUNDARY_M)
def test_two_min_geometry_at_boundaries(m, aligned):
    n = 2048
    g = two_min_geometry(n, m, aligned)
    assert g.threads <= MAX_THREADS and g.threads == 32 * g.rows_per_block
    assert g.smem_bytes == 0 and g.warps_per_row == 1
    assert g.vector == (aligned and m % 4 == 0)
    assert g.blocks == -(-n // g.rows_per_block)
    fits_l2 = 4 * n * m <= L2_BYTES
    assert g.state == ("keys" if fits_l2 else "floats")
    assert g.unroll == (4 if 4 * n * m <= 4 * L2_BYTES else 1)


def test_two_min_geometry_every_m_gets_a_launch():
    for m in range(1, 65537):
        for aligned in (True, False):
            g = two_min_geometry(64, m, aligned)
            assert not g.vector or (aligned and m % 4 == 0)
            assert g.unroll in (1, 4) and g.state in ("keys", "floats")


def test_two_min_geometry_float64():
    """float64 takes the float state with 8-byte loads, its unroll by its
    own bytes; the key state cannot be forced on it."""
    g = two_min_geometry(2048, 2048, True, itemsize=8)
    assert (g.state, g.vector, g.unroll) == ("floats", False, 4)
    assert two_min_geometry(8192, 8192, True, itemsize=8).unroll == 1  # 512 MiB
    assert two_min_geometry(4096, 4096, True, itemsize=8).unroll == 4  # 128 MiB
    assert two_min_geometry(8, 8, True, itemsize=8, state="floats").state == "floats"
    with pytest.raises(ValueError, match="float64"):
        two_min_geometry(8, 8, True, itemsize=8, state="keys")
    with pytest.raises(ValueError):
        two_min_geometry(8, 8, True, itemsize=2)


def test_two_min_geometry_by_size_and_forced():
    assert two_min_geometry(2048, 2048, True).state == "keys"
    assert two_min_geometry(2048, 2048, True, batch=4).state == "floats"
    big = two_min_geometry(8192, 8192, True)
    assert (big.state, big.unroll) == ("floats", 1)
    mid = two_min_geometry(4096, 4096, True)
    assert (mid.state, mid.unroll) == ("floats", 4)
    forced = two_min_geometry(8192, 8192, True, state="keys", unroll=4)
    assert (forced.state, forced.unroll) == ("keys", 4)
    with pytest.raises(ValueError):
        two_min_geometry(8, 8, True, state="tile")
    with pytest.raises(ValueError):
        two_min_geometry(8, 8, True, unroll=2)
    with pytest.raises(ValueError):
        two_min_geometry(0, 8, True)


# ---------------------------------------------------------------- K4 key arithmetic


def test_order_key_orders_like_argmin():
    x = torch.tensor([float("nan"), float("-inf"), -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0,
                      float("inf")])
    k = order_key(x)
    assert int(k[0]) == 0  # NaN below everything
    assert int(k[4]) == int(k[5])  # -0.0 equals +0.0
    rest = k[[1, 2, 3, 4, 6, 7, 8]]
    assert bool((rest[1:] > rest[:-1]).all())
    assert int(k.max()) < 0xFFFFFFFF  # the kernel's initial key is never taken
    neg_nan = torch.tensor([-4194303], dtype=torch.int32).view(torch.float32)
    assert int(order_key(neg_nan)) == 0


def _assert_two_min_equal(got, want, zero_sign=True):
    assert torch.equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        keep = ~torch.isnan(w)
        if zero_sign:
            assert torch.equal(_bits(g[keep]), _bits(w[keep]))
        else:
            assert torch.equal(g[keep], w[keep])


@pytest.mark.parametrize("m", [1, 2, 7, 33, 1000])
def test_two_min_by_keys_equals_plain(m):
    """The integer-key state (order keys, two smallest (key, column) pairs,
    elements read again at the two columns) gives the plain version's
    (min1, min2, argmin) bit for bit: ties, +-inf and NaN rows included."""
    rng = np.random.default_rng(m)
    C = rng.uniform(0, 1, (9, m)).astype(np.float32)
    C[1] = np.floor(C[1] * 4) / 4
    C[2] = 0.5
    if m > 2:
        C[3, 1] = np.inf
        C[4, 2] = C[4, m - 1] = -np.inf
        C[5, m // 2] = np.nan
        C[6, 0] = C[6, m - 1] = np.nan
        C[7] = np.inf
    v = rng.normal(0, 0.3, m).astype(np.float32)
    C, v = torch.from_numpy(C), torch.from_numpy(v)
    _assert_two_min_equal(two_min_by_keys(C, v), two_min_plain(C, v))
    assert two_min(C, v)[2].dtype == torch.int32


def test_two_min_by_keys_signed_zeros_take_the_first_column():
    """-0.0 and +0.0 tie: the first column wins, min1 keeps that element's
    sign, min2 equals min1 in value."""
    C = torch.tensor([[1.0, 0.0, -0.0, 2.0], [3.0, -0.0, 0.0, -0.0]])
    v = torch.zeros(4)
    got, want = two_min_by_keys(C, v), two_min_plain(C, v)
    _assert_two_min_equal(got, want, zero_sign=False)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert got[2].tolist() == [1, 1]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.one_of(st.sampled_from([0.25, 0.5, 0.5, 1.0, float("inf"),
                                           float("-inf"), float("nan")]),
                          st.floats(min_value=-4, max_value=4, width=32)),
                min_size=1, max_size=40))
def test_two_min_by_keys_property(values):
    C = torch.tensor([values], dtype=torch.float32)
    v = torch.linspace(-0.5, 0.5, len(values))
    _assert_two_min_equal(two_min_by_keys(C, v), two_min_plain(C, v), zero_sign=False)


# ---------------------------------------------------------------- K1 / K2 geometry

COLMIN_FORCED = (
    {}, {"path": "two_launch"}, {"path": "cluster"}, {"path": "cluster", "ahead": 4},
    {"path": "cluster", "ahead": 8}, {"path": "cluster", "cluster": 1},
    {"path": "cluster", "cluster": 2, "ahead": 8}, {"path": "cluster", "cluster": 4},
    {"path": "cluster", "cluster": 8, "ahead": 4},
)


def _assert_col_min_geometry(g, n, m, batch, aligned):
    """Every row and every column is covered exactly once, the cluster
    divides the grid, and the launch is within the card's limits."""
    assert g.path in ("cluster", "two_launch")
    tiles = -(-m // g.tile)
    assert (tiles - 1) * g.tile < m <= tiles * g.tile
    # the blocks of a tile own consecutive row ranges that end at or past n
    assert g.row_blocks * g.rows_per_block >= n and g.rows_per_block >= 1
    assert g.smem_bytes <= H100_SHARED_BYTES_PER_BLOCK
    assert 32 * g.warps <= MAX_THREADS
    assert g.grid[0] < 2**31 and g.grid[1] <= 65535 and g.grid[2] <= 65535
    assert g.blocks == g.grid[0] * g.grid[1] * g.grid[2]
    if g.path == "cluster":
        assert g.tile == 128 and g.row_blocks == g.cluster
        assert g.cluster in (1, 2, 4, 8) and g.grid[0] % g.cluster == 0
        assert g.grid == (tiles * g.cluster, 1, batch)
        assert g.rows_per_block % g.warps == 0  # whole stripes: a row a warp a step
        assert g.vector == (aligned and m % 4 == 0)
        assert g.ahead in (4, 8) and g.warps == 8
        assert g.smem_bytes == (g.warps + 1) * g.tile * 4
    else:
        assert g.cluster == 1 and not g.vector and g.tile == 32 * g.warps
        assert g.grid == (tiles, g.row_blocks, batch)
        assert (g.row_blocks - 1) * g.rows_per_block < n  # no empty chunk
        assert g.smem_bytes == 0


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_col_min_geometry_every_m_covers_the_matrix(batch):
    for m in range(1, 65537):
        aligned = m % 2 == 0
        for n in (1, 2048) if m % 64 else (1, 37, 2048, 65536):
            _assert_col_min_geometry(col_min_geometry(n, m, aligned, batch), n, m, batch,
                                     aligned)


@pytest.mark.parametrize("batch", [1, 2, 8])
def test_col_min_geometry_every_n_covers_the_matrix(batch):
    for n in range(1, 65537):
        for m in (7, 2048) if n % 64 else (1, 7, 1001, 2048, 65536):
            _assert_col_min_geometry(col_min_geometry(n, m, True, batch), n, m, batch, True)


@pytest.mark.parametrize("force", COLMIN_FORCED[1:], ids=lambda f: "-".join(map(str, f.values())))
@pytest.mark.parametrize("n,m", [(1, 1), (37, 7), (1001, 2048), (16384, 7), (7, 16384),
                                 (2048, 2048), (65536, 65536)])
def test_col_min_geometry_forced_variants_cover_the_matrix(n, m, force):
    g = col_min_geometry(n, m, True, batch=2, **force)
    _assert_col_min_geometry(g, n, m, 2, True)
    for key, value in force.items():
        assert getattr(g, key) == value


def test_col_min_geometry_by_shape():
    """What the main path and its neighbours take: one launch, every cluster
    resident at once, two_launch only for a tall, narrow matrix."""
    main = col_min_geometry(2048, 2048, True)
    assert (main.path, main.cluster, main.warps, main.ahead) == ("cluster", 8, 8, 8)
    assert main.rows_per_block == 256 and main.blocks == 128 and main.vector
    assert col_min_geometry(4096, 4096, True).ahead == 4  # beyond L2
    for n in (256, 1024, 4096, 8192, 16384, 32768):
        g = col_min_geometry(n, n, True)
        assert g.path == "cluster" and g.blocks <= MAX_BLOCKS
    assert col_min_geometry(8192, 8192, True).cluster == 4
    assert col_min_geometry(2048, 2048, True, batch=8).cluster == 2
    assert col_min_geometry(7, 16384, True).cluster == 1  # nothing to split
    assert col_min_geometry(16384, 512, True).path == "cluster"  # 256 rows a warp
    for n, m in ((32768, 7), (32768, 1024), (65536, 64), (65536, 2048)):
        g = col_min_geometry(n, m, True)
        assert g.path == "two_launch" and g.blocks >= SMS
        c = col_min_geometry(n, m, True, path="cluster")
        assert c.rows_per_block // c.warps >= LONG_STRIPE and c.blocks <= SMS
    assert not col_min_geometry(2048, 2048, False).vector
    assert not col_min_geometry(2048, 2046, True).vector


def test_col_min_geometry_rejects_what_the_kernel_does_not_take():
    for bad in ({"path": "tile"}, {"cluster": 3}, {"cluster": 16}, {"ahead": 1},
                {"ahead": 2}, {"path": "two_launch", "ahead": 4},
                {"path": "two_launch", "cluster": 2}):
        with pytest.raises(ValueError):
            col_min_geometry(64, 64, True, **bad)
    with pytest.raises(ValueError):
        col_min_geometry(0, 8, True)
    with pytest.raises(ValueError):
        col_min_geometry(8, 8, True, batch=0)


# ---------------------------------------------------------------- K1 / K2 merge tree


def _assert_col_min_equal(got, want, X):
    """Same NaN pattern, bit-equal elsewhere, except that a zero minimum of a
    column holding both -0.0 and +0.0 need only compare equal: which sign
    wins is the merge order's."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    zero, neg = X == 0, torch.signbit(X)
    mixed = (zero & neg).any(-2) & (zero & ~neg).any(-2) & (want == 0)
    exact = ~torch.isnan(want) & ~mixed
    assert torch.equal(_bits(got[exact]), _bits(want[exact]))
    assert bool((got[mixed] == 0).all())


def _check_by_tiles(C, u, force, batch=None):
    n, m = C.shape[-2:]
    g = col_min_geometry(n, m, False, batch=C.shape[0] if C.ndim == 3 else 1, **force)
    _assert_col_min_equal(col_min_by_tiles(C, None, g), col_min_plain(C), C)
    _assert_col_min_equal(col_min_by_tiles(C, u, g), min_trick_plain(C, u),
                          C - u[..., :, None])


def _colmin_special(n, m, seed):
    """A (2, n, m) batch and its u with a NaN column, an all +inf column, a
    -inf, an all-equal column, and columns whose minimum is a zero of both
    signs (in C for K1, through C == u for K2), in either order of the
    signs; indices wrap."""
    rng = np.random.default_rng(seed)
    C = torch.from_numpy(rng.uniform(0, 1, (2, n, m)).astype(np.float32))
    C[1] = torch.floor(C[1] * 4) / 4
    u = torch.from_numpy(rng.normal(0, 0.3, (2, n)).astype(np.float32))
    C[0, n // 2, 0] = float("nan")
    C[0, :, 1 % m] = float("inf")
    C[1, n - 1, 2 % m] = float("-inf")
    C[1, :, 3 % m] = 0.25
    j1, j2 = 5 % m, 6 % m
    C[..., j1] = 1.0
    for b in range(2):
        plus, minus = (0, n - 1) if b == 0 else (n - 1, 0)
        u[b, minus] = 0.0
        C[b, :, j2] = u[b] + 1.0
        C[b, plus, j2] = u[b, plus]
        C[b, minus, j2] = -0.0
        C[b, plus, j1], C[b, minus, j1] = 0.0, -0.0
    return C, u


@pytest.mark.parametrize("force", COLMIN_FORCED, ids=lambda f: "-".join(map(str, f.values())) or "picked")
@pytest.mark.parametrize("n,m", [(1, 1), (1, 130), (37, 7), (37, 33), (50, 129), (129, 300),
                                 (300, 1)])
def test_col_min_by_tiles_equals_plain(n, m, force):
    """The kernel's merge tree (stripes, warps, cluster ranks; chunks on the
    two_launch path) gives the plain versions' minima on ragged shapes, with
    blocks of a cluster short or empty, NaN and +-inf columns, and mixed
    zeros under the stated rule."""
    C, u = _colmin_special(n, m, seed=n * m)
    _check_by_tiles(C, u, force)


def test_col_min_by_tiles_nan_in_u_makes_every_column_nan():
    C, u = _colmin_special(40, 130, seed=3)
    u[0, 13] = float("nan")
    for force in COLMIN_FORCED:
        g = col_min_geometry(40, 130, False, batch=2, **force)
        got = col_min_by_tiles(C, u, g)
        assert bool(torch.isnan(got[0]).all())
        _assert_col_min_equal(got, min_trick_plain(C, u), C - u[..., :, None])


def test_col_min_by_tiles_keeps_the_first_zero_of_its_own_order():
    """Rows 1 and 8 of a (16, 1) column hold +0.0 and -0.0.  With two blocks
    of eight rows, row 1 is warp 1's of rank 0 and row 8 is warp 0's of rank
    1: ranks merge before warps of another block count, so rank 0's +0.0
    stays.  Swapped, the -0.0 stays.  Either equals the plain minimum."""
    g = col_min_geometry(16, 1, False, path="cluster", cluster=2)
    assert g.rows_per_block == 8 and g.warps == 8
    C = torch.ones(16, 1)
    C[1, 0], C[8, 0] = 0.0, -0.0
    got = col_min_by_tiles(C, None, g)
    assert got.item() == 0.0 and not bool(torch.signbit(got).item())
    C[1, 0], C[8, 0] = -0.0, 0.0
    got = col_min_by_tiles(C, None, g)
    assert got.item() == 0.0 and bool(torch.signbit(got).item())
    assert col_min_plain(C).item() == 0.0


_COLMIN_POOL = [0.0, -0.0, 0.0, -0.0, 0.25, 0.5, 1.0, float("inf"), float("-inf"),
                float("nan")]


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 40), st.integers(1, 9),
       st.lists(st.one_of(st.sampled_from(_COLMIN_POOL),
                          st.floats(min_value=-4, max_value=4, width=32)),
                min_size=1, max_size=360),
       st.sampled_from(COLMIN_FORCED), st.booleans())
def test_col_min_by_tiles_property(n, m, values, force, zero_u):
    """Any values, NaN, +-inf and +-0.0 among them, any ragged shape, any
    geometry: the merge tree equals the plain versions under the rule."""
    C = torch.tensor((values * (n * m // len(values) + 1))[:n * m],
                     dtype=torch.float32).reshape(n, m)
    # u from the matrix itself, so that C - u has exact zeros of both signs
    u = torch.zeros(n) if zero_u else C[:, 0].clone()
    u[torch.isinf(u)] = 0.5
    _check_by_tiles(C, u, force)


# ---------------------------------------------------------------- on the card

RAGGED = [(37, 1), (37, 7), (37, 10), (37, 11), (37, 33), (50, 1001), (40, 16384),
          (12, 20000)]
K3_EXACT_CHANNELS = (0, 1, 4, 6, 11, 12)


def _ragged_batch(rows, m, device):
    rng = np.random.default_rng(rows * m)
    C = rng.uniform(0, 1, (2, rows, m)).astype(np.float32)
    C[1] = np.floor(C[1] * 8) / 8
    v = rng.normal(0, 0.3, (2, m)).astype(np.float32)
    return torch.from_numpy(C).to(device), torch.from_numpy(v).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,m", RAGGED)
def test_k3_k4_match_plain_versions_at_ragged_shapes_on_card(cuda, rows, m):
    C, v = _ragged_batch(rows, m, cuda)
    got = row_features_stats(C)
    want = row_features_stats_plain(C, col_min_plain(C))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=K3_RTOL, atol=K3_ATOL)
    for ch in K3_EXACT_CHANNELS:
        assert torch.equal(_bits(got[..., ch]), _bits(want[..., ch]))
    _assert_two_min_equal(two_min(C, v), two_min_plain(C, v))


COLMIN_ON_CARD = RAGGED + [(7, 16384), (16384, 7), (1, 5000), (3000, 1), (1001, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,m", COLMIN_ON_CARD)
def test_k1_k2_match_plain_versions_at_ragged_shapes_on_card(cuda, rows, m):
    """Every geometry of the kernel against the plain versions, on the drawn
    batch and on the special columns."""
    drawn, _ = _ragged_batch(rows, m, "cpu")
    u = torch.from_numpy(np.random.default_rng(rows + m).normal(0, 0.3, (2, rows))
                         .astype(np.float32))
    for C, uu in ((drawn, u), _colmin_special(rows, m, seed=rows + m)):
        C, uu = C.to(cuda), uu.to(cuda)
        for force in COLMIN_FORCED:
            _assert_col_min_equal(col_min_kernel(C, **force), col_min_plain(C), C)
            _assert_col_min_equal(col_min_kernel(C, uu, **force), min_trick_plain(C, uu),
                                  C - uu[..., :, None])
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_k1_k2_take_an_unaligned_view_on_card(cuda):
    C, _ = _colmin_special(64, 1000, seed=5)
    C, u = C.to(cuda), torch.zeros(2, 64, device=cuda)
    buf = torch.empty(C.numel() + 1, dtype=torch.float32, device=cuda)
    Cu = buf[1:].view(C.shape).copy_(C)
    assert Cu.data_ptr() % 16 != 0
    for force in COLMIN_FORCED:
        _assert_col_min_equal(col_min_kernel(Cu, **force), col_min_plain(Cu), Cu)
        _assert_col_min_equal(col_min_kernel(Cu, u, **force), min_trick_plain(Cu, u),
                              Cu - u[..., :, None])


@pytest.mark.cuda
def test_k3_k4_take_an_unaligned_view_on_card(cuda):
    C, v = _ragged_batch(64, 1000, cuda)
    buf = torch.empty(C.numel() + 1, dtype=torch.float32, device=cuda)
    Cu = buf[1:].view(C.shape).copy_(C)
    vbuf = torch.empty(v.numel() + 1, dtype=torch.float32, device=cuda)
    vu = vbuf[1:].view(v.shape).copy_(v)
    assert Cu.data_ptr() % 16 != 0 and vu.data_ptr() % 16 != 0
    torch.testing.assert_close(
        row_features_stats(Cu), row_features_stats_plain(Cu, col_min_plain(Cu)),
        rtol=K3_RTOL, atol=K3_ATOL)
    _assert_two_min_equal(two_min(Cu, vu), two_min_plain(Cu, vu))


@pytest.mark.cuda
def test_two_min_float64_launches_the_kernel_on_card(cuda):
    """The router's dtype rule on the card: float64 and float32 each launch
    the kernel and equal the plain version bit for bit (NaN and inf rows,
    both unrolls of the float64 form included); any other dtype reaches the
    kernel, which raises."""
    rng = np.random.default_rng(1)
    C = torch.from_numpy(rng.random((2, 300, 300))).to(cuda)
    C[0, 3, 7] = float("nan")
    C[1, 5] = float("inf")
    C[1, 6, :4] = -float("inf")
    v = torch.from_numpy(rng.random((2, 300))).to(cuda)
    before = two_min.launches
    _assert_two_min_equal(two_min(C, v), two_min_plain(C, v))
    assert two_min.launches == before + 1
    for unroll in (1, 4):
        _assert_two_min_equal(two_min_kernel(C, v, unroll=unroll), two_min_plain(C, v))
    _assert_two_min_equal(two_min(C.float(), v.float()), two_min_plain(C.float(), v.float()))
    assert two_min.launches == before + 4
    with pytest.raises(TypeError, match="float64"):
        two_min(C.half(), v.half())
    with pytest.raises(TypeError, match="float64"):
        two_min(C, v.float())
