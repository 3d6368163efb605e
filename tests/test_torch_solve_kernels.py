"""The device solver's persistent kernels S1-S3 (``ops.cuda.augment``,
``ops.cuda.arr``, ``ops.cuda.greedy_match``) and their routers.

On the CPU: plain transcriptions of the kernels' own arithmetic (the
column minimum by tiles, staged and resident, the sweep's stop test from
order-preserving keys, the flips in the kernel's array order, the ARR auction's 64-bit keys, the greedy
proposals' 64-bit words) against the plain versions; the cooperative launch
geometry and S1's layouts as a function of n, the type, the SM count and
the occupancy; the routing (a
tensor off the CPU with a whole partition goes to the kernel wrappers, a row
block of several ranks keeps the eager loops); ``SolveStats``' device
counts; and the fallback gate as a select, against the JAX solver.

The module imports no JAX (the JAX reference is imported inside a fixture
and skips where JAX is missing), so its ``cuda`` cases run on the card:
``python3 -m pytest tests/test_torch_solve_kernels.py -m cuda``.  There S1 (in
each of its layouts), S2 and S3 are held against their plain loops on the
same card, and the
whole seeded solve against the CPU: assignments, v bit for bit (NaN as one
class) and every loop count.
"""

import importlib

import numpy as np
import pytest
import torch

from lapgnn_tpu_torch import tracing
from lapgnn_tpu_torch.data.generators import FAMILIES
from lapgnn_tpu_torch.ops.cuda import arr, augment
from lapgnn_tpu_torch.ops.cuda._lib import coop_blocks
from lapgnn_tpu_torch.ops.partition import WHOLE, RowPartition
from lapgnn_tpu_torch.solver import jv as tjv
from lapgnn_tpu_torch.solver import seeded as tseeded

# the module (the package's name of the same spelling is its wrapper)
gm = importlib.import_module("lapgnn_tpu_torch.ops.cuda.greedy_match")

INF, NAN = float("inf"), float("nan")


def _cost(fam, n, seed):
    return FAMILIES[fam](n, np.random.default_rng(seed)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _same(a, b):
    """Equal tensors, float bits included, every NaN one class."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    bits = torch.int64 if a.dtype == torch.float64 else torch.int32
    return torch.equal(a[~nan].view(bits), b[~nan].view(bits))


# ------------------------------------------------- S1: the column minimum


def _special_columns(seed, n=40, m=24, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    val = torch.from_numpy(rng.integers(0, 4, (n, m)).astype(np.float64)).to(dtype)
    val[:, 0] = 0.0
    val[5, 0] = -0.0  # equal to +0.0: the first row wins, with its sign
    val[:, 1] = INF
    val[:, 2] = torch.where(torch.arange(n) % 3 == 0, -INF, INF)
    val[7, 3], val[30, 3] = NAN, NAN  # the first NaN wins
    val[:, 4] = NAN
    val[[3, 9], 5] = -5.0  # a tie below the rest
    return val


@pytest.mark.parametrize("tile", augment.TILES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_column_min_by_tiles_equals_torch_min(tile, dtype):
    for seed in range(3):
        val = _special_columns(seed, dtype=dtype)
        got_v, got_i = augment.column_min_by_tiles(val, tile)
        want_v, want_i = torch.min(val, dim=0)
        assert torch.equal(got_i, want_i)
        assert _same(got_v, want_v)
        assert torch.signbit(got_v[0]) == torch.signbit(want_v[0])


def test_column_min_by_tiles_fewer_rows_than_row_groups():
    val = torch.tensor([[3.0, NAN, 1.0], [2.0, 0.0, 1.0]])
    got_v, got_i = augment.column_min_by_tiles(val, 8)
    want_v, want_i = torch.min(val, dim=0)
    assert torch.equal(got_i, want_i) and _same(got_v, want_v)


def test_column_min_by_resident_tiles_fewer_rows_than_row_groups():
    val = torch.tensor([[3.0, NAN, 1.0], [2.0, 0.0, 1.0]])
    got_v, got_i = augment.column_min_by_tiles(val, 8, resident=True)
    want_v, want_i = torch.min(val, dim=0)
    assert _same(got_v, want_v)
    # the resident sweep never reads the row of a NaN minimum
    assert torch.equal(got_i[[0, 2]], want_i[[0, 2]])


@pytest.mark.parametrize("tile", [8, 11, 16, 19, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_column_min_by_resident_tiles_equals_torch_min(tile, dtype):
    """The resident layout's sweep (min(256 / w, n) row groups, any width
    w, a strict compare in each, NaN columns by the round's flag): the
    values of torch.min, and its rows wherever the minimum is neither NaN
    nor +inf (those never improve d, so their rows are never read)."""
    for seed in range(3):
        for n in (40, 31):  # 31 < 256 / 8: as many row groups as rows
            val = _special_columns(seed, n=n, dtype=dtype)
            got_v, got_i = augment.column_min_by_tiles(val, tile, resident=True)
            want_v, want_i = torch.min(val, dim=0)
            assert _same(got_v, want_v)
            used = ~torch.isnan(want_v) & (want_v != INF)
            assert torch.equal(got_i[used], want_i[used])
            assert torch.signbit(got_v[0]) == torch.signbit(want_v[0])


# ------------------------------------------------- S1: the sweep's stop test


@pytest.mark.parametrize("blocks,tile", [(1, 8), (3, 8), (7, 16), (64, 32), (6, 16), (9, 11)])
def test_sweep_stop_by_keys_equals_the_plain_test(blocks, tile):
    rng = np.random.default_rng(blocks * 100 + tile)
    n = 96
    tol = 8.0 * torch.finfo(torch.float32).eps
    for trial in range(40):
        d = torch.from_numpy(rng.integers(0, 6, n).astype(np.float32) * 0.25)
        d[rng.random(n) < 0.1] = INF
        if trial % 7 == 0:
            d[rng.integers(n)] = NAN
        improve = torch.from_numpy(rng.random(n) < 0.2) & ~torch.isnan(d) & torch.isfinite(d)
        free_col = torch.from_numpy(rng.random(n) < 0.3)
        if trial % 5 == 0:
            improve[:] = False
        if trial % 9 == 0:
            free_col[:] = False
        dmin_free = torch.where(free_col, d, INF).amin()
        thresh = dmin_free + tol * (1.0 + dmin_free.abs())
        want = bool((improve & (d <= thresh)).any())
        got, got_min = augment.sweep_stop_by_keys(d, improve, free_col, blocks, tile)
        assert got == want, trial
        assert _same(got_min, dmin_free)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stop_keys_order_like_the_floats(dtype):
    """The stop test's keys sort as the distances do, NaN first (key 0, one
    class), and decode to the same bits."""
    d = torch.tensor([NAN, -INF, -3.5, -1e-30, 0.0, 1e-30, 2.0, 2.0, 3.5, 1e30, INF], dtype=dtype)
    k = augment.stop_keys(d)
    assert k[0] == 0 and all(a < b for a, b in zip(k[1:6], k[2:7]))
    assert k[6] == k[7] and k[7] < k[8] < k[9] < k[10] == augment._INF_KEY
    assert augment.stop_keys(torch.tensor([-NAN, NAN], dtype=dtype)) == [0, 0]
    for key, want in zip(k, d):
        assert _same(augment._stop_value(key, dtype), want)


def _round_state(C, n_free, seed):
    """One round's inputs of the sweeps (as _augment_all_sweep_eager forms
    them) from a matching with n_free free rows and columns."""
    rng = np.random.default_rng(seed)
    Ct = _t(C)
    n = C.shape[0]
    x = torch.from_numpy(rng.permutation(n)).to(torch.int64)
    y = torch.empty(n, dtype=torch.int64)
    y[x] = torch.arange(n)
    free = torch.from_numpy(rng.permutation(n)[:n_free])
    y[x[free]] = -1
    x[free] = -1
    v = torch.from_numpy(rng.normal(0, 0.05, n).astype(C.dtype))
    free_row, free_col = x < 0, y < 0
    slack = Ct - v[None, :]
    x_safe = torch.where(x >= 0, x, 0)
    u = torch.where(free_row, slack.amin(1), slack.gather(1, x_safe[:, None])[:, 0])
    red = slack - u[:, None]
    red = torch.where(red <= 0, 0.0, red)
    d0, pred0 = torch.min(torch.where(free_row[:, None], red, INF), dim=0)
    return red, free_row, x_safe, d0, pred0, free_col


def _chain_state(n):
    """A round whose shortest paths run through every row: row 0 free, row
    i >= 1 holds column i - 1 and reaches column i at 0.5; every other entry
    of red is 100 (ties among them), column n - 1 free and far (a sweep a
    hop before the stop test can end)."""
    red = torch.full((n, n), 100.0)
    red[0, 0] = 0.0
    idx = torch.arange(1, n)
    red[idx, idx] = 0.5
    x_safe = torch.cat([torch.zeros(1, dtype=torch.int64), idx - 1])
    free_row = torch.zeros(n, dtype=torch.bool)
    free_row[0] = True
    free_col = torch.zeros(n, dtype=torch.bool)
    free_col[n - 1] = True
    d0, pred0 = torch.min(torch.where(free_row[:, None], red, INF), dim=0)
    return red, free_row, x_safe, d0, pred0, free_col


@pytest.mark.parametrize("converge", [False, True])
@pytest.mark.parametrize("case", ["uniform", "tie", "sparse", "nan_free_row", "nan_matched_row",
                                  "nan_entry", "inf_row", "one_free", "chain"])
def test_sweeps_by_frontier_equal_the_plain_sweeps(case, converge):
    """The resident layout's sweeps over the changed rows only (with the
    NaN flags of red and e) give the plain loop's d, pred and sweep count
    bit for bit; ``converge`` marks no column free, so the sweeps run until
    nothing improves; "chain" needs a sweep a hop of a path through every
    row."""
    n = 48
    fam = case if case in ("uniform", "tie", "sparse") else "uniform"
    C = _cost(fam, n, 7 + len(case))
    state = _round_state(C, 1 if case == "one_free" else 6, len(case))
    red, free_row = state[0].clone(), state[1]
    if case == "nan_free_row":
        red[int(torch.nonzero(free_row)[0])] = NAN
    elif case == "nan_matched_row":
        red[int(torch.nonzero(~free_row)[0])] = NAN
    elif case == "nan_entry":
        red[int(torch.nonzero(~free_row)[3]), 5] = NAN
    elif case == "inf_row":
        red[int(torch.nonzero(~free_row)[1])] = INF
    if case.startswith("nan"):  # d0 as the round forms it
        d0, pred0 = torch.min(torch.where(free_row[:, None], red, INF), dim=0)
        state = (red, free_row, state[2], d0, pred0, state[5])
    else:
        state = (red, *state[1:])
    if case == "chain":
        state = _chain_state(n)
    if converge:
        state = (*state[:5], torch.zeros_like(state[5]))
    stats = tjv.SolveStats()
    want_d, want_p = tjv._sweep_shortest_paths(*state[:5], n, state[5], stats)
    if case == "chain":
        assert stats.sweeps >= (n if converge else 8)
    got_d, got_p, sweeps = augment.sweeps_by_frontier(*state, n)
    assert _same(got_d, want_d) and torch.equal(got_p, want_p)
    assert sweeps == stats.sweeps


# ------------------------------------------------- S1: the flips


def _chain_case():
    """Rows 1..80 hold columns 0..79 (row r holds column r - 1), row 0 is
    free, and both candidate sinks lead down the chain: 81 hops each
    (tests/test_torch_solver.py's case)."""
    n = 96
    x = np.full(n, -1, np.int64)
    y = np.full(n, -1, np.int64)
    pred = np.zeros(n, np.int64)
    for r in range(1, 81):
        x[r], y[r - 1] = r - 1, r
    pred[:80] = np.arange(80)
    pred[[85, 90]] = 80
    cand = np.zeros(n, bool)
    cand[[85, 90]] = True
    return x, y, pred, cand


def _random_flip_case(seed, n=70):
    """A partial matching, predecessors through matched rows or free rows,
    and candidate free columns, some paths sharing rows."""
    rng = np.random.default_rng(seed)
    x = np.full(n, -1, np.int64)
    y = np.full(n, -1, np.int64)
    matched = rng.permutation(n)[: n - 8]
    cols = rng.permutation(n)[: n - 8]
    x[matched], y[cols] = cols, matched
    pred = rng.integers(0, n, n)
    cand = (y < 0) & (rng.random(n) < 0.8)
    return x, y, pred, cand


@pytest.mark.parametrize("case", ["chain", *[f"random{k}" for k in range(6)]])
def test_flip_paths_by_arrays_equals_the_host_flip(case):
    x, y, pred, cand = _chain_case() if case == "chain" else _random_flip_case(int(case[6:]))
    xs, ys = x.tolist(), y.tolist()
    want_steps = tjv._flip_disjoint_paths_host(xs, ys, pred.tolist(), cand.tolist())
    xa, ya = x.copy(), y.copy()
    got_steps = augment.flip_paths_by_arrays(xa, ya, pred, cand)
    assert got_steps == want_steps
    assert xa.tolist() == xs and ya.tolist() == ys
    if case == "chain":  # both capped: the first sink's path flipped uncapped
        assert got_steps == 64 + 64 + 81 and xa[0] == 0 and ya[85] == 80


def test_flip_paths_by_arrays_past_a_ballot():
    """Candidates in several 32-column chunks come lowest first."""
    n = 100
    x = np.full(n, -1, np.int64)
    y = np.full(n, -1, np.int64)
    pred = np.arange(n)[::-1].copy()
    cand = np.zeros(n, bool)
    cand[[3, 40, 77, 99]] = True
    xs, ys = x.tolist(), y.tolist()
    want = tjv._flip_disjoint_paths_host(xs, ys, pred.tolist(), cand.tolist())
    assert augment.flip_paths_by_arrays(x, y, pred, cand) == want
    assert x.tolist() == xs and y.tolist() == ys


# ------------------------------------------------- S2: the auction's keys


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_best_bid_by_keys_equals_best_bid(dtype):
    rng = np.random.default_rng(5)
    n = 64
    for trial in range(30):
        gaps = torch.from_numpy(rng.integers(-2, 5, n).astype(np.float64) * 0.5).to(dtype)
        gaps[rng.random(n) < 0.1] = INF
        if trial % 4 == 0:
            gaps[rng.integers(n)] = -0.0
        cols = torch.from_numpy(rng.integers(0, n // 4, n)).to(torch.int64)
        cols[rng.random(n) < 0.3] = n  # no bid
        rows = torch.arange(n, dtype=torch.int64)
        want_best, want_row = RowPartition().best_bid(cols, gaps, rows, n)
        got_best, got_row = arr.best_bid_by_keys(cols, gaps, rows, n)
        assert torch.equal(got_row, want_row), trial
        assert torch.equal(got_best == want_best, torch.ones(n + 1, dtype=torch.bool)), trial


def test_gap_keys_order_like_the_gaps():
    g = torch.tensor([-INF, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, 3.5, INF], dtype=torch.float64)
    k = arr.gap_keys(g)
    assert (np.diff(k.astype(object)) >= 0).all()
    assert k[3] == k[4] and (k > 0).all()


def _bids_case(kind, seed, n=64):
    """Bids (cols, gaps, rows) over n columns: random; all tied at one gap;
    -0.0 against +0.0; one bidder."""
    rng = np.random.default_rng(seed)
    rows = torch.arange(n, dtype=torch.int64)
    cols = torch.from_numpy(rng.integers(0, n // 4, n)).to(torch.int64)
    cols[rng.random(n) < 0.3] = n  # no bid
    gaps = torch.from_numpy(rng.integers(0, 5, n).astype(np.float32) * 0.5)
    gaps[rng.random(n) < 0.1] = INF
    if kind == "ties":
        gaps[:] = 1.5
    elif kind == "zeros":
        gaps[:] = torch.where(torch.arange(n) % 2 == 0, -0.0, 0.0)
    elif kind == "one":
        cols[:] = n
        cols[37] = 5
    return cols, gaps, rows


@pytest.mark.parametrize("kind", ["random", "ties", "zeros", "one"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_winner_words_equal_best_bid(kind, seed):
    """The float32 kernel's one atomicMax of (gap key, inverted row) words
    gives RowPartition.best_bid's winner (largest gap, lowest row on a tie)
    and gap, and best_bid_by_keys' (the float64 kernel's two steps)."""
    n = 64
    cols, gaps, rows = _bids_case(kind, seed, n)
    want_best, want_row = RowPartition().best_bid(cols, gaps, rows, n)
    got_best, got_row = arr.winner_words(cols, gaps, rows, n)
    keys_best, keys_row = arr.best_bid_by_keys(cols, gaps, rows, n)
    assert torch.equal(got_row, want_row) and torch.equal(keys_row, want_row)
    assert torch.equal(got_best == want_best, torch.ones(n + 1, dtype=torch.bool))
    assert torch.equal(got_best == keys_best, torch.ones(n + 1, dtype=torch.bool))


def test_gap_keys32_order_like_the_gaps():
    g = torch.tensor([-INF, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, 3.5, INF])
    k = arr._gap_keys32(g)
    assert (np.diff(k.astype(np.int64)) >= 0).all() and (k < 2**32).all()
    assert k[3] == k[4] and (k > 0).all()
    back = arr._key_gaps32(k)
    assert np.array_equal(back[[0, 1, 2, 5, 6, 7, 8]], g.numpy()[[0, 1, 2, 5, 6, 7, 8]])
    assert back[3] == 0.0 and not np.signbit(back[3])


_ROUND_CASES = [(fam, dt, "plain", r) for fam in ("uniform", "noisy_linear", "sparse", "tie")
                for dt in (np.float32, np.float64) for r in (3, 64)]
_ROUND_CASES += [("uniform", dt, kind, r) for kind in ("nan_row", "inf_row")
                 for dt in (np.float32, np.float64) for r in (3, 64)]


@pytest.mark.parametrize("fam,dtype,kind,rounds", _ROUND_CASES)
def test_arr_rounds_by_ranks_equal_the_eager_loop(fam, dtype, kind, rounds):
    """S2's round structure (block-local state, the bids spread over the
    blocks, three slot buffers with round r's cleared in round r + 2, each
    bid stored by its rank and the winning ones applied after the barrier,
    no bid as the stop test) against the eager loop: x, y, v bit for bit
    and the rounds, with max_rounds reached (3) and not (64)."""
    n = 96 if fam == "tie" else 160
    C = _poisoned(_cost(fam, n, 40 + n), kind).astype(dtype)
    Ct = _t(C)
    tight, m, _ = _states(C, max_rounds=0)
    for blocks in (1, 5):
        x, y, v, got_rounds = arr.arr_rounds_by_ranks(Ct, *m, rounds, 0.0, blocks)
        counts = torch.zeros(1, dtype=torch.int64)
        want = arr.arr_auction_plain(Ct, *m, rounds, 0.0, counts)
        assert all(_same(a, b) for a, b in zip((x, y, v), want)), blocks
        assert got_rounds == int(counts[0])


# ------------------------------------------------- S3: the proposals


@pytest.mark.parametrize("rnd", [0, 1, 2, 9])
def test_proposals_by_keys_equal_the_plain_argmin(rnd):
    rng = np.random.default_rng(rnd)
    n = 64
    avail = torch.from_numpy(rng.random((n, n)) < 0.1)
    avail[3] = False
    avail[4] = True
    score = (torch.arange(n, dtype=torch.int32)[None, :].expand(n, n) if rnd == 0
             else tseeded._hash_scores(n, rnd))
    want = torch.where(avail, score, tseeded._INT32_MAX).argmin(1)
    want = torch.where(avail.any(1), want, -1)
    assert torch.equal(gm.proposals_by_keys(avail, rnd), want)


def test_nonzero4_folds_bytes_into_bits():
    rng = np.random.default_rng(0)
    for _ in range(200):
        b = rng.integers(0, 256, 4) * (rng.random(4) < 0.5)
        u = int.from_bytes(bytes(b.astype(np.uint8)), "little")
        want = sum(1 << k for k in range(4) if b[k])
        assert gm._nonzero4(u) == want


@pytest.mark.parametrize("fam,kind", [("uniform", "plain"), ("noisy_linear", "plain"),
                                      ("sparse", "plain"), ("tie", "plain"),
                                      ("uniform", "nan_row"), ("sparse", "inf_row")])
@pytest.mark.parametrize("addr", [0, 7])
def test_greedy_rounds_by_words_equal_the_plain_loop(fam, kind, addr):
    """S3's proposals over 16-byte words (an unaligned head and a tail a byte
    at a time) against the free columns' bits, each stored by its rank, and
    its deferred apply of the winning ones, against the eager loop: x, y and
    the rounds."""
    n = 90 if fam == "tie" else 131
    C = _poisoned(_cost(fam, n, 50 + n), kind)
    tight, _, _ = _states(C, max_rounds=0)
    for blocks in (1, 4):
        x, y, rounds = gm.greedy_rounds_by_words(tight, blocks, addr)
        counts = torch.zeros(1, dtype=torch.int64)
        want = gm.greedy_match_plain(tight, counts)
        assert torch.equal(x, want[0]) and torch.equal(y, want[1]) and rounds == int(counts[0])


# ------------------------------------------------- launch geometry


def test_coop_blocks_by_sm_count_and_occupancy():
    assert coop_blocks(8, 132, 10**6) == 264  # two a SM at most
    assert coop_blocks(1, 132, 10**6) == 132
    assert coop_blocks(3, 114, 10**6) == 228
    assert coop_blocks(8, 132, 64) == 64  # no more than there is work for
    assert coop_blocks(8, 132, 0) == 1
    for bad in (0, -2):  # the card holds none, or a CUDA error
        with pytest.raises(RuntimeError):
            coop_blocks(bad, 132, 100)


@pytest.mark.parametrize("n,itemsize,sms,occ,blocks,tile", [
    (2048, 4, 132, 8, 132, 8),    # in L2: one block a SM; 128 tiles of 16 < 132
    (2048, 4, 114, 8, 114, 16),
    (2048, 8, 132, 8, 132, 8),    # 33.5 MB, still in L2
    (8192, 4, 132, 2, 264, 16),   # beyond L2: two a SM; 256 tiles of 32 < 264
    (8192, 4, 66, 2, 132, 32),
    (8192, 4, 132, 1, 132, 32),   # the card holds one a SM
    (512, 4, 132, 4, 64, 8),      # 64 tiles of 8
    (7, 8, 132, 4, 1, 32),
    (16384, 4, 132, 1, 132, 32),
    (11622, 8, 132, 2, 264, 32),
])
@pytest.mark.parametrize("staged", [True, False])
def test_augment_geometry(n, itemsize, sms, occ, blocks, tile, staged):
    g = augment.augment_geometry(n, itemsize, sms, occ, "staged" if staged else "unstaged")
    assert (g.blocks, g.tile, g.threads) == (blocks, tile, 256)
    assert g.smem_bytes == ((2 * itemsize + 4) * n if staged else 0)
    assert -(-n // g.tile) >= g.blocks  # every block owns a tile


def test_augment_geometry_limits():
    """The rows' vectors are staged while they fit in a block's shared
    memory (12 B a column in float32, 20 B in float64); above, the unstaged
    layout takes every n, and only it."""
    assert augment.augment_staged(19_370, 4) and not augment.augment_staged(19_371, 4)
    assert augment.augment_staged(11_622, 8) and not augment.augment_staged(11_623, 8)
    augment.augment_geometry(19_370, 4, 132, 1, "staged")
    with pytest.raises(ValueError):
        augment.augment_geometry(19_371, 4, 132, 1, "staged")
    with pytest.raises(ValueError):
        augment.augment_geometry(11_623, 8, 132, 1, "staged")
    for n, itemsize in ((19_371, 4), (11_623, 8), (12_288, 8), (65_536, 4)):
        g = augment.augment_geometry(n, itemsize, 132, 2, "unstaged")
        assert (g.blocks, g.tile, g.smem_bytes) == (264, 32, 0)
    with pytest.raises(RuntimeError):
        augment.augment_geometry(2048, 4, 132, 0, "staged")


@pytest.mark.parametrize("n,itemsize,sms,blocks,tile,fits", [
    (2048, 4, 132, 128, 16, True),    # 128 tiles of 16: 128 KB a block
    (2047, 4, 132, 128, 16, True),    # the last tile 15 wide
    (2508, 4, 132, 132, 19, True),    # float32's limit on 132 SMs
    (2509, 4, 132, 126, 20, False),
    (1729, 8, 132, 124, 14, True),    # float64's limit
    (1730, 8, 132, 124, 14, False),
    (1024, 8, 132, 128, 8, True),
    (2048, 8, 132, 128, 16, False),
    (512, 4, 132, 64, 8, True),       # tiles of 8 at least
    (130, 4, 132, 17, 8, True),       # the last tile 2 wide
    (131, 8, 132, 17, 8, True),       # the last tile 3 wide
    (33, 4, 132, 5, 8, True),
    (7, 4, 132, 1, 8, True),          # fewer columns than SMs: one block
    (2387, 4, 114, 114, 21, True),    # a card of 114 SMs
    (2388, 4, 114, 114, 21, False),
    (8192, 4, 132, 131, 63, False),   # wider than 32
])
def test_augment_resident_geometry(n, itemsize, sms, blocks, tile, fits):
    """The resident layout: one tile a block, max(8, ceil(n / SMs)) columns
    of any count, where the tile, d, e and x fit beside the static shared
    memory; a resident launch that does not fit, or a grid the card cannot
    hold, raises."""
    assert augment.resident_tile(n, sms) == tile and -(-n // tile) == blocks
    assert augment.augment_resident(n, itemsize, sms) == fits
    smem = augment.augment_smem_bytes(n, itemsize, "resident", tile)
    a16 = lambda b: -(-b // 16) * 16  # noqa: E731
    assert smem == (128 + a16(itemsize * n * tile) + 2 * a16(itemsize * n) + a16(4 * n)
                    + a16(4 * -(-n // 32)))
    if tile <= 32:
        assert (smem + augment.resident_static_smem(itemsize) <= augment.MAX_SMEM) == fits
    if not fits:
        with pytest.raises(ValueError):
            augment.augment_geometry(n, itemsize, sms, 1, "resident")
        return
    g = augment.augment_geometry(n, itemsize, sms, 1, "resident")
    assert (g.blocks, g.tile, g.threads, g.smem_bytes) == (blocks, tile, 256, smem)
    assert g.blocks <= sms and (g.blocks - 1) * g.tile < n <= g.blocks * g.tile
    with pytest.raises(RuntimeError):  # no block fits an SM
        augment.augment_geometry(n, itemsize, sms, 0, "resident")


@pytest.mark.parametrize("n,itemsize,sms,layout", [
    (33, 4, 132, "resident"), (2048, 4, 132, "resident"), (2508, 4, 132, "resident"),
    (2509, 4, 132, "staged"), (8192, 4, 132, "staged"), (19_370, 4, 132, "staged"),
    (19_371, 4, 132, "unstaged"), (1729, 8, 132, "resident"), (1730, 8, 132, "staged"),
    (2048, 8, 132, "staged"), (11_623, 8, 132, "unstaged"),
])
def test_augment_layout_by_size(n, itemsize, sms, layout):
    assert augment.augment_layout(n, itemsize, sms) == layout


@pytest.mark.parametrize("n,itemsize,tile,rows", [
    (2048, 4, 16, 256),   # 8 boxes of 256 x 16
    (2048, 8, 16, 256),
    (512, 4, 8, 256),
    (1024, 8, 8, 256),
    (130, 8, 8, 130),     # one box; 130 x 64 B is a multiple of 128 B
    (130, 4, 8, 0),       # a row of 520 B is no multiple of 16
    (2047, 4, 16, 0),
    (33, 4, 8, 0),
    (2508, 4, 19, 0),     # 76 B wide
    (2400, 4, 20, 240),   # 80 B wide: boxes of 240 rows (19,200 B)
    (1012, 4, 8, 92),     # 32 B wide: 92 rows, not 253 (8,096 B, no multiple of 128)
])
def test_resident_tma_rows(n, itemsize, tile, rows):
    """TMA loads a resident tile where C's rows and the tile's width are
    16-byte multiples, in the largest box of at most 256 rows that divides
    n and lands 128-byte aligned."""
    got = augment.resident_tma_rows(n, itemsize, tile)
    assert got == rows
    if rows:
        assert n % rows == 0 and rows <= 256 and (rows * tile * itemsize) % 128 == 0


def test_arr_and_greedy_blocks():
    """S2's and S3's grids: one block a SM by default, never more blocks
    than rows; S3's bits fit a block up to n = 828,288 on 132 SMs."""
    assert arr.arr_blocks(2048, 132, 8) == 132
    assert arr.arr_blocks(2048, 114, 1) == 114
    assert arr.arr_blocks(100, 132, 8) == 100
    assert gm.greedy_match_geometry(2048, 132, 3).blocks == 132
    assert gm.greedy_match_geometry(8192, 114, 4).blocks == 114
    assert gm.greedy_match_geometry(40, 132, 2).blocks == 40
    gm.greedy_match_geometry(828_288, 132, 1)
    with pytest.raises(ValueError):
        gm.greedy_match_geometry(828_289, 132, 1)


@pytest.mark.parametrize("n,blocks,smem", [
    (2048, 132, 4 * (64 + 68 + 16)),
    (8192, 132, 4 * (256 + 260 + 64)),
    (33, 33, 4 * (4 + 4 + 4)),
    (300_000, 132, 4 * (9376 + 9376 + 2276)),
])
def test_greedy_match_geometry(n, blocks, smem):
    g = gm.greedy_match_geometry(n, 132, 1)
    assert (g.blocks, g.threads, g.smem_bytes) == (blocks, 256, smem)
    assert g.smem_bytes == gm.greedy_match_smem_bytes(n, -(-n // blocks))
    with pytest.raises(RuntimeError):  # no block fits an SM
        gm.greedy_match_geometry(n, 132, 0)


@pytest.mark.parametrize("n,itemsize,sms,layout,blocks,smem,default", [
    (2048, 4, 132, "resident", 132, 256 + 64 + 8192 + 8192, True),
    (2048, 4, 64, "resident", 64, 256 + 128 + 8192 + 8192, True),
    (2048, 4, 132, "global", 132, 256 + 64, False),
    (2048, 8, 132, "resident", 132, 256 + 64 + 128 + 64 + 16384 + 8192, True),
    (8192, 4, 132, "resident", 132, 1024 + 256 + 32768 + 32768, True),
    (8192, 4, 114, "resident", 114, 1024 + 288 + 32768 + 32768, True),
    (12_288, 8, 132, "resident", 132, 1536 + 384 + 752 + 384 + 98304 + 49152, True),
    (12_288, 8, 132, "global", 132, 1536 + 384 + 752 + 384, False),
    (33, 4, 132, "resident", 33, 16 + 16 + 144 + 144, True),
    (28_436, 4, 132, "resident", 132, 3568 + 864 + 113744 + 113744, True),
    (28_437, 4, 132, "global", 132, 3568 + 864, True),
    (18_938, 8, 132, "resident", 132, 2368 + 576 + 1152 + 576 + 151504 + 75760, True),
    (100_000, 4, 132, "global", 132, 12512 + 3040, True),
])
def test_arr_geometry(n, itemsize, sms, layout, blocks, smem, default):
    """S2's launch: a block's shared memory (a bit a row, its rows of a
    round, float64 their bids, and in the resident layout v and y), the
    grid, and the default layout: resident where it fits beside the static
    shared memory on one block a SM; a resident launch that does not fit
    raises."""
    g = arr.arr_geometry(n, itemsize, sms, 2, layout)
    assert (g.blocks, g.threads, g.smem_bytes) == (blocks, 256, smem)
    assert g.smem_bytes == arr.arr_smem_bytes(n, itemsize, -(-n // blocks), layout)
    assert (arr.arr_layout(n, itemsize, sms) == layout) == default
    if layout == "global" and default:
        with pytest.raises(ValueError):
            arr.arr_geometry(n, itemsize, sms, 1, "resident")
    with pytest.raises(RuntimeError):  # no block fits an SM
        arr.arr_geometry(n, itemsize, sms, 0, layout)


def test_arr_resident_limits():
    """The resident layout's limits: 28,436 columns in float32 and 18,938 in
    float64 on 132 SMs, 28,420 / 18,908 on 114."""
    for n, itemsize, sms in ((28_436, 4, 132), (18_938, 8, 132), (28_420, 4, 114),
                             (18_908, 8, 114)):
        assert arr.arr_layout(n, itemsize, sms) == "resident"
        assert arr.arr_layout(n + 1, itemsize, sms) == "global"
    assert arr.arr_state_stride(2048, 4) == 16384
    assert arr.arr_state_stride(33, 8) == 512


# ------------------------------------------------- routing and counts


class _Rows2(RowPartition):
    """A row partition of two ranks that holds every row (a stand-in for a
    ``ShardedRows`` block, which needs a process group)."""

    size = 2


def _recorder(calls, name):
    def record(*args):
        calls.append(name)
        raise _Routed

    return record


class _Routed(Exception):
    pass


def test_off_cpu_whole_partition_goes_to_the_kernels(monkeypatch):
    """A tensor off the CPU (here "meta") with a whole partition reaches the
    kernel wrappers, never the eager loops."""
    calls = []
    monkeypatch.setattr(tjv, "augment_sweep", _recorder(calls, "augment"))
    monkeypatch.setattr(tseeded, "arr_auction", _recorder(calls, "arr"))
    monkeypatch.setattr(tseeded, "greedy_match", _recorder(calls, "greedy"))
    monkeypatch.setattr(tjv, "_augment_all_sweep_eager", _recorder(calls, "eager"))
    for name in ("_jacobi_arr_eager", "_greedy_tight_matching_eager"):
        monkeypatch.setattr(tseeded, name, _recorder(calls, "eager"))
    C = torch.empty((8, 8), device="meta")
    m = tjv.Matching(*(torch.empty(8, dtype=torch.int64, device="meta") for _ in range(2)),
                     torch.empty(8, device="meta"))
    stats = tjv.SolveStats()
    monkeypatch.setattr(stats, "device_counts", lambda dev: torch.zeros(5, dtype=torch.int64))
    for fn in (lambda: tjv.augment_all_sweep(C, m, stats),
               lambda: tseeded.jacobi_arr(C, m, stats=stats),
               lambda: tseeded.greedy_tight_matching(torch.empty((8, 8), dtype=torch.bool,
                                                                 device="meta"), stats)):
        with pytest.raises(_Routed):
            fn()
    assert calls == ["augment", "arr", "greedy"]


def test_cpu_and_several_ranks_keep_the_eager_loops(monkeypatch):
    calls = []
    monkeypatch.setattr(tjv, "augment_sweep", _recorder(calls, "kernel"))
    monkeypatch.setattr(tseeded, "arr_auction", _recorder(calls, "kernel"))
    monkeypatch.setattr(tseeded, "greedy_match", _recorder(calls, "kernel"))
    C = _t(_cost("uniform", 16, 1))
    for part in (WHOLE, _Rows2()):
        stats = tjv.SolveStats()
        x, y = tseeded.greedy_tight_matching(C < 0.2, stats, part)
        m = tseeded.jacobi_arr(C, tjv.column_reduction(C), stats=stats, part=part)
        m = tjv.augment_all_sweep(C, m, stats, part)
        assert sorted(m.col_of_row.tolist()) == list(range(16))
        assert stats.host_syncs > 0
    assert calls == []


def test_solve_stats_device_counts_fold_once():
    stats = tjv.SolveStats()
    stats.sweeps += 3
    counts = stats.device_counts(torch.device("cpu"))
    assert counts.tolist() == [0] * len(tjv.DEVICE_COUNTS)
    counts += torch.tensor([1, 2, 3, 4, 5])
    assert stats.device_counts(torch.device("cpu")) is counts
    assert (stats.greedy_rounds, stats.arr_rounds, stats.aug_rounds, stats.sweeps,
            stats.flip_steps) == (1, 2, 3, 7, 5)
    assert stats.host_syncs == 0
    stats.device_counts(torch.device("cpu"))[3] += 10  # a fresh set of slots
    assert stats.sweeps == 17


def test_plain_wrappers_add_their_counts():
    C = _t(_cost("uniform", 24, 2))
    counts = torch.zeros(5, dtype=torch.int64)
    x, y = gm.greedy_match(C < 0.15, counts[0:1])
    m0 = tjv.column_reduction(C)
    xa, ya, va = arr.arr_auction(C, *m0, 32, 0.0, counts[1:2])
    xs, ys, vs = augment.augment_sweep(C, xa, ya, va, counts[2:])
    stats = tjv.SolveStats()
    ex, ey = tseeded.greedy_tight_matching(C < 0.15, stats)
    em = tseeded.jacobi_arr(C, m0, max_rounds=32, stats=stats)
    es = tjv.augment_all_sweep(C, em, stats)
    assert torch.equal(x, ex) and torch.equal(y, ey)
    assert all(_same(a, b) for a, b in zip((xa, ya, va), em))
    assert all(_same(a, b) for a, b in zip((xs, ys, vs), es))
    assert counts.tolist() == [stats.greedy_rounds, stats.arr_rounds, stats.aug_rounds,
                               stats.sweeps, stats.flip_steps]


# ------------------------------------------------- the gate as a select


@pytest.fixture(scope="module")
def jax_seeded():
    """The JAX solver, jitted per gate (imported here, so that the module
    runs where JAX is missing)."""
    jax = pytest.importorskip("jax")
    pytest.importorskip("lapgnn_tpu")
    from lapgnn_tpu.solver import seeded as jseeded

    return jax.jit(jseeded.lapjv_seeded_single, static_argnames=("gate",))


@pytest.fixture(scope="module")
def gate_cases():
    """The 32 seeded cases of tests/test_torch_solver.py: four families, a
    min-trick and a garbage seed each (run under four gates)."""
    out = {}
    for k, fam in enumerate(["uniform", "noisy_linear", "sparse", "tie"]):
        C = FAMILIES[fam](64, np.random.default_rng(30 + k)).astype(np.float32)
        rng = np.random.default_rng(40 + k)
        u = (C.min(1) + rng.normal(0, 0.02, 64)).astype(np.float32)
        out[(fam, "min_trick")] = (C, u, (C - u[:, None]).min(0))
        out[(fam, "garbage")] = (C, rng.normal(0, 100, 64).astype(np.float32),
                                 rng.normal(0, 100, 64).astype(np.float32))
    return out


@pytest.mark.parametrize("gate", ["density", "free_rows", "both", "never"])
def test_gate_select_matches_jax_on_the_seeded_cases(jax_seeded, gate_cases, gate):
    import jax.numpy as jnp

    fired = []
    for key, (C, u, v) in gate_cases.items():
        want = jax_seeded(jnp.asarray(C), jnp.asarray(u), jnp.asarray(v), gate=gate)
        got = tseeded.lapjv_seeded_single(_t(C), _t(u), _t(v), gate=gate)
        assert got.used_fallback.dtype == torch.bool and got.used_fallback.ndim == 0
        assert bool(got.used_fallback) == bool(want.used_fallback), key
        np.testing.assert_array_equal(got.col_of_row.numpy(), np.asarray(want.col_of_row))
        np.testing.assert_array_equal(got.row_of_col.numpy(), np.asarray(want.row_of_col))
        np.testing.assert_array_equal(got.v.numpy().view(np.uint32),
                                      np.asarray(want.v).view(np.uint32))
        fired.append(bool(got.used_fallback))
    # the garbage seed on uniform fires every gate but "never"
    assert fired[1] == (gate != "never")


@pytest.mark.parametrize("gate", ["density", "free_rows", "both", "never"])
def test_gate_select_start_state(gate_cases, gate, monkeypatch):
    """The state ARR starts from is the cold one field by field where the
    gate fires and the warm one elsewhere."""
    C, u, v = gate_cases[("uniform", "garbage")]
    seen = {}
    real = tseeded.jacobi_arr

    def spy(C_, m, **kw):
        seen["m"] = m
        return real(C_, m, **kw)

    monkeypatch.setattr(tseeded, "jacobi_arr", spy)
    res = tseeded.lapjv_seeded_single(_t(C), _t(u), _t(v), gate=gate)
    cold = tjv.column_reduction(_t(C))
    if gate == "never":
        assert not bool(res.used_fallback)
        assert not _same(seen["m"].v, cold.v)
    else:
        assert bool(res.used_fallback)
        assert all(_same(a, b) for a, b in zip(seen["m"], cold))


# ------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _poisoned(C, kind):
    C = C.copy()
    if kind == "nan_row":
        C[3, :] = np.nan
    elif kind == "inf_row":
        C[5, :] = np.inf
    return C


def _states(C, u=None, v=None, max_rounds=None):
    """The inputs the seeded solve hands S3, S2 and S1, on C's device, from
    the CPU's plain loops (ARR's rounds capped at ``max_rounds``, default
    the solver's)."""
    Ct = _t(C)
    n = C.shape[0]
    u = _t(C.min(1) if u is None else u)
    v = (Ct - u[:, None]).amin(0) if v is None else _t(v)
    u = (Ct - v[None, :]).amin(1)
    tight = (Ct - u[:, None] - v[None, :]).abs() <= 1e-5
    x, y = tseeded.greedy_tight_matching(tight)
    m = tjv.Matching(x, y, v)
    rounds = max(64, n // 32) if max_rounds is None else max_rounds
    after_arr = tseeded.jacobi_arr(Ct, m, max_rounds=rounds)
    return tight, m, after_arr


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "nan_row", "inf_row"])
@pytest.mark.parametrize("fam,n", [("uniform", 33), ("uniform", 512), ("tie", 256),
                                   ("sparse", 300), ("noisy_linear", 1024)])
def test_kernels_match_plain_loops_on_card(cuda, fam, n, kind):
    C = _poisoned(_cost(fam, n, 60 + n), kind)
    tight, m, after_arr = _states(C)
    Cd = _t(C).to(cuda)
    on = lambda t: t.to(cuda)  # noqa: E731
    k0, p0 = (torch.zeros(5, dtype=torch.int64, device=cuda) for _ in range(2))
    names = ("launch.greedy_match", "launch.arr_auction", "launch.augment_sweep")
    before = [tracing.counters().get(k, 0) for k in names]
    got = gm.greedy_match(on(tight), k0[0:1])
    want = gm.greedy_match_plain(on(tight), p0[0:1])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    rounds = max(64, n // 32)
    got = arr.arr_auction(Cd, *map(on, m), rounds, 0.0, k0[1:2])
    want = arr.arr_auction_plain(Cd, *map(on, m), rounds, 0.0, p0[1:2])
    assert all(_same(a, b) for a, b in zip(got, want))
    got = augment.augment_sweep(Cd, *map(on, after_arr), k0[2:])
    want = augment.augment_sweep_plain(Cd, *map(on, after_arr), p0[2:])
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want))
    assert torch.equal(k0, p0)
    after = [tracing.counters().get(k, 0) for k in names]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fam,n,kind", [("uniform", 512, "plain"), ("tie", 256, "plain"),
                                        ("uniform", 300, "nan_row"), ("sparse", 300, "inf_row")])
def test_unstaged_layout_matches_plain_loop_on_card(cuda, fam, n, kind, dtype):
    """S1's layout for the n whose rows' vectors do not fit in shared memory
    (u, x and e read from device memory through L2), forced at a size where
    the staged one fits: x, y, v and the counts equal the plain loop's."""
    C = _poisoned(_cost(fam, n, 80 + n), kind).astype(dtype)
    _, _, after_arr = _states(C)
    Cd = _t(C).to(cuda)
    state = [t.to(cuda) for t in after_arr]
    k, p = (torch.zeros(3, dtype=torch.int64, device=cuda) for _ in range(2))
    got = augment._augment(Cd, *state, k, layout="unstaged")
    want = augment.augment_sweep_plain(Cd, *state, p)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, want))
    assert torch.equal(k, p)


_RESIDENT_CASES = [(n, np.float32, fam, kind) for n in (33, 512, 2048)
                   for fam, kind in (("uniform", "plain"), ("tie", "plain"),
                                     ("uniform", "nan_row"), ("uniform", "inf_row"))]
_RESIDENT_CASES += [(n, np.float64, fam, kind) for n in (33, 512, 1024)
                    for fam, kind in (("uniform", "plain"), ("tie", "plain"),
                                      ("uniform", "nan_row"), ("uniform", "inf_row"))]
_RESIDENT_CASES += [(n, dt, "uniform", "plain") for n in (130, 131) for dt in (np.float32, np.float64)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype,fam,kind", _RESIDENT_CASES)
def test_resident_layout_matches_plain_loop_on_card(cuda, n, dtype, fam, kind):
    """S1's resident layout (each block's tile of C in shared memory for the
    launch; TMA where aligned, and forced to coalesced loads), the staged
    layout forced, and the plain loop: x, y, v and the counts bit for bit."""
    C = _poisoned(_cost(fam, n, 90 + n), kind).astype(dtype)
    _, _, after_arr = _states(C)
    Cd = _t(C).to(cuda)
    state = [t.to(cuda) for t in after_arr]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert augment.augment_layout(n, C.itemsize, sms) == "resident"
    runs = {}
    for name, kw in (("resident", {}), ("resident_loads", {"layout": "resident", "tma": False}),
                     ("staged", {"layout": "staged"})):
        counts = torch.zeros(3, dtype=torch.int64, device=cuda)
        runs[name] = (*augment._augment(Cd, *state, counts, **kw), counts)
    p = torch.zeros(3, dtype=torch.int64, device=cuda)
    want = (*augment.augment_sweep_plain(Cd, *state, p), p)
    torch.cuda.synchronize()
    for name, got in runs.items():
        assert all(_same(a, b) for a, b in zip(got, want)), name


@pytest.mark.cuda
def test_resident_static_smem_and_barrier_bench(cuda):
    """The static shared memory the resident layout's limit assumes bounds
    the kernel's own, and the barrier bench runs on the resident grid."""
    from lapgnn_tpu_torch.ops.cuda._lib import KERNEL_LIBS

    lib = KERNEL_LIBS["augment"].load()
    for f64, itemsize in ((0, 4), (1, 8)):
        for layout in range(3):
            got = lib.lapgnn_augment_static_smem(f64, layout)
            assert 0 < got <= augment.resident_static_smem(itemsize), (f64, layout, got)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    g = augment.augment_geometry(2048, 4, sms, 1, "resident")
    for payload in (False, True):
        augment.barrier_bench(cuda, g, 1000, payload)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("fam", ["uniform", "noisy_linear", "sparse", "tie"])
def test_seeded_solve_on_card_equals_cpu(cuda, fam, dtype):
    n = 512
    C = _cost(fam, n, 70)
    u = C.min(1)
    v = (C - u[:, None]).min(0)
    args = [torch.from_numpy(a).to(dtype) for a in (C, u, v)]
    st_card, st_cpu = tjv.SolveStats(), tjv.SolveStats()
    card = tseeded.lapjv_seeded_single(*(a.to(cuda) for a in args), gate="both", stats=st_card)
    cpu = tseeded.lapjv_seeded_single(*args, gate="both", stats=st_cpu)
    for field in ("col_of_row", "row_of_col", "v", "used_fallback"):
        assert _same(getattr(card, field).cpu(), getattr(cpu, field)), field
    assert st_card.host_syncs == 0
    for name in tjv.DEVICE_COUNTS:
        assert getattr(st_card, name) == getattr(st_cpu, name), name


@pytest.mark.cuda
def test_kernels_raise_on_an_unsupported_dtype(cuda):
    C = torch.rand((16, 16), device=cuda, dtype=torch.float16)
    x = torch.full((16,), -1, dtype=torch.int64, device=cuda)
    counts = torch.zeros(5, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        augment.augment_sweep(C, x, x, C[0], counts[2:])
    with pytest.raises(TypeError):
        arr.arr_auction(C, x, x, C[0], 4, 0.0, counts[1:2])
    with pytest.raises(TypeError):
        gm.greedy_match(C, counts[0:1])


def _card_start(C, device):
    """S2's start on the card from C (numpy): the min-trick seed's tight
    matrix and its greedy matching by the plain loop there."""
    Ct = _t(C).to(device)
    u = Ct.amin(1)
    v = (Ct - u[:, None]).amin(0)
    u = (Ct - v[None, :]).amin(1)
    tight = (Ct - u[:, None] - v[None, :]).abs() <= 1e-5
    x, y = gm.greedy_match_plain(tight, torch.zeros(1, dtype=torch.int64, device=device))
    return Ct, tight, (x, y, v)


_S2_CARD_CASES = [(n, dt, fam, kind) for n in (512, 2048) for dt in (np.float32, np.float64)
                  for fam, kind in (("uniform", "plain"), ("tie", "plain"),
                                    ("uniform", "nan_row"), ("uniform", "inf_row"))]
_S2_CARD_CASES += [(8192, np.float32, "uniform", "plain"), (8192, np.float32, "sparse", "plain"),
                   (130, np.float32, "uniform", "plain"), (33, np.float64, "tie", "plain")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype,fam,kind", _S2_CARD_CASES)
def test_arr_layouts_match_plain_loop_on_card(cuda, n, dtype, fam, kind):
    """S2 in its resident and its global layout against its plain loop on
    the card: x, y, v bit for bit (NaN one class) and the rounds."""
    C = _poisoned(_cost(fam, n, 95 + n), kind).astype(dtype)
    Ct, _, start = _card_start(C, cuda)
    rounds = max(64, n // 32)
    p = torch.zeros(1, dtype=torch.int64, device=cuda)
    want = (*arr.arr_auction_plain(Ct, *start, rounds, 0.0, p), p)
    for layout in arr.LAYOUTS:
        k = torch.zeros(1, dtype=torch.int64, device=cuda)
        got = (*arr._arr(Ct, *start, rounds, 0.0, k, layout=layout), k)
        torch.cuda.synchronize()
        assert all(_same(a, b) for a, b in zip(got, want)), layout


@pytest.mark.cuda
@pytest.mark.parametrize("n,fam,kind", [(n, fam, "plain") for n in (512, 2048, 8192)
                                        for fam in ("uniform", "sparse", "tie")]
                         + [(2048, "uniform", "nan_row"), (2048, "uniform", "inf_row"),
                            (131, "uniform", "plain"), (33, "tie", "plain"),
                            (1000, "noisy_linear", "plain")])
def test_greedy_match_matches_plain_loop_on_card(cuda, n, fam, kind):
    """S3 against its plain loop on the card: x, y and the rounds; n % 16 != 0
    takes the rows' unaligned heads and tails."""
    C = _poisoned(_cost(fam, n, 97 + n), kind)
    _, tight, _ = _card_start(C, cuda)
    p = torch.zeros(1, dtype=torch.int64, device=cuda)
    want = (*gm.greedy_match_plain(tight, p), p)
    k = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = (*gm.greedy_match_kernel(tight, k), k)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_arr_and_greedy_static_smem_and_sync_floor(cuda):
    """The static shared memory S2's and S3's limits assume bounds the
    kernels' own, and the barrier bench runs on their grids."""
    from lapgnn_tpu_torch.ops.cuda._lib import KERNEL_LIBS

    lib = KERNEL_LIBS["arr"].load()
    for f64 in (0, 1):
        for layout in range(len(arr.LAYOUTS)):
            got = lib.lapgnn_arr_static_smem(f64, layout)
            assert 0 < got <= arr.STATIC_SMEM, (f64, layout, got)
    got = KERNEL_LIBS["greedy_match"].load().lapgnn_greedy_match_static_smem()
    assert 0 < got <= gm.STATIC_SMEM
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for g in (arr.arr_geometry(2048, 4, sms, 1, "resident"), gm.greedy_match_geometry(2048, sms, 1)):
        augment.barrier_bench(cuda, g, 1000)
    torch.cuda.synchronize()
