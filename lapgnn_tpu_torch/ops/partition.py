"""Row partitions: which rows of a cost matrix this process holds, and how a
row-local partial result becomes the whole one.

The solver (``solver.jv``, ``solver.seeded``) and the seed policy
(``ops.dual.robust_normalize``, ``ops.rank1``, ``ops.sinkhorn``) take a
partition ``part`` and route every reduction across rows through it.  The
default, ``WHOLE``, holds every row: each method is the identity or the
plain reduction, so those functions compute what they always did.
``parallel.sharded.ShardedRows`` holds one rank's contiguous block of rows
and combines the ranks' partial results with collectives, so the same code
is the row-sharded path.

The training losses (``train.loss``) and the DualGNN take the more general
``EdgePartition``, of which a row partition is one: a block of the rows
and of the columns (``parallel.dual.EdgeTiles``, a tile).  Its methods
name the two matrix axes apart.  ``over_rows`` / ``over_cols`` combine
partial results taken over this block's rows / columns with the other
blocks'; ``vary_rows`` / ``vary_cols`` hand a value that every block along
the row / column split holds alike to this block's own computation (the
identity forward; ``parallel.collectives.pvary``'s SUM of the gradients
backward).  For ``WHOLE`` all of them are the plain operations.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["EdgePartition", "RowPartition", "WHOLE"]


class EdgePartition:
    """Every entry of C, held by this process.  Subclasses hold a block of
    its rows and columns and combine partial results with the others'."""

    def min(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum of the partial results over the partition."""
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def whole_shape(self, t: torch.Tensor) -> Tuple[int, int]:
        """(rows, columns) of the whole matrix of which ``t`` holds this
        block."""
        return t.shape[-2], t.shape[-1]

    def over_rows(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Partial results over this block's rows (``op`` "sum", "min" or
        "max"), combined over every row."""
        return t

    def over_cols(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Partial results over this block's columns, combined over every
        column."""
        return t

    def vary_rows(self, t: torch.Tensor) -> torch.Tensor:
        """A value held alike by the blocks of every row, handed to this
        block's computation."""
        return t

    def vary_cols(self, t: torch.Tensor) -> torch.Tensor:
        """A value held alike by the blocks of every column (a vector of
        this block's rows), handed to this block's computation."""
        return t

    def amin_rows(self, t: torch.Tensor) -> torch.Tensor:
        """``t.amin(-2)`` over every row, with amin's gradient."""
        return t.amin(-2)

    def amin_cols(self, t: torch.Tensor) -> torch.Tensor:
        """``t.amin(-1)`` over every column, with amin's gradient."""
        return t.amin(-1)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every row of a (..., rows, m) block, without gradient."""
        return t

    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean of a per-instance value over the whole batch."""
        return t.mean()



class RowPartition(EdgePartition):
    """Every row of C, held by this process.  Subclasses hold a block of
    ``rows`` rows starting at ``offset`` out of ``size`` equal blocks, and
    every column."""

    offset = 0
    size = 1

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of a per-row vector held for every row."""
        return x

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Per-row values of this process's rows -> the values of every row."""
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """Mean of each instance's entries, (..., rows, m) -> (...)."""
        return t.mean((-2, -1))

    def norm(self, y: torch.Tensor) -> torch.Tensor:
        """Euclidean norm of a per-row vector over every row (keepdim)."""
        return torch.linalg.vector_norm(y, dim=-1, keepdim=True)

    def logsumexp(self, z: torch.Tensor) -> torch.Tensor:
        """logsumexp over the rows (dim -2)."""
        return torch.logsumexp(z, dim=-2)

    def sample_rows(self, t: torch.Tensor, stride: int) -> torch.Tensor:
        """Every ``stride``-th row of every row, (B, rows, m) -> (B, k, m)."""
        return t[..., ::stride, :]

    def argmin(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Column minima of the rows and the first row attaining each."""
        return torch.min(t, dim=0)

    def min_trick(self, C: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """min_i (C_ij - u_i) over every row."""
        return (C - u[..., :, None]).amin(-2)

    def best_bid(
        self, cols: torch.Tensor, gaps: torch.Tensor, rows: torch.Tensor, n: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The auction of a Jacobi-ARR round: row ``rows[k]`` bids ``gaps[k]``
        for column ``cols[k]`` (``n`` for no bid).  Returns, over the n + 1
        slots, each column's largest gap (-inf without a bid) and the lowest
        row that bid it (n without a bid)."""
        neg_inf = float("-inf")
        bid = cols < n
        col_best = self.max(torch.full((n + 1,), neg_inf, dtype=gaps.dtype, device=gaps.device)
                            .scatter_reduce_(0, cols, torch.where(bid, gaps, neg_inf), "amax"))
        cand = bid & (gaps >= col_best[cols])
        win_row = self.min(torch.full((n + 1,), n, dtype=torch.int64, device=gaps.device)
                           .scatter_reduce_(0, torch.where(cand, cols, n),
                                            torch.where(cand, rows, n), "amin"))
        return col_best, win_row


WHOLE = RowPartition()
