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
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["RowPartition", "WHOLE"]


class RowPartition:
    """Every row of C, held by this process.  Subclasses hold a block of
    ``rows`` rows starting at ``offset`` out of ``size`` equal blocks."""

    offset = 0
    size = 1

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of a per-row vector held for every row."""
        return x

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """Per-row values of this process's rows -> the values of every row."""
        return t

    def min(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise minimum of the partial results over the partition."""
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
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
