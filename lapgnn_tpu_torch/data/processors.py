"""Real-data processors: OR-Library assignment files, MatrixMarket files,
STRING protein links (numpy, SciPy).

The port's own copy of ``lapgnn_tpu/data/processors.py`` (``RealInstance``
:50, ``parse_orlib_assign`` :68, ``string_links_to_cost`` :97,
``parse_matrix_market`` :147, ``fetch_suitesparse`` :179,
``iter_real_instances`` :206, ``normalize_cost_matrix`` :229): parse local
files into square float64 cost matrices.  The one network fetch
(``fetch_suitesparse``) is gated behind the ``LAPGNN_ALLOW_FETCH=1``
environment variable and the optional ``ssgetpy`` package; everything else
reads local files only.

Formats:
- OR-Library ``.assign``: the first whitespace token is n, followed by n*n
  integer costs in row-major order (line layout is arbitrary).  ``.gz`` is
  read transparently.
- MatrixMarket ``.mtx`` (SuiteSparse's distribution format): coordinate or
  array format via ``scipy.io.mmread``; densified, rectangular matrices
  cropped to the leading square block.
- STRING ``protein.links``: rows of ``proteinA proteinB combined_score``
  (score in 0..1000, optional header line).  The cost is
  ``1 - score/1000`` for linked pairs, 1.0 for unlinked, 0.0 on the
  diagonal; the zero diagonal makes the identity matching trivially
  optimal, so these matrices are a parsing and scale benchmark, not a hard
  LAP instance.
"""

from __future__ import annotations

import gzip
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator, Sequence

import numpy as np

__all__ = [
    "RealInstance",
    "parse_orlib_assign",
    "parse_matrix_market",
    "string_links_to_cost",
    "fetch_suitesparse",
    "iter_real_instances",
    "normalize_cost_matrix",
]

# Explicit opt-in for anything that would touch the network.
_FETCH_ENV = "LAPGNN_ALLOW_FETCH"


@dataclass
class RealInstance:
    """A parsed real-world cost matrix."""

    name: str
    cost: np.ndarray  # (n, n) float64
    source: str  # 'orlib' | 'string' | 'suitesparse'


def _open_text(path: Path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def _strip_gz(name: str) -> str:
    return name[:-3] if name.endswith(".gz") else name


def parse_orlib_assign(path) -> RealInstance:
    """Parse an OR-Library ``.assign`` file (n, then n*n integer costs).

    Mirrors reference data/processors.py:21-43.  Tokens are read as one
    whitespace-separated stream so any line wrapping is accepted; a file
    with fewer than n*n cost entries raises ValueError.
    """
    path = Path(path)
    with _open_text(path) as f:
        tokens = f.read().split()
    if not tokens:
        raise ValueError(f"{path}: empty assignment file")
    try:
        n = int(tokens[0])
    except ValueError as e:
        raise ValueError(f"{path}: first token is not an integer size") from e
    if n <= 0:
        raise ValueError(f"{path}: non-positive size {n}")
    vals = tokens[1:]
    if len(vals) < n * n:
        raise ValueError(
            f"{path}: truncated — expected {n * n} costs, found {len(vals)}"
        )
    cost = np.asarray([float(v) for v in vals[: n * n]], dtype=np.float64)
    cost = cost.reshape(n, n)
    name = Path(_strip_gz(path.name)).stem
    return RealInstance(name=name, cost=cost, source="orlib")


def string_links_to_cost(path, max_nodes: int | None = None) -> RealInstance:
    """Build a bipartite cost matrix from a STRING protein-links file.

    cost[i, j] = 1 - combined_score/1000 for a recorded link, 1.0 for an
    unrecorded pair, 0.0 on the diagonal (reference
    data/processors.py:62-144).  Streams the file line by line (these dumps
    reach multi-GB; never readlines() them).  Protein identity order is
    first-appearance order, capped at ``max_nodes`` when given.
    """
    path = Path(path)
    index: dict[str, int] = {}
    edges: list[tuple[int, int, float]] = []

    def _idx(name: str) -> int | None:
        i = index.get(name)
        if i is None:
            if max_nodes is not None and len(index) >= max_nodes:
                return None
            i = len(index)
            index[name] = i
        return i

    with _open_text(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            a, b, s = parts[0], parts[1], parts[2]
            try:
                score = float(s)
            except ValueError:
                continue  # header line ('combined_score') or malformed row
            ia, ib = _idx(a), _idx(b)
            if ia is None or ib is None:
                continue
            edges.append((ia, ib, score))

    n = len(index)
    if n == 0:
        raise ValueError(f"{path}: no parseable links")
    cost = np.ones((n, n), dtype=np.float64)
    for ia, ib, score in edges:
        c = 1.0 - score / 1000.0
        cost[ia, ib] = c
        cost[ib, ia] = c
    np.fill_diagonal(cost, 0.0)
    name = Path(_strip_gz(path.name)).stem
    return RealInstance(name=name, cost=cost, source="string")


def parse_matrix_market(path) -> RealInstance:
    """Parse a local MatrixMarket ``.mtx[.gz]`` file (SuiteSparse's
    distribution format) into a square cost matrix.

    The offline twin of :func:`fetch_suitesparse`: the reference downloads
    via ssgetpy and densifies (reference data/processors.py:46-59,
    ``todense`` then square crop); here the same semantics run on a local
    file — unstored sparse entries become 0-cost edges, rectangular
    matrices crop to their leading square block, and pattern (no-value)
    matrices read as 0/1.  This keeps the SuiteSparse ingestion path
    exercisable without a network through vendored .mtx bytes.
    """
    import scipy.io
    import scipy.sparse

    path = Path(path)
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            mat = scipy.io.mmread(f)
    else:
        mat = scipy.io.mmread(path)
    if scipy.sparse.issparse(mat):
        dense = np.asarray(mat.todense(), dtype=np.float64)
    else:
        dense = np.asarray(mat, dtype=np.float64)
    k = min(dense.shape)
    if k == 0:
        raise ValueError(f"{path}: empty matrix")
    name = Path(_strip_gz(path.name)).stem
    return RealInstance(name=name, cost=dense[:k, :k], source="suitesparse")


def fetch_suitesparse(matrix_name: str) -> RealInstance:
    """Fetch a SuiteSparse matrix (reference data/processors.py:46-59).

    Gated: requires ``LAPGNN_ALLOW_FETCH=1`` and the optional ``ssgetpy``
    package; without them it raises with an actionable message instead of
    attempting a download.
    """
    if os.environ.get(_FETCH_ENV) != "1":
        raise RuntimeError(
            f"network fetches are disabled; set {_FETCH_ENV}=1 to allow "
            "downloading SuiteSparse matrices (requires egress + ssgetpy)"
        )
    try:
        import ssgetpy  # type: ignore
    except ImportError as e:  # pragma: no cover - optional dep
        raise RuntimeError("ssgetpy is not installed") from e
    result = ssgetpy.search(name=matrix_name)  # pragma: no cover
    if not result:  # pragma: no cover
        raise ValueError(f"no SuiteSparse matrix named {matrix_name!r}")
    mat = result[0].download(extract=True)  # pragma: no cover
    dense = np.asarray(mat.todense(), dtype=np.float64)  # pragma: no cover
    k = min(dense.shape)  # pragma: no cover
    return RealInstance(  # pragma: no cover
        name=matrix_name, cost=dense[:k, :k], source="suitesparse"
    )


def iter_real_instances(paths: Sequence) -> Iterator[RealInstance]:
    """Multiplex local real-instance files by format.

    ``*.assign[.gz]`` -> OR-Library parser; anything whose name contains
    ``links`` -> STRING parser (reference data/processors.py:147-181).
    Unrecognised files are skipped with a warning rather than aborting a
    benchmark sweep.
    """
    import warnings

    for p in paths:
        p = Path(p)
        base = _strip_gz(p.name)
        if base.endswith(".assign"):
            yield parse_orlib_assign(p)
        elif base.endswith(".mtx"):
            yield parse_matrix_market(p)
        elif "links" in base:
            yield string_links_to_cost(p)
        else:
            warnings.warn(f"iter_real_instances: unrecognised format {p}")


def normalize_cost_matrix(C: np.ndarray) -> np.ndarray:
    """Min-max normalise to [0, 1]; constant matrices map to all-zeros.

    Reference data/processors.py:184-196.  Keeps relative structure while
    bounding magnitudes so f32 device paths and the LARGE sentinel logic
    see a uniform scale across real sources.
    """
    C = np.asarray(C, dtype=np.float64)
    lo = float(C.min())
    hi = float(C.max())
    span = hi - lo
    if span <= 0.0:
        return np.zeros_like(C)
    return (C - lo) / span
