"""Split planning with largest-remainder rounding (numpy only).

The port's own copy of ``lapgnn_tpu/data/splits.py`` (``plan_bucket`` :20,
``iter_bucket_assignments`` :50): given a bucket of ``count`` instances and
split ratios, assign each instance a split label such that the counts
respect the ratios (the largest fractional remainder gets the leftover),
then shuffle the labels with the caller's numpy Generator, drawing what the
JAX module draws.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import hashlib

import numpy as np

__all__ = ["plan_bucket", "iter_bucket_assignments"]


def plan_bucket(
    count: int,
    ratios: Dict[str, float],
    rng: np.random.Generator,
) -> List[str]:
    """Return a shuffled list of ``count`` split labels matching ``ratios``."""
    if count <= 0:
        return []
    names = list(ratios.keys())
    weights = np.asarray([max(0.0, float(ratios[k])) for k in names], dtype=float)
    total = weights.sum()
    if total <= 0:
        raise ValueError("split ratios must sum to a positive value")
    weights = weights / total

    exact = weights * count
    base = np.floor(exact).astype(int)
    remainder = count - int(base.sum())
    # Largest fractional remainders receive the leftover slots.
    frac_order = np.argsort(-(exact - base))
    for idx in frac_order[:remainder]:
        base[idx] += 1

    labels: List[str] = []
    for name, c in zip(names, base):
        labels.extend([name] * int(c))
    rng.shuffle(labels)
    return labels


def iter_bucket_assignments(
    counts: Sequence[Tuple[str, int]],
    ratios: Dict[str, float],
    seed: int = 0,
) -> Iterator[Tuple[str, int, str]]:
    """Yield (bucket_name, index_within_bucket, split) over all buckets.

    Each bucket derives its own RNG from (seed, bucket name): adding,
    removing, or reordering buckets leaves every other bucket's
    train/val/test membership unchanged (a single threaded RNG would
    silently reshuffle all later buckets and contaminate cross-version
    dataset comparisons).
    """
    for bucket, count in counts:
        h = int.from_bytes(
            hashlib.sha256(bucket.encode()).digest()[:8], "little"
        )
        rng = np.random.default_rng((seed, h))
        for i, split in enumerate(plan_bucket(count, ratios, rng)):
            yield bucket, i, split
