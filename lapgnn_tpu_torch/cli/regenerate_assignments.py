"""Recompute the optimal assignments (and, with ``--refresh-duals``, the
duals) of an HDF5 dataset with SciPy and write them to a new file.

Port of ``lapgnn_tpu/cli/regenerate_assignments.py``, on the port's
``H5Reader`` / ``H5Writer`` and ``ops.host_dual.duals_from_matching_np``;
both CLIs write the same file.  Needs ``h5py``.

Example:
  python -m lapgnn_tpu_torch.cli.regenerate_assignments --input data/x/train.h5 \
      --output data/x/train_fixed.h5 --refresh-duals
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", type=Path, required=True)
    p.add_argument("--output", type=Path, required=True)
    p.add_argument("--refresh-duals", action="store_true")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    import scipy.optimize

    from ..data.h5io import H5Reader, H5Writer
    from ..data.synthetic import SyntheticInstance
    from ..ops.host_dual import duals_from_matching_np

    fixed = 0
    with H5Reader(args.input) as r, H5Writer(args.output) as w:
        for i in range(len(r)):
            rec = r[i]
            C = rec["cost"]
            rows, cols = scipy.optimize.linear_sum_assignment(C)
            if not np.array_equal(cols, rec["cols"][np.argsort(rec["rows"])]):
                fixed += 1
            u, v = rec["u"], rec["v"]
            if args.refresh_duals:
                u, v, _ = duals_from_matching_np(C, rows, cols)
            w.append(
                SyntheticInstance(
                    cost=C,
                    rows=rows.astype(np.int32),
                    cols=cols.astype(np.int32),
                    u=np.asarray(u, np.float64),
                    v=np.asarray(v, np.float64),
                    family=rec["family"],
                    size=rec["n"],
                    noise_std=0.0,
                )
            )
    print(f"rewrote {args.output} ({fixed} assignments changed)")


if __name__ == "__main__":
    main()
