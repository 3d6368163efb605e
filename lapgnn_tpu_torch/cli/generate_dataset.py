"""Dataset generation CLI: labelled synthetic instances over sizes x
families, split into train / val / test by largest-remainder rounding,
written as HDF5 files in the JAX package's schema.

Port of ``lapgnn_tpu/cli/generate_dataset.py``: it consumes one
``np.random.default_rng(seed)`` in the same order (a bucket's split labels,
then its instances), so both CLIs write the same files.  Needs ``h5py``.

Example:
  python -m lapgnn_tpu_torch.cli.generate_dataset --output data/mid512 \
      --sizes 512 --families uniform sparse --instances 100 \
      --split 0.8 0.1 0.1 --seed 0
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output", type=Path, required=True, help="output directory")
    p.add_argument("--sizes", type=int, nargs="+", default=[512])
    p.add_argument(
        "--families",
        nargs="+",
        default=["uniform"],
        help="synthetic families (see lapgnn_tpu_torch.data.generators.FAMILIES)",
    )
    p.add_argument("--instances", type=int, default=100, help="instances per (size, family)")
    p.add_argument("--split", type=float, nargs=3, default=[0.8, 0.1, 0.1],
                   metavar=("TRAIN", "VAL", "TEST"))
    p.add_argument("--dual-noise-prob", type=float, default=0.0)
    p.add_argument("--dual-noise-std", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..data.h5io import H5Writer
    from ..data.splits import plan_bucket
    from ..data.synthetic import generate_synthetic_instance

    rng = np.random.default_rng(args.seed)
    ratios = {"train": args.split[0], "val": args.split[1], "test": args.split[2]}
    writers = {name: H5Writer(args.output / f"{name}.h5") for name, r in ratios.items() if r > 0}
    counts = {name: 0 for name in writers}
    try:
        for n in args.sizes:
            for family in args.families:
                labels = plan_bucket(args.instances, ratios, rng)
                for k, split in enumerate(labels):
                    inst = generate_synthetic_instance(
                        family, n, rng,
                        noise_std=args.dual_noise_std, dual_noise_prob=args.dual_noise_prob,
                    )
                    inst.tag = f"{family}_{n}_{k}"
                    writers[split].append(inst)
                    counts[split] += 1
                print(f"size={n} family={family}: {args.instances} instances")
    finally:
        for w in writers.values():
            w.close()
    print("written:", counts)


if __name__ == "__main__":
    main()
