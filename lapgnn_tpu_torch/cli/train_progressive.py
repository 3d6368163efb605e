"""Progressive curriculum training CLI: ``train.progressive.train_progressive``
driven by the JAX CLI's YAML schema (datasets / model / loss / optimizer /
sampling / training / checkpointing).

Port of ``lapgnn_tpu/cli/train_progressive.py``, with ``--device`` (default
``cuda``; ``cpu`` trains on the CPU).  Needs ``h5py`` and PyYAML.

Example:
  python -m lapgnn_tpu_torch.cli.train_progressive --config configs/progressive_default.yaml
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=Path, required=True)
    p.add_argument("--init-checkpoint", type=Path, default=None)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    import yaml

    from ..data.h5io import H5Reader
    from ..train.checkpoint import load_checkpoint
    from ..train.progressive import DatasetSpec, train_progressive

    config = yaml.safe_load(args.config.read_text())

    def load_size(path, size):
        with H5Reader(path) as r:
            return [r[i] for i in np.nonzero(r.sizes() == size)[0]]

    specs = []
    for d in config["datasets"]:
        insts = load_size(d["path"], d["size"])
        vals = load_size(d["val_path"], d["size"]) if d.get("val_path") else None
        if not insts:
            print(f"warning: dataset {d['name']} has no instances of size {d['size']}")
            continue
        specs.append(
            DatasetSpec(
                name=d["name"],
                size=int(d["size"]),
                instances=insts,
                weight=float(d.get("weight", 1.0)),
                curriculum_start_epoch=int(d.get("curriculum_start_epoch", 0)),
                val_instances=vals,
            )
        )
        print(f"{d['name']}: {len(insts)} train / {len(vals or [])} val at n={d['size']}")

    init_params = None
    if args.init_checkpoint:
        init_params, _, _ = load_checkpoint(args.init_checkpoint)
        print(f"warm init from {args.init_checkpoint}")

    _, history = train_progressive(config, specs, init_params=init_params, device=args.device)
    print("done. best val gap:", min(history["val_gap_median_avg"] or [float("inf")]))


if __name__ == "__main__":
    main()
