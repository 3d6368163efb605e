"""OneGNN training CLI: train on HDF5 splits and save a checkpoint.

Port of ``lapgnn_tpu/cli/train_one_gnn.py``, with ``--device`` (default
``cuda``; ``cpu`` trains on the CPU).  The checkpoint carries the JAX CLI's
meta keys, so either package loads it.  Needs ``h5py``.

Example:
  python -m lapgnn_tpu_torch.cli.train_one_gnn --train data/mid512/train.h5 \
      --val data/mid512/val.h5 --epochs 20 --hidden 64 --layers 2 \
      --output artifacts/one_gnn_default
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train", type=Path, required=True, nargs="+")
    p.add_argument("--val", type=Path, nargs="*", default=[])
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--topk", type=int, default=16)
    p.add_argument("--context", action="store_true")
    p.add_argument("--use-cost-refinement", action="store_true")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--min-epochs", type=int, default=10)
    p.add_argument("--patience", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", type=Path, required=True)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from ..data.h5io import read_records
    from ..train.checkpoint import save_checkpoint
    from ..train.trainer import TrainConfig, train_one_gnn

    train_insts = read_records(args.train)
    val_insts = read_records(args.val) if args.val else None
    print(f"train instances: {len(train_insts)}; val: {len(val_insts or [])}")

    cfg = TrainConfig(
        hidden=args.hidden,
        layers=args.layers,
        dropout=args.dropout,
        topk=args.topk,
        context=args.context,
        use_cost_refinement=args.use_cost_refinement,
        lr=args.lr,
        weight_decay=args.weight_decay,
        epochs=args.epochs,
        batch_size=args.batch_size,
        min_epochs=args.min_epochs,
        patience=args.patience,
        seed=args.seed,
    )
    params, history = train_one_gnn(train_insts, val_insts, cfg, device=args.device)
    save_checkpoint(
        args.output,
        params,
        {
            "architecture": "one_gnn",
            "hidden": args.hidden,
            "layers": args.layers,
            "dropout": args.dropout,
            "topk": args.topk,
            "context": args.context,
            "use_cost_refinement": args.use_cost_refinement,
            "row_feat_dim": 21,
            "features": "full",
            "history": history,
        },
    )
    print(f"saved checkpoint to {args.output}")


if __name__ == "__main__":
    main()
