"""DualGNN training CLI: train on HDF5 splits and save a checkpoint.

Port of ``lapgnn_tpu/cli/train_dual_gnn.py``, with ``--device`` (default
``cuda``; ``cpu`` trains on the CPU).  The checkpoint carries the JAX CLI's
meta keys, so either package loads it.  ``--mesh-2d`` (the JAX package's
edge-partitioned training) is not ported and raises.  Needs ``h5py``.

Example:
  python -m lapgnn_tpu_torch.cli.train_dual_gnn --train data/mid512/train.h5 \
      --val data/mid512/val.h5 --epochs 10 --output artifacts/dual_gnn
"""

from __future__ import annotations

import argparse
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train", type=Path, required=True, nargs="+")
    p.add_argument("--val", type=Path, nargs="*", default=[])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--min-epochs", type=int, default=5)
    p.add_argument("--patience", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--raw-reference-loss", action="store_true",
        help="train with the unclipped, unnormalised, unsupervised loss "
             "(sparse-family 1e6 sentinels then dominate the gradient and the "
             "oracle-dual u-MSE term is dropped; see train/loss.dual_gnn_loss)",
    )
    p.add_argument(
        "--init-checkpoint", type=Path, default=None,
        help="warm-start (fine-tune) from an existing dual_gnn checkpoint",
    )
    p.add_argument(
        "--mesh-2d", default=None, metavar="ROWxCOL",
        help="train over a 2-D edge-partitioned device mesh: not ported yet, raises",
    )
    p.add_argument("--output", type=Path, required=True)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.mesh_2d:
        raise NotImplementedError(
            "--mesh-2d: the 2-D edge-partitioned DualGNN training "
            "(lapgnn_tpu/parallel/) is not ported yet (see ROADMAP.md)"
        )
    from ..data.h5io import read_records
    from ..train.checkpoint import load_checkpoint, save_checkpoint
    from ..train.dual_trainer import DualTrainConfig, train_dual_gnn

    train_insts = read_records(args.train)
    val_insts = read_records(args.val) if args.val else None
    print(f"train: {len(train_insts)} val: {len(val_insts or [])}")

    raw = args.raw_reference_loss
    cfg = DualTrainConfig(
        hidden=args.hidden,
        layers=args.layers,
        heads=args.heads,
        dropout=args.dropout,
        lr=args.lr,
        epochs=args.epochs,
        batch_size=args.batch_size,
        min_epochs=args.min_epochs,
        patience=args.patience,
        seed=args.seed,
        clip_sentinels=not raw,
        normalize_gap=not raw,
        supervise_duals=not raw,
    )
    init_params = None
    if args.init_checkpoint:
        init_params, _, _ = load_checkpoint(args.init_checkpoint)
        print(f"warm init from {args.init_checkpoint}")

    params, history = train_dual_gnn(
        train_insts, val_insts, cfg, init_params=init_params, device=args.device
    )
    save_checkpoint(args.output, params, checkpoint_meta(args, history))
    print(f"saved checkpoint to {args.output}")


def checkpoint_meta(args, history) -> dict:
    """The JAX CLI's meta: the model's shape, the features' widths and the
    training history."""
    return {
        "architecture": "dual_gnn",
        "hidden": args.hidden,
        "layers": args.layers,
        "heads": args.heads,
        "dropout": args.dropout,
        "node_feat_dim": 14,
        "edge_feat_dim": 10,
        "history": history,
    }


if __name__ == "__main__":
    main()
