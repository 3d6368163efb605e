"""DualGNN training CLI: train on HDF5 splits and save a checkpoint.

Port of ``lapgnn_tpu/cli/train_dual_gnn.py``, with ``--device`` (default
``cuda``; ``cpu`` trains on the CPU).  The checkpoint carries the JAX CLI's
meta keys, so either package loads it.  Needs ``h5py``.

``--mesh-2d ROWxCOL`` (or ``auto``) trains over the 2-D edge-partitioned
mesh of ``parallel.dual`` across the job's ranks: start one process a GPU
with torchrun, which sets the variables ``parallel.initialize_distributed``
reads; a process started alone is a job of one rank.  Only rank 0 writes
the checkpoint.

Example:
  python -m lapgnn_tpu_torch.cli.train_dual_gnn --train data/mid512/train.h5 \
      --val data/mid512/val.h5 --epochs 10 --output artifacts/dual_gnn
  torchrun --nproc-per-node 4 -m lapgnn_tpu_torch.cli.train_dual_gnn \
      --train data/mid512/train.h5 --mesh-2d auto --output artifacts/dual_gnn
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
        help="train over a 2-D edge-partitioned mesh of the job's ranks, e.g. '2x2' "
             "(or 'auto' for the squarest factorisation): every (B, n, n, hidden) edge "
             "tensor is tiled across the ranks (parallel/dual.py)",
    )
    p.add_argument("--output", type=Path, required=True)
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
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
    import torch.distributed as dist

    mesh = None
    if args.mesh_2d:
        mesh = build_mesh(args.mesh_2d, args.device)
        print(f"2-D edge-partitioned training on mesh {mesh.shape}")

    init_params = None
    if args.init_checkpoint:
        init_params, _, _ = load_checkpoint(args.init_checkpoint)
        print(f"warm init from {args.init_checkpoint}")

    params, history = train_dual_gnn(
        train_insts, val_insts, cfg, mesh=mesh, init_params=init_params, device=args.device
    )
    if mesh is None or not dist.is_initialized() or dist.get_rank() == 0:
        save_checkpoint(args.output, params, checkpoint_meta(args, history))
        print(f"saved checkpoint to {args.output}")


def build_mesh(spec: str, device: str):
    """The ('row', 'col') mesh of ``--mesh-2d``: 'auto' or 'ROWxCOL', over
    the ranks of the job (torchrun's, or this process alone)."""
    import datetime

    import torch.distributed as dist

    from ..parallel import dual_mesh, initialize_distributed
    from ..parallel.launch import free_port

    if not dist.is_initialized() and not initialize_distributed(device=device):
        dist.init_process_group(
            "nccl" if device.startswith("cuda") else "gloo",
            init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=120),
        )
    if spec == "auto":
        return dual_mesh(device=device)
    row, _, col = spec.partition("x")
    return dual_mesh(row=int(row), col=int(col), device=device)


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
