"""Start the ranks of a one-machine job as spawned processes.

``spawn_ranks(fn, world, ...)`` runs ``fn(rank, *args)`` in ``world``
spawned processes, each with the default process group joined first (gloo
or NCCL, a file or TCP rendezvous, a timeout on every collective) and left
after; it waits for them with a deadline, kills them all when it passes,
and raises if any process failed.  ``fn`` must be importable by name (a
module-level function).  The scaling CLI and the tests start their ranks
this way; a multi-host job starts them with torchrun and
``hostmesh.initialize_distributed`` instead.
"""

from __future__ import annotations

import datetime
import socket
import time
from typing import Callable, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import DEFAULT_TIMEOUT_S

__all__ = ["free_port", "spawn_ranks"]


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world, backend, init_method, pg_timeout, args):
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=pg_timeout),
    )
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(
    fn: Callable,
    world: int,
    args: Sequence = (),
    backend: str = "gloo",
    init_method: str = "",
    timeout: float = 600.0,
    pg_timeout: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Run ``fn(rank, *args)`` on ``world`` ranks; ``init_method`` defaults
    to a TCP store on a free local port.  Raises ``TimeoutError`` when the
    ranks are not all done within ``timeout`` seconds (after killing them),
    and ``torch.multiprocessing``'s ``ProcessRaisedException`` /
    ``ProcessExitedException`` when one fails."""
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, backend, init_method, pg_timeout, tuple(args)),
        nprocs=world, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world} ranks did not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)
