"""Edges/s of the row-sharded predict over mesh sizes, and the column-pass
kernels' bandwidth.

Port of ``lapgnn_tpu/cli/scaling_benchmark.py``, with its flags and JSON keys,
plus ``--device`` (default ``cuda``; ``cpu`` runs on the CPU).  For each
``--meshes m`` it spawns m ranks (NCCL, one card a rank, on CUDA; gloo on the
CPU), runs ``parallel.make_sharded_predict`` of a random OneGNN (hidden 64,
2 layers) with the batch's rows split over the m ranks, and reports edges/s
(n^2 cost entries an instance over the slowest rank's time) and the scaling
efficiency against the first mesh measured.  A mesh larger than the cards
(or, on the CPU, the cores) or not dividing n is skipped with a ``# skip``
line.

The roofline block times, on one device at each ``--roofline-n``, the
min-trick trio in interleaved rounds: ``min_trick_xla`` is the plain
PyTorch version (``ops.cuda.colmin.min_trick_plain``), ``min_trick_pallas``
the hand-written kernel K2 (``ops.cuda.min_trick``), ``min_trick_routed``
the predict path's ``ops.dual.fast_min_trick``; then the sort-based
``row_features`` and, on a GPU, K3 through ``fast_row_features``
(``row_features_pallas_*``); with ``--solve``, the warm seeded solve of a
planted instance.  GB/s counts one read of C; ``*_roofline_pct`` is that
against ``--hbm-peak-gbs`` (3350 GB/s, an H100 SXM's).

Times on CUDA are CUDA events around a run of calls, the kernels' runs
queued behind a spin of the card so that the host's launch latency stays
out; the JAX CLI's burst and fold differencing cancel a remote round trip
that a local card does not have.  On the CPU they are host-clock times.

  python -m lapgnn_tpu_torch.cli.scaling_benchmark --meshes 1 --n 2048 --solve
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--meshes", type=int, nargs="+", default=[1, 2, 4, 8],
                   help="number of ranks along the 'model' (row) axis")
    p.add_argument("--n", type=int, default=1024)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--hbm-peak-gbs", type=float, default=3350.0,
                   help="device memory peak bandwidth for roofline %% (3350 GB/s = H100 SXM)")
    p.add_argument("--roofline-n", type=int, nargs="+", default=[2048, 8192],
                   help="matrix sizes for the single-device kernel roofline")
    p.add_argument("--solve", action="store_true",
                   help="also measure full warm-solve edges/s (slower)")
    p.add_argument("--output", type=str, default=None,
                   help="write the JSON result to this path")
    p.add_argument("--device", default="cuda", help="torch device: cuda (default) or cpu")
    return p


# Cycles the card spins before a run of kernel calls (about 10 ms on an
# H100), long enough for the host to queue the whole run behind it.
_SPIN_CYCLES = 20_000_000


def _timed_ms(torch, fn, device, inner=1, queued=False) -> float:
    """Milliseconds a call of ``fn`` over ``inner`` calls: CUDA events on a
    GPU, the host clock (the calls end in their results) on the CPU.
    ``queued``: the card first spins while the host queues the calls, so
    their launch latency stays out of the window (kernels with no host
    sync only)."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(_SPIN_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / inner
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    return (time.perf_counter() - t0) * 1e3 / inner


def _batch(n, B):
    import numpy as np

    from ..data.generators import generate_uniform_costs

    return np.stack([generate_uniform_costs(n, seed=k) for k in range(B)]).astype(np.float32)


def _mesh_rank(rank, m, n, B, repeats, device_type, out):
    """One rank of the sharded predict at mesh model=m; rank 0 writes the
    slowest rank's ms of each repeat to ``out``."""
    import torch

    from ..models import OneGNN
    from ..parallel import local_rows, make_mesh, make_sharded_predict
    from ..parallel.collectives import all_reduce_max

    if device_type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // m))
    mesh = make_mesh(data=1, model=m, device=device_type)
    torch.manual_seed(0)
    model = OneGNN(hidden=64, layers=2).to(mesh.device).eval()
    predict = make_sharded_predict(model, mesh)
    C = local_rows(torch.from_numpy(_batch(n, B)), mesh).to(mesh.device)
    predict(C)  # warm-up: the kernels build at their first call
    ms = []
    for _ in range(repeats):
        all_reduce_max(torch.zeros(1, device=mesh.device), mesh.group("model"))  # line up
        ms.append(_timed_ms(torch, lambda: predict(C), mesh.device))
    slowest = all_reduce_max(torch.tensor(ms, device=mesh.device), mesh.group("model"))
    if rank == 0:
        Path(out).write_text(json.dumps(slowest.tolist()))


def _mesh_times(m, n, B, repeats, device_type):
    from ..parallel.launch import spawn_ranks

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "ms.json"
        spawn_ranks(_mesh_rank, m, args=(m, n, B, repeats, device_type, str(out)),
                    backend="nccl" if device_type == "cuda" else "gloo")
        return json.loads(out.read_text())


def _finish(samples):
    """Median of a kernel's samples (ms); None when it was not measured."""
    return statistics.median(samples) if samples else None


def _kernel_times(torch, named_fns, repeats, device, bytes_read):
    """Median ms a call of each function, sampled in interleaved rounds with
    the order rotated each round, so that every function meets the same load
    (the JAX CLI's ``_kernel_time_group``).  Each sample is a run of calls
    sized to about 2 GB of reads (one call at least, 100 at most), queued
    behind a spin of the card, and no longer than the host can queue in
    about 8 ms (its time to issue one call, measured here)."""
    inner = {}
    for k, fn in named_fns.items():
        fn()
        t0 = time.perf_counter()
        fn()
        issue_s = max(time.perf_counter() - t0, 1e-6)
        inner[k] = 1 if device.type != "cuda" else max(1, min(100, int(2e9 // bytes_read),
                                                              int(0.008 / issue_s)))
    keys = list(named_fns)
    samples = {k: [] for k in keys}
    for r in range(repeats):
        for k in keys[r % len(keys):] + keys[: r % len(keys)]:
            samples[k].append(_timed_ms(torch, named_fns[k], device, inner[k], queued=True))
    return {k: _finish(v) for k, v in samples.items()}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from ..device import resolve_device
    from ..ops.cuda.colmin import min_trick, min_trick_plain
    from ..ops.dual import fast_min_trick
    from ..ops.features import fast_row_features, row_features

    device = resolve_device(args.device)
    n, B = args.n, args.batch
    edges = B * n * n

    results = {}
    base_rate = None
    base_m = None
    n_dev = torch.cuda.device_count() if device.type == "cuda" else (os.cpu_count() or 1)
    for m in args.meshes:
        if m > n_dev or n % m != 0:
            print(f"# skip mesh model={m} (devices={n_dev}, n%m={n % m})")
            continue
        ts = _mesh_times(m, n, B, args.repeats, device.type)
        t = min(ts) / 1e3
        rate = edges / t
        if base_rate is None:
            base_rate, base_m = rate, m
        # speedup per added rank against the FIRST measured mesh
        eff = (rate / base_rate) / (m / base_m)
        results[m] = {
            "edges_per_s": rate,
            "scaling_efficiency": round(eff, 4),
            "time_ms": round(t * 1e3, 2),
        }
        print(f"mesh model={m}: {rate/1e9:.3f} Gedges/s efficiency={eff:.2%}")

    def pct(t, bytes_read):
        return None if t is None else round(100 * bytes_read / (t * 1e-3) / 1e9 / args.hbm_peak_gbs, 1)

    def gbs(t, bytes_read):
        return None if t is None else round(bytes_read / (t * 1e-3) / 1e9, 2)

    roofline = {}
    for nr in args.roofline_n:
        rngk = np.random.default_rng(7)
        C1 = torch.from_numpy(rngk.uniform(0, 1, (nr, nr)).astype(np.float32)).to(device)
        u1 = torch.zeros((nr,), dtype=torch.float32, device=device)
        bytes_read = nr * nr * 4
        t_ceil = _kernel_times(torch, {"amin": lambda: torch.amin(C1, dim=0)}, args.repeats,
                               device, bytes_read)["amin"]
        trio = _kernel_times(torch, {
            "xla": lambda: min_trick_plain(C1, u1),
            "pallas": lambda: min_trick(C1, u1),
            "routed": lambda: fast_min_trick(C1, u1),
        }, args.repeats, device, bytes_read)
        t_xla, t_pls, t_routed = trio["xla"], trio["pallas"], trio["routed"]
        t_feat = _kernel_times(torch, {"f": lambda: row_features(C1[None])}, args.repeats,
                               device, bytes_read * 8)["f"]
        entry = {
            "stream_reduce_selfcheck_gb_s": gbs(t_ceil, bytes_read),
            "min_trick_xla_gb_s": gbs(t_xla, bytes_read),
            "min_trick_xla_roofline_pct": pct(t_xla, bytes_read),
            "min_trick_pallas_gb_s": gbs(t_pls, bytes_read),
            "min_trick_pallas_roofline_pct": pct(t_pls, bytes_read),
            "min_trick_routed_gb_s": gbs(t_routed, bytes_read),
            "min_trick_routed_roofline_pct": pct(t_routed, bytes_read),
            # the routed path within 5% of the better of the two it routes
            # between (when it picks the kernel they are one program)
            "min_trick_route_ok": (
                None if None in (t_routed, t_xla, t_pls)
                else bool(t_routed <= 1.05 * min(t_xla, t_pls))
            ),
            "row_features_gb_s": gbs(t_feat, bytes_read),
            "row_features_edges_per_s": None if t_feat is None else round(nr * nr / (t_feat * 1e-3)),
        }
        if device.type == "cuda":
            t_k3 = _kernel_times(torch, {"k3": lambda: fast_row_features(C1[None])},
                                 args.repeats, device, bytes_read)["k3"]
            entry["row_features_pallas_gb_s"] = gbs(t_k3, bytes_read)
            entry["row_features_pallas_edges_per_s"] = round(nr * nr / (t_k3 * 1e-3))
        if args.solve:
            from ..data.generators import generate_planted_optimum_instance
            from ..solver.seeded import lapjv_seeded_single

            Cp_np, u_sn, _, _ = generate_planted_optimum_instance(
                nr, seed=7, noise=3e-3, dtype=np.float32
            )
            Cp = torch.from_numpy(Cp_np).to(device)
            u_s = torch.from_numpy(u_sn).to(device)
            v_s = (Cp - u_s[:, None]).amin(0)
            solve = lambda: lapjv_seeded_single(Cp, u_s, v_s, gate="both")  # noqa: E731
            solve()
            t_solve = statistics.median(
                _timed_ms(torch, solve, device) for _ in range(args.repeats))
            entry["warm_solve_ms"] = round(t_solve, 2)
            entry["warm_solve_edges_per_s"] = round(nr * nr / (t_solve * 1e-3))
        roofline[nr] = entry
        print(f"n={nr}: {json.dumps(entry)}")

    out = {
        "backend": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "hbm_peak_gbs": args.hbm_peak_gbs,
        "pipeline_edges_per_s_per_mesh": results,
        "roofline": roofline,
    }
    line = json.dumps(out)
    print(line)
    if args.output:
        Path(args.output).parent.mkdir(parents=True, exist_ok=True)
        Path(args.output).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
