#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 lapbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run builds the cell's inputs from the
seed, loads and warms up the program (the PyTorch and CUDA port
``lapgnn_tpu_torch``), measures for ``--seconds``, holds what the window
produced to the plain reference, and prints one JSON line as the last line
of its standard output: ``correct``, ``attempted``, ``failed``, the
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones, each from the reader ``lapbench/metrics/<name>.py``), the
``device``, with ``--trace 1`` the ``breakdown``, and last the ``checks``:
each number compared with its limit.  The same numbers end its standard
error.  Everything else (the card, its power limit and clocks, loop counts,
peak memory) goes to standard error first.

The run fails, and prints no result, without a CUDA device (or with fewer
than the cell asks for), outside a checkout that holds the program, and when
a JAX module (``jax``, ``jaxlib``, ``flax`` or the JAX package
``lapgnn_tpu``) was loaded once the window has closed.
"""

import os
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


class RunError(RuntimeError):
    """A run that must print no result."""


class Ctx:
    """What an entry sees of the run."""

    def __init__(self, root, cell, seed, seconds, trace, device, variant, log):
        self.root = Path(root)
        self.config, self.traffic = cell.config, cell.traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.variant, self.log = device, variant, log
        self.spans = None


def _pin_caches(root: Path) -> None:
    """Every compiler cache at a fixed path inside the checkout (the port
    builds its libraries into ``build/`` there by itself)."""
    cache = root / "build" / "caches"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _nvidia_smi() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return res.stdout.strip().replace("\n", " | ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def _finite(x: float):
    return x if math.isfinite(x) else ("inf" if x > 0 else "nan")


def run_once(workload: str, seed: int, seconds: float, trace: bool, root: Path = ROOT,
             variant: Optional[str] = None, device: Optional[str] = None,
             log: Callable[[str], None] = None, t_start: Optional[float] = None) -> Dict:
    """One run of a cell; returns the result's dict.  ``variant`` (the
    control or a planted fault) and ``device`` (the CPU, for the tests) are
    never set by a benchmark run."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    root = Path(root)
    sys.path.insert(0, str(root))
    from lapbench import manifest, trace as tracing

    cell = manifest.Cell(root, workload)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark runs only on the card")
        if torch.cuda.device_count() < cell.chips:
            raise RunError(f"{torch.cuda.device_count()} CUDA devices, the cell needs {cell.chips}")
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(device)
    if not (root / "lapgnn_tpu_torch" / "__init__.py").exists():
        raise RunError(f"no program (lapgnn_tpu_torch) in {root}")
    if dev.type == "cuda":
        log(f"device: {torch.cuda.get_device_name(0)}; count {torch.cuda.device_count()}; "
            f"torch {torch.__version__} CUDA {torch.version.cuda}; nvidia-smi: {_nvidia_smi()}")
    seed = int(seed) & (2**63 - 1)
    ctx = Ctx(root, cell, seed, float(seconds), trace, dev, variant, log)
    entry = cell.entry

    state = entry.setup(ctx)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s!r}")

    device_trace = None
    if trace:
        ctx.spans = tracing.Spans(dev)
        if dev.type == "cuda":
            device_trace = tracing.DeviceTrace()
    if device_trace is not None:
        with device_trace:
            rec = entry.window(state, ctx)
    else:
        rec = entry.window(state, ctx)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    rec["setup_s"] = setup_s
    rec["config"], rec["traffic"] = cell.config, cell.traffic
    if ctx.spans is not None:
        rec["spans"] = ctx.spans.device_ms()
    if device_trace is not None:
        rec["trace"] = device_trace.summary()
    log(f"window_s {rec['window_s']!r}; instances {rec.get('instances', rec.get('samples'))}; "
        f"memory_peak_bytes {peak}; counts {json.dumps(rec.get('counts', {}))}")
    if dev.type == "cuda":
        log(f"nvidia-smi after the window: {_nvidia_smi()}")

    t_check = time.perf_counter()
    checks, failed = entry.check(state, rec, ctx)
    del state
    log(f"check_s {time.perf_counter() - t_check!r} (the reference and the comparison)")
    metrics = {}
    for metric, reader in cell.readers(trace):
        value = reader.read(rec)
        if value is not None:
            metrics[metric["name"]] = {"value": _finite(float(value)), "unit": metric["unit"]}
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)
    result = {
        "correct": bool(correct),
        "attempted": int(rec["attempted"]),
        "failed": int(failed),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else dev.type,
            "count": cell.chips,
            "memory_peak_bytes": int(peak),
        },
    }
    if device_trace is not None:
        t = rec["trace"]
        result["device"]["busy_s"] = t["busy_s"]
        result["device"]["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
        log("kernels (name: launches, seconds): " + json.dumps(
            {k[:100]: v for k, v in sorted(t["kernels"].items(), key=lambda kv: -kv[1][1])[:25]}))
    if ctx.spans is not None:
        log("spans (name: calls, mean ms): " + json.dumps(
            {k: [len(v), sum(v) / len(v)] for k, v in rec["spans"].items() if v}))
    result["checks"] = {name: {"value": _finite(v), "limit": lim} for name, v, lim in checks}
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _pin_caches(ROOT)
    try:
        result = run_once(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=T_START)
    except RunError as exc:
        print(f"lapbench: {exc}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from lapbench.yardstick import banned_modules

    banned = banned_modules(sys.modules)
    if banned:
        print("lapbench: JAX modules were loaded: " + ", ".join(banned), file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
