"""Benchmark experiment logging: CSV + JSON + text + environment capture.

Port of ``lapgnn_tpu/bench/logging_system.py``: each experiment gets a
directory tree ``logs/{experiments,performance,detailed,summaries}`` with a
JSON experiment dump, CSV timing rows, a human-readable detail log, a
summary file, and a snapshot of the environment (package versions, thread
pinning variables, platform).  The environment names torch, its CUDA
version and the GPU where the JAX package's names jax, flax and optax.
"""

from __future__ import annotations

import csv
import json
import os
import platform
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional

__all__ = ["BenchmarkLogger"]

CSV_HEADER = [
    "timestamp",
    "experiment",
    "solver",
    "family",
    "n",
    "median_s",
    "mean_s",
    "std_s",
    "min_s",
    "max_s",
    "cost",
    "speedup_vs_baseline",
    "notes",
]

_ENV_KEYS = [
    "OMP_NUM_THREADS",
    "MKL_NUM_THREADS",
    "OPENBLAS_NUM_THREADS",
    "NUMEXPR_NUM_THREADS",
    "CUDA_VISIBLE_DEVICES",
    "PYTORCH_CUDA_ALLOC_CONF",
]


def _capture_env() -> Dict[str, Any]:
    import importlib.metadata as _md

    import torch

    env = {k: os.environ.get(k) for k in _ENV_KEYS}
    versions: Dict[str, str] = {"python": platform.python_version()}
    for mod in ("numpy", "scipy"):
        try:
            versions[mod] = _md.version(mod)
        except Exception:
            versions[mod] = "unavailable"
    versions["torch"] = torch.__version__
    versions["cuda"] = torch.version.cuda or "unavailable"
    return {
        "platform": platform.platform(),
        "processor": platform.processor(),
        "env": env,
        "versions": versions,
        "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
    }


class BenchmarkLogger:
    def __init__(self, experiment: str, root: str | Path = "logs"):
        self.experiment = experiment
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        self.exp_id = f"{experiment}_{stamp}"
        self.root = Path(root)
        for sub in ("experiments", "performance", "detailed", "summaries"):
            (self.root / sub).mkdir(parents=True, exist_ok=True)
        self._rows: List[Dict[str, Any]] = []
        self._detail_path = self.root / "detailed" / f"{self.exp_id}.log"
        self._csv_path = self.root / "performance" / f"{self.exp_id}.csv"
        self._meta: Dict[str, Any] = {
            "experiment": experiment,
            "id": self.exp_id,
            "started": datetime.now().isoformat(),
            "environment": _capture_env(),
        }
        self.detail(f"experiment {self.exp_id} started")

    def detail(self, message: str) -> None:
        with self._detail_path.open("a") as f:
            f.write(f"[{datetime.now().isoformat(timespec='seconds')}] {message}\n")

    def log_result(
        self,
        solver: str,
        family: str,
        n: int,
        stats: Dict[str, Any],
        cost: Optional[float] = None,
        speedup: Optional[float] = None,
        notes: str = "",
    ) -> None:
        row = {
            "timestamp": datetime.now().isoformat(timespec="seconds"),
            "experiment": self.experiment,
            "solver": solver,
            "family": family,
            "n": n,
            "median_s": stats.get("median"),
            "mean_s": stats.get("mean"),
            "std_s": stats.get("std"),
            "min_s": stats.get("min"),
            "max_s": stats.get("max"),
            "cost": cost,
            "speedup_vs_baseline": speedup,
            "notes": notes,
        }
        self._rows.append(row)
        new_file = not self._csv_path.exists()
        with self._csv_path.open("a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=CSV_HEADER)
            if new_file:
                w.writeheader()
            w.writerow(row)
        self.detail(
            f"{solver} {family} n={n} median={row['median_s']} speedup={speedup}"
        )

    def log_comparison(
        self, baseline_solver: str, family: str, n: int
    ) -> Dict[str, float]:
        """Speedups of every logged solver against a baseline solver for
        (family, n)."""
        base = [
            r
            for r in self._rows
            if r["solver"] == baseline_solver and r["family"] == family and r["n"] == n
        ]
        if not base:
            return {}
        base_t = base[-1]["median_s"]
        if not base_t:  # failed/zero baseline measurement: no valid ratios
            return {}
        out = {}
        for r in self._rows:
            if r["family"] == family and r["n"] == n and r["median_s"]:
                out[r["solver"]] = base_t / r["median_s"]
        return out

    def finalize(self, summary: Optional[Dict[str, Any]] = None) -> Path:
        self._meta["finished"] = datetime.now().isoformat()
        self._meta["num_rows"] = len(self._rows)
        self._meta["rows"] = self._rows
        if summary:
            self._meta["summary"] = summary
        exp_path = self.root / "experiments" / f"{self.exp_id}.json"
        exp_path.write_text(json.dumps(self._meta, indent=2, default=str))
        if summary:
            lines = [f"{self.exp_id}", "=" * 40]
            lines += [f"{k}: {v}" for k, v in summary.items()]
            (self.root / "summaries" / f"{self.exp_id}.txt").write_text(
                "\n".join(lines) + "\n"
            )
        self.detail("experiment finalized")
        return exp_path

    # -- retrieval helpers ---------------------------------------------------

    @staticmethod
    def list_experiments(root: str | Path = "logs") -> List[str]:
        d = Path(root) / "experiments"
        if not d.exists():
            return []
        return sorted(p.stem for p in d.glob("*.json"))

    @staticmethod
    def load_experiment(exp_id: str, root: str | Path = "logs") -> Dict[str, Any]:
        return json.loads((Path(root) / "experiments" / f"{exp_id}.json").read_text())

    @staticmethod
    def get_latest_experiment(root: str | Path = "logs") -> Optional[Dict[str, Any]]:
        # by mtime, not by id: ids start with the experiment's name, so
        # sorted() would return an older 'main_benchmark_...' over a newer
        # 'gnn_benchmark_...'
        d = Path(root) / "experiments"
        files = sorted(d.glob("*.json"), key=lambda p: p.stat().st_mtime) if d.exists() else []
        return BenchmarkLogger.load_experiment(files[-1].stem, root) if files else None
