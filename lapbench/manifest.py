"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, one traffic mix or one metric
is a file of its own, found by the name the manifest gives it:

  * a configuration: the file its ``configs`` entry names (JSON);
  * a traffic mix: ``lapbench/traffic/<traffic>.json``, whose ``entry``
    names the driver of the window, ``lapbench/entries/<entry>.py``;
  * a metric, end-to-end or per-layer: ``lapbench/metrics/<name>.py``, a
    reader with ``read(rec) -> float | None``.

A later change adds a cell, a mix or a metric as new files and entries; no
file here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

__all__ = ["Cell", "load_module"]


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file by its path (metric names hold dots, so they cannot be
    imported by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of the manifest with its configuration, traffic, entry
    and the metrics it reports."""

    def __init__(self, root: Path, workload: str):
        self.root = Path(root)
        here = self.root / "lapbench"
        manifest = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = cells[workload]
        self.run_seconds = int(manifest["run_seconds"])
        configs = {c["name"]: c for c in manifest["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = json.loads((self.root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (here / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.entry = load_module(here / "entries" / f"{self.traffic['entry']}.py",
                                 f"lapbench_entry_{self.traffic['entry']}")
        self.end_to_end = [m for m in manifest["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in manifest["per_layer"] if self._reports(m)]

    def _reports(self, metric: Dict) -> bool:
        return "workloads" not in metric or self.workload["name"] in metric["workloads"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    def readers(self, trace: bool) -> List:
        """(metric entry, reader module) of the metrics this run prints."""
        metrics = self.per_layer if trace else self.end_to_end
        here = self.root / "lapbench"
        return [(m, load_module(here / "metrics" / f"{m['name']}.py",
                                "lapbench_metric_" + m["name"].replace(".", "_")))
                for m in metrics]
