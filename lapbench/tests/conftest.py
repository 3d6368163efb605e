"""The benchmark's CPU tests: ``python -m pytest lapbench/tests -q`` from the
root of the repository.  Tests marked ``cuda`` need the card and skip
without one."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# tiny sizes of each traffic mix, for runs on the CPU
TINY = {
    "solve-2048-closed": {"n": 40},
    "train-4x512": {"n": 24, "pool": 8},
}


def make_checkout(dest: Path, tiny: bool = True) -> Path:
    """A checkout of the benchmark at ``dest``: ``BENCHMARK.json`` and
    ``lapbench/`` copied, the program and its artifacts linked; with
    ``tiny`` the traffic mixes cut to CPU sizes."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "lapbench", dest / "lapbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for name in ("lapgnn_tpu_torch", "artifacts"):
        (dest / name).symlink_to(ROOT / name)
    if tiny:
        for mix, sizes in TINY.items():
            path = dest / "lapbench" / "traffic" / f"{mix}.json"
            data = json.loads(path.read_text())
            data.update(sizes)
            path.write_text(json.dumps(data))
    return dest


@pytest.fixture
def checkout(tmp_path):
    return make_checkout(tmp_path / "checkout")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the card)")
    return torch.device("cuda", 0)
