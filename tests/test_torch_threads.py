"""The repository's root ``conftest.py``: an xdist worker runs torch on its
share of the host's cores, so that workers' OpenMP threads do not
oversubscribe the host; a run without xdist keeps torch's default."""

import os
import subprocess
import sys

import torch


def test_torch_runs_on_this_worker_s_share_of_the_cores():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is not None:
        share = max(1, len(os.sched_getaffinity(0)) // int(workers))
    else:  # torch's default, as a fresh interpreter has it
        share = int(subprocess.run(
            [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
            capture_output=True, text=True, check=True).stdout)
    assert torch.get_num_threads() == share
