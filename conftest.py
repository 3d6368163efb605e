"""Each xdist worker runs torch on its share of the host's cores.

torch starts one OpenMP thread a core in every process, and those threads
spin while they wait for work: six workers on eight cores would keep 48
threads spinning, and the tests would mostly wait for a core.  A worker
takes cores // workers threads (at least one); a run without xdist keeps
torch's default.  XLA's threads are left as they are.
"""

import os

if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    import torch

    torch.set_num_threads(
        max(1, len(os.sched_getaffinity(0)) // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))
