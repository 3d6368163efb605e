#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's sound runs, the control
and the planted faults, on the card at the cell's own size.

    python3 lapbench/control.py --workload <name> --seeds 1,2,3 \
        --variants program,control --seconds 10 --out chiprun_out/readings.jsonl

Each (variant, seed) is one run of ``run.run_once`` in this process, so the
program's libraries load once.  ``program`` is the run as the benchmark
makes it; ``control`` and the faults are the entry's variants (see each
``lapbench/entries/<entry>.py``).  One JSON line a run goes to ``--out``:
the variant, the seed, ``correct`` and every number compared beside its
limit.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--variants", default="program", help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    run._pin_caches(run.ROOT)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for variant in args.variants.split(","):
            for seed in (int(s) for s in args.seeds.split(",")):
                t0 = time.perf_counter()
                readings = {}

                def log(msg, readings=readings):
                    print(msg, file=sys.stderr, flush=True)
                    if msg.startswith("readings "):
                        readings.update(json.loads(msg[len("readings "):]))

                res = run.run_once(args.workload, seed, args.seconds, False, log=log,
                                   variant=None if variant == "program" else variant)
                line = {"workload": args.workload, "variant": variant, "seed": seed,
                        "correct": res["correct"], "checks": res["checks"], "readings": readings,
                        "metrics": res["metrics"], "seconds": time.perf_counter() - t0}
                f.write(json.dumps(line) + "\n")
                f.flush()
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
