"""The readings that the limits of a cell's checks are set from, on the card:
the numbers the check computes for the program on many seeds, and for the
control (the reference in the nearest lower precision, TF32, in the
program's place) on a few, in one process at the cell's own size.

    python3 cfbench/tools/readings.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 --seconds 2 [--out FILE]

Each line printed (and appended to FILE) is one run's JSON: the cell, the
seed, whether it was the control, every number the check computed and the
result's metrics.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from cfbench.lib import harness  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("readings: needs a CUDA card")
    spec = harness.Spec(ROOT)
    device = torch.device("cuda", 0)
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        details = {}
        t0 = time.perf_counter()
        res = harness.run_cell(spec, args.workload, seed, args.seconds, False, device,
                               time.perf_counter(), control=control, details=details)
        line = json.dumps(dict(cell=args.workload, seed=seed, control=control,
                               numbers=details["numbers"], correct=res["correct"],
                               metrics={k: v["value"] for k, v in res["metrics"].items()},
                               seconds=time.perf_counter() - t0))
        print(line, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
