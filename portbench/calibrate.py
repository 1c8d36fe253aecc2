"""Readings that set a cell's limits, on the card: the program's numbers
compared over many seeds, the control's (the reference in float8 in the
program's place) and planted faults', each run as the benchmark runs it
(set-up, a short window, the check). One process for all seeds.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control 1] [--fault half_batch] [--seconds 5]

Prints one JSON line a seed. Not part of a benchmark run."""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import faults  # noqa: E402
from portbench.run import _environment, run_cell  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", default=None, choices=sorted(faults.FAULTS))
    args = ap.parse_args()
    _environment()
    import torch

    from portbench.bench import load_benchmark

    bench = load_benchmark()
    extra = {"control": bool(args.control)}
    if args.fault:
        extra.update(faults.FAULTS[args.fault])
    for seed in map(int, args.seeds.split(",")):
        out = run_cell(bench, args.workload, seed, args.seconds, False,
                       torch.device("cuda", 0), **extra)
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": out["correct"],
                          "checks": out["checks"], "detail": out["_detail"],
                          "metrics": out["metrics"]}), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
