"""Read the compared numbers of a cell over many seeds in one process: the
program's own (sound runs, the lower readings) or, with ``--engine
control_bf16``, the control's (the upper readings). Each seed is a whole
run of the cell (rows, build, warm-up, a window of ``--seconds``, the
comparison); one JSON line a seed.

    python3 -m benchmark.tools.readings --workload deep10m-ivf_flat.batch \\
        --engine control_bf16 --seconds 2 --seeds 11 12 13
"""

from __future__ import annotations

import argparse
import json

import torch

from benchmark import run
from benchmark.spec import Bench


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--engine", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = Bench()
    for seed in args.seeds:
        out = run.run_cell(bench, args.workload, seed=seed, seconds=args.seconds,
                           trace_on=False, device=torch.device(args.device),
                           engine_name=args.engine)
        print(json.dumps({"workload": args.workload, "engine": args.engine or "program",
                          "seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"], "failed": out["failed"],
                          "checks": out["checks"],
                          "recall_at_10": out["metrics"].get("recall_at_10")}), flush=True)


if __name__ == "__main__":
    main()
