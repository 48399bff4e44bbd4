"""Sweep the Gaussian mixture's centres and spread for a configuration:
for each setting, make the rows and queries at full size, build the index
through the configuration's engine, and print recall@k of a query sample
at several probe counts against the plain reference, with the list sizes
and the build time. The configuration's ``data`` was chosen from one such
sweep on the card (PERF.md).

    python3 -m benchmark.tools.sweep_data --config deep10m-ivf_flat \\
        --mix 64:2 128:2 --probes 8 16 32 64 --queries 2000
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import torch

from benchmark import data, judge
from benchmark.reference import exact
from benchmark.spec import Bench


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="deep10m-ivf_flat")
    ap.add_argument("--mix", nargs="+", required=True, help="centres:spread ...")
    ap.add_argument("--probes", type=int, nargs="+", default=[8, 16, 32, 64])
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    bench = Bench()
    base = bench.config(args.config)
    engine = bench.engine(base["engine"])
    for m in args.mix:
        c, s = m.split(":")
        cfg = copy.deepcopy(base)
        cfg["data"].update(n_centres=int(c), centre_spread=float(s))
        x, q = data.make(cfg, args.seed, dev)
        q = q[:args.queries]
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        index = engine.build(x, cfg, args.seed, dev)
        sync()
        build_s = time.perf_counter() - t0
        sizes = index.storage.list_sizes.float()
        _, true_ids = exact.topk(x, q, int(cfg["k"]))
        row = {"centres": int(c), "spread": float(s), "build_s": round(build_s, 3),
               "lists": int(sizes.numel()), "max_list": int(sizes.max()),
               "list_cv": round(float(sizes.std() / sizes.mean()), 4)}
        qidx = torch.arange(q.shape[0])
        for p in args.probes:
            cfg["search"]["n_probes"] = p
            _, ids = engine.search_fn(index, cfg, q.shape[0])(q)
            row[f"recall@{p}"] = round(judge.recall_hits(true_ids, qidx, ids)
                                       / (q.shape[0] * int(cfg["k"])), 4)
        print(json.dumps(row), flush=True)
        del index, x, q, true_ids
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
