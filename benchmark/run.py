"""Run one cell of ``BENCHMARK.json``: one process, one run.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. In order: make the cell's rows and queries
on the device from the seed; build the index through the engine
adapter (timed, device synchronised); warm the cell's own batch shapes;
run a short unmeasured stretch of its traffic; measure for ``--seconds``;
free the program's state; compare every answer of the window with the
plain reference; print the result as the last line of standard output,
after the compared numbers and their limits on standard error.
``--trace 1`` also captures the end of the window with ``torch.profiler``
and reports the per-layer metrics instead of the end-to-end ones.

Without a CUDA card (or with fewer than the cell asks for), or with JAX
or the JAX package loaded once the window has closed, it prints no result
and exits non-zero. The port's CUDA kernels are built once into the
checkout's ``build/raft_tpu_torch/<hash>/`` (the port's fixed build
cache) and loaded from there by later runs.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# Kineto tears CUPTI down after each capture only with this set, and it
# has to hold from the process's first capture on (the port's
# core/annotate.py sets it the same way when imported)
os.environ.setdefault("TEARDOWN_CUPTI", "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "raft_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is, as a
    whole, JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Run:
    """What one run gathered, for the metric readers (``metrics/*.py``)."""

    def __init__(self, cell, cfg, mix, device, seed):
        self.cell, self.cfg, self.mix, self.device, self.seed = cell, cfg, mix, device, seed
        self.setup_s = self.build_s = None
        self.window = None
        self.queries_answered = 0     # in the window (for qps)
        self.attempted = 0            # queries, the capture's too
        self.recall = None
        self.trace = None             # tracing.Trace
        self.capture = None           # its summary, or None
        self.yardstick = None         # the engine's scan shape for the counts
        self.batch_queries = None     # a closed loop's batches
        self.calls_in_capture = 0

    def qps(self):
        w = self.window
        span = w.t_end - w.t0
        return self.queries_answered / span if span > 0 else None


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _settle() -> None:
    """Collect once and freeze what set-up left, so that the collector's
    passes in the window scan only what the window allocates."""
    gc.collect()
    gc.freeze()


def _closed(run, engine, index, q, seconds, trace):
    import torch

    from benchmark import loadgen

    cfg, mix, dev = run.cfg, run.mix, run.device
    nq = int(mix["batch"])
    batches = [q[s:s + nq] for s in range(0, q.shape[0] - nq + 1, nq)]
    run.batch_queries = batches
    search = engine.search_fn(index, cfg, nq)
    counter = [0]

    def call():
        b = counter[0] % len(batches)
        counter[0] += 1
        with trace.span("bench.search"):
            d, ids = search(batches[b])
        with trace.span("bench.wait"):
            d, ids = d.cpu(), ids.cpu()
        return b, d, ids

    for _ in range(int(mix["warm_calls"])):
        call()
    _sync(dev)
    counter[0] = 0
    _settle()
    run.setup_s = time.perf_counter() - T_PROCESS
    w = run.window = loadgen.closed_loop(call, seconds)
    run.queries_answered = nq * len(w.answers)
    returned = list(w.answers)
    if trace.enabled:
        # the capture follows the window: its start-up stays out of it
        trace.start()
        cap = loadgen.closed_loop(call, float(mix["trace_seconds"]))
        trace.stop()
        run.calls_in_capture = len(cap.answers)
        returned += cap.answers
    run.attempted = nq * len(returned)
    # identical answer sets are judged once, counted as often as returned
    distinct: dict = {}
    for b, d, ids in returned:
        for seen in distinct.setdefault(b, []):
            if torch.equal(seen[0], d) and torch.equal(seen[1], ids):
                seen[2] += 1
                break
        else:
            distinct[b].append([d, ids, 1])
    answers = []
    for b, sets in distinct.items():
        qidx = torch.arange(b * nq, (b + 1) * nq)
        answers += [((qidx, d, ids), n) for d, ids, n in sets]
    return answers


def run_cell(bench, cell_name: str, *, seed: int, seconds: float, trace_on: bool,
             device, engine_name: str | None = None) -> dict:
    """One run of a cell on ``device``; returns the result object (the
    contract's last line). ``engine_name`` puts another engine adapter in
    the configuration's place (the control)."""
    import torch

    from benchmark import data, judge, tracing

    cell = bench.cell(cell_name)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    if mix["loop"] != "closed":
        raise ValueError(f"traffic {mix['name']!r}: only a closed loop is driven")
    engine = bench.engine(engine_name or cfg["engine"])
    run = Run(cell, cfg, mix, device, seed)
    trace = run.trace = tracing.Trace(trace_on, device)
    if trace_on:
        engine.instrument(trace)

    x, q = data.make(cfg, seed, device)
    _sync(device)
    t0 = time.perf_counter()
    index = engine.build(x, cfg, seed, device)
    _sync(device)
    run.build_s = time.perf_counter() - t0
    log(f"bench: {cell_name} seed {seed}: build {run.build_s:.3f} s")
    del x

    answers = _closed(run, engine, index, q, seconds, trace)
    run.capture = trace.summary()
    if trace_on:
        run.yardstick = engine.yardstick(index, cfg)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)

    # the program's state goes before the reference runs; the reference
    # gets the rows and queries made again from the seed
    del index, q
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    x, q = data.make(cfg, seed, device)
    t_ref = time.perf_counter()
    verdict = judge.judge(x, q, answers, k=int(cfg["k"]),
                          distance=engine.DISTANCE, limits=cfg["check"])
    log(f"bench: reference and comparison {time.perf_counter() - t_ref:.3f} s")
    run.recall = verdict["recall"]
    del x, q

    table = bench.per_layer_for(cell_name) if trace_on else bench.end_to_end_for(cell_name)
    metrics = {}
    for m in table:
        value = bench.metric_reader(m["name"]).read(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                 else device.type),
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": bool(verdict["correct"]),
              "attempted": int(run.attempted),
              "failed": 0, "metrics": metrics, "device": device_info}
    if trace_on and run.capture is not None:
        device_info["busy_s"] = run.capture["busy_s"]
        device_info["window_s"] = run.capture["window_s"]
        result["breakdown"] = {"device_ops": run.capture["device_ops"],
                               "idle_gaps": run.capture["idle_gaps"]}
    result["checks"] = verdict["checks"]
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark.spec import Bench

    bench = Bench()
    cell = bench.cell(args.workload)
    import raft_tpu_torch  # noqa: F401 - the system under test must be there
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"bench: {args.workload} needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present")
        return 2
    result = run_cell(bench, args.workload, seed=args.seed, seconds=args.seconds,
                      trace_on=bool(args.trace), device=torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        log(f"bench: loaded after the window: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
