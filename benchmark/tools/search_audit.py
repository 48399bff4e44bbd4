"""Audit the program's own search measurement on the card, for one cell:
build its index with the harness's traced-run spans in place, warm its
batch, then

- count the synchronising calls of a few searches under
  ``torch.cuda.set_sync_debug_mode("warn")`` beside the program's
  ``ivf_search_host_syncs_total`` over the same calls;
- read the batch's probe map through ``common.probe_drop_stats`` at the
  warmed qcap (the pairs the counter should find dropped);
- run its closed loop for ``--window-s`` seconds, as a traced run's window
  does, then capture ``--capture-s`` seconds of it with the harness's
  ``tracing.Trace`` and reduce it with ``program_spans``: each phase's
  device ms per call, its host ms per call (the ranges' own durations)
  and its three costliest kernels, their sum over the
  entry ranges' device time (the phases' cover of the search), the idle
  in the entries and around the syncs and by the innermost program range
  holding each gap, the caching allocator's device allocations, frees
  and retries during the capture, the dropped-pair share, and any
  device-side event or top operation carrying a program range's name.

One JSON line on standard output.

    python3 -m benchmark.tools.search_audit --workload deep10m-ivf_pq.batch
"""

from __future__ import annotations

import os

# set before torch loads, as run.py sets it: Kineto tears CUPTI down after
# each capture only with it
os.environ.setdefault("TEARDOWN_CUPTI", "1")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import torch  # noqa: E402

from benchmark import data, loadgen, program_spans, tracing  # noqa: E402
from benchmark.spec import ROOT, Bench  # noqa: E402
from raft_tpu_torch.spatial.ann.common import (  # noqa: E402
    coarse_probe,
    probe_drop_stats,
    static_qcap,
)


def _syncs(engine: str) -> int:
    return program_spans.counter_total("ivf_search_host_syncs_total", engine) or 0


def _allocator_counts(cuda: bool) -> dict:
    keys = ("num_device_alloc", "num_device_free", "num_alloc_retries",
            "num_sync_all_streams")
    stats = torch.cuda.memory_stats() if cuda else {}
    return {k: stats.get(k, 0) for k in keys}


def _host_ms_by_phase(events, calls: int) -> dict:
    """Per phase and for the entry, the host ms a call its ranges last."""
    out: dict = {}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA and (
                e.name in program_spans.PHASES or e.name in program_spans.ENTRIES
                or e.name == program_spans.SYNC):
            out[e.name] = out.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return {n: v / calls for n, v in out.items()} if calls else {}


def _kernels_by_phase(events) -> dict:
    """Per phase, its three costliest kernels (ms over the capture)."""
    out: dict = {}

    def walk(e, phase):
        if e.name in program_spans.PHASES:
            phase = e.name
        if phase is not None:
            by = out.setdefault(phase, {})
            for k in e.kernels:
                name = tracing.op_name(k.name, 60)
                by[name] = by.get(name, 0.0) + k.duration / 1e3
        for c in e.cpu_children:
            walk(c, phase)

    for e in events:
        if e.name in program_spans.ENTRIES:
            walk(e, None)
    return {p: sorted(by.items(), key=lambda kv: -kv[1])[:3] for p, by in out.items()}


def _idle_by_range(events) -> dict:
    """Device idle seconds by the innermost program range holding each
    gap's midpoint."""
    cuda = torch.autograd.DeviceType.CUDA
    busy = tracing.merged([(e.time_range.start, e.time_range.end) for e in events
                           if e.device_type == cuda and not e.name.startswith("bench.")
                           and not program_spans.is_program(e.name)])
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type != cuda and program_spans.is_program(e.name)]
    return dict(tracing.gaps_by_span(busy, spans))


@contextlib.contextmanager
def _sync_warnings(cuda: bool):
    """The synchronising calls made inside, as warnings (none off the
    card), the device synchronised before and after."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            yield caught
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 7)
    ap.add_argument("--calls", type=int, default=4)
    ap.add_argument("--window-s", type=float, default=10.0)
    ap.add_argument("--capture-s", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args(argv)
    bench = Bench(args.root)
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    adapter = bench.engine(cfg["engine"])
    trace = tracing.Trace(True, dev)
    adapter.instrument(trace)
    x, q = data.make(cfg, args.seed, dev)
    index = adapter.build(x, cfg, args.seed, dev)
    del x
    nq = int(mix["batch"])
    search = adapter.search_fn(index, cfg, nq)
    batch = q[:nq]
    for _ in range(2):
        search(batch)[0].cpu()

    before = _syncs(cfg["engine"])
    with _sync_warnings(cuda) as caught:
        for _ in range(args.calls):
            search(batch)
    counted = _syncs(cfg["engine"]) - before
    caught = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    sites = sorted({f"{w.filename.rsplit('/', 1)[-1]}:{w.lineno}" for w in caught})

    n_lists = index.centroids.shape[0]
    probes, _ = coarse_probe(batch.float(), index.centroids.float(),
                             int(cfg["search"]["n_probes"]))
    qcap = static_qcap(None, nq, int(cfg["search"]["n_probes"]), n_lists)
    drops = probe_drop_stats(probes, n_lists, qcap)
    occupancy = torch.bincount(probes.reshape(-1), minlength=n_lists)

    loadgen.closed_loop(lambda: search(batch)[0].cpu(), args.window_s)
    mem0 = _allocator_counts(cuda)
    trace.start()
    cap = loadgen.closed_loop(lambda: search(batch)[0].cpu(), args.capture_s)
    trace.stop()
    mem1 = _allocator_counts(cuda)
    summary = trace.summary()
    events = trace._prof.events()
    red = program_spans.reduce_events(events)
    calls = red["calls"] if red else 0
    mirrored = sorted({e.name for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and program_spans.is_program(e.name)})
    ops_named = [n for n, _ in summary["device_ops"] if program_spans.is_program(n)]
    phase_ms = ({p: 1e-3 * us / calls for p, us in red["phase_us"].items()}
                if calls else {})
    print(json.dumps({
        "workload": args.workload,
        "device": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "sync_warnings_per_call": len(caught) / args.calls,
        "sync_counter_per_call": counted / args.calls,
        "sync_sites": sites,
        "calls_in_capture": len(cap.answers), "entry_ranges": calls,
        "phase_ms": phase_ms,
        "phase_host_ms": _host_ms_by_phase(events, calls),
        "phase_kernels_ms": _kernels_by_phase(events),
        "idle_s_by_range": _idle_by_range(events),
        "allocator_in_capture": {k: mem1[k] - mem0[k] for k in mem0},
        "entry_device_ms": 1e-3 * red["entry_us"] / calls if calls else None,
        "phase_cover": (sum(red["phase_us"].values()) / red["entry_us"]
                        if calls and red["entry_us"] else None),
        "idle_ms": 1e-3 * red["idle_us"] / calls if calls else None,
        "sync_idle_ms": 1e-3 * red["sync_idle_us"] / calls if calls else None,
        "dropped_pairs_pct": program_spans.dropped_pairs_pct(
            SimpleNamespace(cfg=cfg)),
        "probe_drop_stats": dict(drops, qcap=qcap,
                                 occupancy_max=int(occupancy.max()),
                                 occupancy_mean=float(occupancy.float().mean())),
        "busy_s": summary["busy_s"], "window_s": summary["window_s"],
        "idle_pct": tracing.idle_pct(summary),
        "device_events_named_as_program": mirrored,
        "device_ops_named_as_program": ops_named,
        "device_ops": summary["device_ops"],
    }), flush=True)


if __name__ == "__main__":
    main()
