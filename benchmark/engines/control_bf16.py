"""The control: the plain reference put in the program's place and run in
bf16, the precision below the f32 the configurations state. Its answers
must come out as not correct (``tools/readings.py`` reads it on the
card; ``tests/test_bench_control.py`` on the CPU). Never a cell's engine."""

from __future__ import annotations

import torch

from benchmark.reference import exact

DISTANCE = "sqeuclidean"


def instrument(trace) -> None:
    pass


def build(x, cfg: dict, seed: int, device):
    return x.to(torch.bfloat16)


def search_fn(index, cfg: dict, nq: int):
    k = int(cfg["k"])

    def search(q):
        d2, ids = exact.topk(index, q, k, dtype=torch.bfloat16)
        return d2, ids.to(torch.int32)

    return search


def yardstick(index, cfg: dict) -> None:
    return None
