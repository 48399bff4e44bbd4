"""The cell's rows and queries, made on the device.

A Gaussian mixture: ``n_centres`` centres drawn N(0, spread²) per
coordinate, each row a centre chosen uniformly plus N(0, noise²) per
coordinate. Queries are fresh draws from the same mixture, not perturbed
index rows. A ``torch.Generator`` on the device, seeded with the
configuration's own ``data.seed``, draws them in a few large calls; the
run's seed then orders the queries. So every seed searches the same rows
with the same queries in another order: the work does not change with
the seed (with rows drawn from the run's seed, IVF-Flat's batch rate
split by 7% between seeds, PERF.md), and the same seed gives the same
inputs.
"""

from __future__ import annotations

import torch

_CHUNK = 1 << 20        # rows per centre gather (bounds the temporary)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _mixture_rows(g, centres, n, noise, device):
    d = centres.shape[1]
    labels = torch.randint(0, centres.shape[0], (n,), generator=g, device=device)
    rows = torch.randn((n, d), generator=g, device=device)
    if noise != 1.0:
        rows.mul_(noise)
    for s in range(0, n, _CHUNK):
        rows[s:s + _CHUNK].add_(centres[labels[s:s + _CHUNK]])
    return rows


def make(cfg: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows (n_rows, dim) f32, queries (n_queries, dim) f32) on ``device``."""
    mix = cfg["data"]
    if mix["kind"] != "gaussian_mixture":
        raise ValueError(f"unknown data kind {mix['kind']!r}")
    g = generator(int(mix["seed"]), device)
    d = int(cfg["dim"])
    centres = torch.randn((int(mix["n_centres"]), d), generator=g, device=device)
    centres.mul_(float(mix["centre_spread"]))
    noise = float(mix["noise"])
    x = _mixture_rows(g, centres, int(cfg["n_rows"]), noise, device)
    q = _mixture_rows(g, centres, int(cfg["n_queries"]), noise, device)
    order = torch.randperm(q.shape[0], generator=generator(seed, device), device=device)
    return x, q[order]
