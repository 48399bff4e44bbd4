"""``top_k_smallest``'s routing and its counters, on the CPU
(raft_tpu_torch.spatial.selection).

Which route a call takes is decided by the input's shape, dtype and
device alone (:func:`select_k_kernel_fits`), and every call is counted
in ``select_k_calls_total{route}`` by the route that test chose. The
plain version's total order is held to ``lax.top_k`` in
``tests/test_torch_knn.py``, and the kernel to the plain version, bit
for bit, on the card (``tests/test_torch_gpu.py``).
"""

import types

import numpy as np
import pytest
import torch

from raft_tpu_torch.obs import default_registry
from raft_tpu_torch.obs import metrics as obs_metrics
from raft_tpu_torch.spatial import selection as tsel


def _like(shape, dtype=torch.float32, device="cuda"):
    """Stands in for a tensor: what the route reads of it."""
    numel = int(np.prod(shape)) if shape else 1
    return types.SimpleNamespace(
        device=torch.device(device), dtype=dtype, shape=torch.Size(shape),
        dim=lambda: len(shape), numel=lambda: numel)


MAX_K, MAX_ROW = tsel.SELECT_K_MAX_K, tsel.SELECT_K_MAX_ROW


@pytest.mark.parametrize("x,k,fits", [
    (_like((10_000, 14_336)), 40, True),      # the IVF pool
    (_like((10_000, 4096)), 32, True),        # the coarse probe
    (_like((10_000, 7824)), 48, True),        # brute force, the minima
    (_like((10_000, 6144)), 10, True),        # brute force, the rescore
    (_like((6, 11, 96)), 10, True),           # leading batch axes
    (_like((3, MAX_ROW)), MAX_K, True),       # the caps
    (_like((3, MAX_ROW + 1)), 10, False),     # a row past the cap
    (_like((3, 300)), MAX_K + 1, False),      # k past the cap
    (_like((3, 7)), 8, False),                # k > n
    (_like((3, 7)), 0, False),
    (_like((0, 7)), 3, False),                # no row
    (_like((7,)), 3, True),
    (_like(()), 1, False),
    (_like((3, 70), torch.float64), 5, False),
    (_like((3, 70), torch.float16), 5, False),
    (_like((3, 70), torch.bfloat16), 5, False),
    (_like((3, 70), torch.int32), 5, False),
    (_like((3, 70), device="cpu"), 5, False),
    (_like((3, 70), device="meta"), 5, False),
])
def test_route_follows_shape_dtype_and_device(x, k, fits):
    assert tsel.select_k_kernel_fits(x, k) is fits


def _routes():
    return {c.labels["route"]: c.value
            for c in default_registry().series("select_k_calls_total")}


def test_calls_are_counted_by_route():
    """A CPU call counts one ``sort`` and launches nothing; with the obs
    gate closed nothing is counted."""
    prev = obs_metrics.set_enabled(True)
    try:
        before, launches = _routes(), tsel.SELECT_K_LAUNCHES
        tsel.top_k_smallest(torch.ones(4, 9), 3)
        tsel.top_k_smallest(torch.ones(2, 4, 9, dtype=torch.float64), 3)
        after = _routes()
        assert after["sort"] == before.get("sort", 0) + 2
        assert after.get("kernel", 0) == before.get("kernel", 0)
        assert tsel.SELECT_K_LAUNCHES == launches
        obs_metrics.set_enabled(False)
        tsel.top_k_smallest(torch.ones(4, 9), 3)
        assert _routes() == after
    finally:
        obs_metrics.set_enabled(prev)


def test_kernel_route_counts_and_launches_through_one_test(monkeypatch):
    """The route counter and the launch follow the one answer of
    ``select_k_kernel_fits``: a call it routes to the kernel counts one
    ``kernel`` and reaches ``top_k_smallest_kernel`` with the same
    arguments; a call it refuses counts one ``sort`` and never does."""
    x = torch.arange(12.0).reshape(3, 4)
    launched = []

    def launch(arg, k):
        launched.append((arg, k))
        return tsel.top_k_smallest_plain(arg, k)

    monkeypatch.setattr(tsel, "top_k_smallest_kernel", launch)
    prev = obs_metrics.set_enabled(True)
    try:
        for fits in (True, False):
            monkeypatch.setattr(tsel, "select_k_kernel_fits",
                                lambda arg, k, fits=fits: fits)
            before = _routes()
            v, i = tsel.top_k_smallest(x, 2)
            route = "kernel" if fits else "sort"
            assert _routes()[route] == before.get(route, 0) + 1
            assert torch.equal(i, torch.tensor([[0, 1], [4, 5], [8, 9]])
                               % 4)
        assert len(launched) == 1 and launched[0][0] is x
        assert launched[0][1] == 2
    finally:
        obs_metrics.set_enabled(prev)
