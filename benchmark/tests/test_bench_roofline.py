"""The yardstick's counts against a hand count at a small shape."""

from __future__ import annotations

import math

import torch

from benchmark import roofline


def test_search_counts_by_hand():
    list_sizes = torch.tensor([5, 0, 7, 3])
    probes = torch.tensor([[0, 2], [2, 3], [0, 2]])
    ops, nbytes = roofline.search_counts(probes, list_sizes, dim=4, k=2,
                                         ops_per_row=8, row_bytes=8)
    # rows scanned a query: 12, 10, 12; distinct lists 0, 2, 3: 15 rows
    assert ops == 8 * (12 + 10 + 12)
    assert nbytes == 15 * 8 + 3 * 4 * 4 + 3 * 2 * 8


def test_flat_scan_counts_by_hand():
    # 3 lists, 2 slots; queries 0..2 real, 3 the sentinel; list 2 has no
    # live slot and is not read
    qmat = torch.tensor([[0, 3], [1, 0], [3, 3]], dtype=torch.int32)
    bounds = torch.tensor([[0, 6], [2, 5], [0, 8]], dtype=torch.int32)
    ops, nbytes = roofline.flat_scan_counts(3, qmat, 4, 2, 2, bounds, 8)
    assert ops == 2 * 4 * (1 * 6 + 2 * 3)
    assert nbytes == (6 + 3) * 4 * 2 + 2 * 4 * 2      # rows, queries 0 and 1


def test_pq_adc_counts_by_hand():
    lut_map = torch.tensor([[0, -1], [1, 2]], dtype=torch.int32)
    bounds = torch.tensor([[1, 9], [0, 4]], dtype=torch.int32)
    ops, nbytes = roofline.pq_adc_counts(3, lut_map, 24, 1, bounds, 8)
    assert ops == 24 * (1 * 7 + 2 * 4)               # [1, 9) clamps to l_pad 8
    assert nbytes == (7 + 4) * 24


def test_least_time_takes_the_larger_bound():
    assert math.isclose(roofline.least_time_s(989e12, 0), 1.0)
    assert math.isclose(roofline.least_time_s(1, 3.35e12), 1.0)


def test_probe_matches_brute_force():
    g = torch.Generator().manual_seed(0)
    q, c = torch.randn(20, 8, generator=g), torch.randn(16, 8, generator=g)
    got = roofline.probe(q, c, 3)
    want = torch.cdist(q, c).topk(3, largest=False).indices
    assert torch.equal(got.sort(1).values, want.sort(1).values)
