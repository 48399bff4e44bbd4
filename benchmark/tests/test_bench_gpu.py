"""On the card: tiny cells at DEEP's width through the port's CUDA
kernels. A sound run comes out correct and the control does not, and a
traced run reads the kernels' spans (their device time is what the
roofline metrics divide by). Skips where there is no card."""

from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.spec import Bench
from benchmark.tests.conftest import make_tiny_root


@pytest.fixture(scope="module")
def card_root(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return make_tiny_root(tmp_path_factory.mktemp("bench_gpu"), dim=96, n_rows=200_000)


@pytest.mark.gpu
@pytest.mark.parametrize("cell,kernel_metric", [
    ("tiny-ivf_flat.batch", "flat_scan_roofline"),
    ("tiny-ivf_pq.batch", "pq_adc_roofline")])
def test_cells_on_the_card(card_root, cell, kernel_metric):
    bench, dev = Bench(card_root), torch.device("cuda", 0)
    sound = run.run_cell(bench, cell, seed=2**31 + 5, seconds=1.0, trace_on=True,
                         device=dev)
    assert sound["correct"], sound["checks"]
    assert kernel_metric in sound["metrics"], sound["metrics"]
    assert 0 < sound["metrics"][kernel_metric]["value"] <= 100
    assert sound["device"]["busy_s"] > 0
    control = run.run_cell(bench, cell, seed=2**31 + 5, seconds=1.0, trace_on=False,
                           device=dev, engine_name="control_bf16")
    assert not control["correct"], control["checks"]
