"""The comparison that decides ``correct`` has to fail: the control (the
reference in bf16, in the program's place) and the timed path broken
underneath (an answer altered where it is produced; half of each batch
left out) come out as not correct, while a sound run comes out correct.
These runs skip the harness's look for a card and drive the rest of a
run on the CPU at a tiny size; ``tools/readings.py`` reads the control on
the card at the cells' own size."""

from __future__ import annotations

import pytest
import torch

import raft_tpu_torch.spatial.ann as ann
from benchmark import run
from benchmark.spec import Bench

CPU = torch.device("cpu")


def _run(root, cell, **kw):
    return run.run_cell(Bench(root), cell, seed=2**32 + 9, seconds=0.5, trace_on=False,
                        device=CPU, **kw)


@pytest.mark.parametrize("cell", ["tiny-ivf_flat.batch", "tiny-ivf_pq.batch"])
def test_sound_run_correct_control_not(tiny_root, cell):
    sound = _run(tiny_root, cell)
    assert sound["correct"], sound["checks"]
    control = _run(tiny_root, cell, engine_name="control_bf16")
    assert not control["correct"]
    gap = control["checks"]["dist_gap"]
    assert gap["value"] > 3 * sound["checks"]["dist_gap"]["value"]
    assert gap["value"] > gap["limit"]


def _altered(orig):
    def search(index, q, k, **kw):
        d, i = orig(index, q, k, **kw)
        i = i.clone()
        i[0, 0] = (i[0, 0] + 1) % index.storage.n
        return d, i
    return search


def _half_left_out(orig):
    def search(index, q, k, **kw):
        h = max(1, q.shape[0] // 2)
        d, i = orig(index, q[:h], k, **kw)
        rep = -(-q.shape[0] // h)
        return d.repeat(rep, 1)[:q.shape[0]], i.repeat(rep, 1)[:q.shape[0]]
    return search


@pytest.mark.parametrize("fault", [_altered, _half_left_out])
@pytest.mark.parametrize("cell,entry", [("tiny-ivf_flat.batch", "ivf_flat_search_grouped"),
                                        ("tiny-ivf_pq.batch", "ivf_pq_search_grouped")])
def test_broken_timed_path_not_correct(tiny_root, monkeypatch, cell, entry, fault):
    monkeypatch.setattr(ann, entry, fault(getattr(ann, entry)))
    out = _run(tiny_root, cell)
    assert not out["correct"]
    assert out["checks"]["dist_gap"]["value"] > out["checks"]["dist_gap"]["limit"]
