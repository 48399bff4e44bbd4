"""Class-label utilities of the port — the counterpart of
``raft_tpu/label/classlabels.py`` (reference
cpp/include/raft/label/classlabels.cuh: getUniquelabels:65,
make_monotonic:103, getOvrlabels:86; merge_labels.cuh:57).

As in the JAX package the unique labels come in a fixed capacity with
the true count beside them. ``merge_labels``' ``lax.while_loop`` is a
host loop here, with one host sync a convergence test.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.device import as_tensor, call_device

__all__ = [
    "get_unique_labels",
    "make_monotonic",
    "get_ovr_labels",
    "merge_labels",
]


def _labels(labels, device):
    return as_tensor(labels, call_device(labels, device=device))


def _heads(s):
    head = torch.ones_like(s, dtype=torch.bool)
    head[1:] = s[1:] != s[:-1]
    return head


def get_unique_labels(labels, capacity: Optional[int] = None, *,
                      device=None):
    """Sorted unique labels (reference getUniquelabels:65). Returns
    (unique (capacity,), n_unique as a 0-d int32 tensor); slots past
    n_unique hold the largest label."""
    labels = _labels(labels, device)
    cap = capacity or labels.shape[0]
    s = torch.sort(labels).values
    head = _heads(s)
    n_unique = torch.sum(head).to(torch.int32)
    # heads first, still sorted
    order = torch.sort((~head).to(torch.uint8), stable=True).indices
    uniq = s[order][:cap]
    if uniq.shape[0] < cap:
        uniq = torch.nn.functional.pad(uniq, (0, cap - uniq.shape[0]))
    pos = torch.arange(cap, device=labels.device)
    return torch.where(pos < n_unique, uniq, torch.amax(labels)), n_unique


def make_monotonic(labels, *, device=None):
    """Each label becomes its rank among the sorted unique labels
    (reference make_monotonic:103), int32."""
    labels = _labels(labels, device)
    s = torch.sort(labels).values
    ranks_sorted = torch.cumsum(_heads(s).to(torch.int64), 0) - 1
    first_pos = torch.searchsorted(s, labels, side="left")
    return ranks_sorted[first_pos].to(torch.int32)


def get_ovr_labels(labels, target, *, dtype=torch.float32, device=None):
    """One-vs-rest labels for a target class: +1 where equal, else -1
    (reference getOvrlabels:86)."""
    labels = _labels(labels, device)
    return torch.where(labels == target, 1, -1).to(dtype)


def merge_labels(labels_a, labels_b, mask=None, *, device=None):
    """Union-merge two labelings of the same points (reference
    merge_labels.cuh:57): points that share a label in either input end
    up with one label, the least initial label (point index) of their
    merged group. ``mask`` limits which points take part in the merges
    through ``labels_b`` (the reference's core-point mask).

    A host loop of min-propagations, one host sync a round (the
    convergence test)."""
    dev = call_device(labels_a, labels_b, mask, device=device)
    a = as_tensor(labels_a, dev).long()
    b = as_tensor(labels_b, dev).long()
    n = a.shape[0]
    mask = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
            else as_tensor(mask, dev).bool())
    big = n + 1

    def propagate(cur, group, active):
        """One min-propagation through a labeling: a group's active
        members take the group's least value."""
        gmin = torch.full((n,), big, dtype=cur.dtype, device=dev)
        # labels outside [0, n) are dropped, as JAX's scatter drops them
        ok = (group >= 0) & (group < n)
        slot = torch.where(ok, group, n)
        gmin = torch.cat([gmin, gmin.new_full((1,), big)]).scatter_reduce_(
            0, slot, torch.where(active, cur, big), "amin")[:n]
        pulled = gmin[torch.clamp(group, 0, n - 1)]
        return torch.where(active, torch.minimum(cur, pulled), cur)

    cur = torch.arange(n, dtype=torch.int32, device=dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    while True:
        nxt = propagate(propagate(cur, a, ones), b, mask)
        changed = bool(torch.any(nxt != cur))
        cur = nxt
        if not changed:
            return cur
