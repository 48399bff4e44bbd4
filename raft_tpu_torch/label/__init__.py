"""Label utilities of the port — the counterpart of ``raft_tpu.label``
(analog of raft/label: classlabels.cuh getUniquelabels /
make_monotonic / getOvrlabels, merge_labels.cuh merge_labels).
"""

from raft_tpu_torch.label.classlabels import (
    get_unique_labels,
    make_monotonic,
    get_ovr_labels,
    merge_labels,
)

__all__ = [
    "get_unique_labels",
    "make_monotonic",
    "get_ovr_labels",
    "merge_labels",
]
