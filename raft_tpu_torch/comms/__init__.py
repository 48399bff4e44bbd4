"""Communication layer and the sharded IVF-Flat engine — the port of
``raft_tpu/comms`` (the analog of raft/comms, cpp/include/raft/core/
comms.hpp and pyraft's bootstrap).

One per-rank body runs in two forms: in process, one thread per rank
meeting at a rendezvous for each collective (:class:`Comms`,
:class:`HierarchicalComms`; several ranks may share one device), or one
process per rank over a torch.distributed process group
(:class:`DistComms`: gloo on the CPU, NCCL on the card).
:mod:`.comms`'s docstring sets out the design.

Not ported yet: the sharded IVF-PQ engine and the sharded mutation
tier.
"""

from raft_tpu_torch.comms import self_test
from raft_tpu_torch.comms.comms import (
    AxisComms,
    Comms,
    DistAxisComms,
    DistComms,
    HierarchicalComms,
    P2PBatch,
    ReduceOp,
    build_comms,
    build_comms_hierarchical,
    inject_comms,
)
from raft_tpu_torch.comms.mnmg import mnmg_kmeans_fit, mnmg_knn
from raft_tpu_torch.comms.mnmg_ivf import (
    attach_coarse_index,
    expand_probe_set,
    place_index,
    recover_rank,
    replicate_index,
    reshard_index,
    shard_rows,
)
from raft_tpu_torch.comms.mnmg_ivf_flat import (
    MnmgIVFFlatIndex,
    MnmgIVFSQIndex,
    mnmg_ivf_flat_build,
    mnmg_ivf_flat_build_distributed,
    mnmg_ivf_flat_search,
    mnmg_ivf_sq_build,
    mnmg_ivf_sq_build_distributed,
    mnmg_ivf_sq_search,
)
from raft_tpu_torch.comms.multihost import (
    comms_levels,
    dcn_merge_accounting,
    hierarchical_merge_select_k,
    host_aware_offset,
    host_rank_mask,
)
from raft_tpu_torch.comms.ring import ring_knn, ring_pairwise_distance
from raft_tpu_torch.comms.self_test import run_all_self_tests

__all__ = [
    "AxisComms",
    "Comms",
    "DistAxisComms",
    "DistComms",
    "HierarchicalComms",
    "MnmgIVFFlatIndex",
    "MnmgIVFSQIndex",
    "P2PBatch",
    "ReduceOp",
    "attach_coarse_index",
    "build_comms",
    "build_comms_hierarchical",
    "comms_levels",
    "dcn_merge_accounting",
    "expand_probe_set",
    "hierarchical_merge_select_k",
    "host_aware_offset",
    "host_rank_mask",
    "inject_comms",
    "mnmg_ivf_flat_build",
    "mnmg_ivf_flat_build_distributed",
    "mnmg_ivf_flat_search",
    "mnmg_ivf_sq_build",
    "mnmg_ivf_sq_build_distributed",
    "mnmg_ivf_sq_search",
    "mnmg_kmeans_fit",
    "mnmg_knn",
    "place_index",
    "recover_rank",
    "replicate_index",
    "reshard_index",
    "ring_knn",
    "ring_pairwise_distance",
    "run_all_self_tests",
    "self_test",
    "shard_rows",
]
