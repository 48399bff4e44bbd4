"""Communication layer and the sharded IVF engines — the port of
``raft_tpu/comms`` (the analog of raft/comms, cpp/include/raft/core/
comms.hpp and pyraft's bootstrap).

One per-rank body runs in two forms: in process, one thread per rank
meeting at a rendezvous for each collective (:class:`Comms`,
:class:`HierarchicalComms`; several ranks may share one device), or one
process per rank over a torch.distributed process group
(:class:`DistComms`: gloo on the CPU, NCCL on the card).
:mod:`.comms`'s docstring sets out the design.

The sharded engines — IVF-Flat and IVF-SQ (:mod:`.mnmg_ivf_flat`) and
IVF-PQ (:mod:`.mnmg_ivf`) — share one per-rank search body, and the
sharded mutation tier (:mod:`.mnmg_mutation`: replica-routed upserts and
deletes, quorum-durable ingest over per-rank WALs, recovery) rides it
through ``mutation=``.
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
from raft_tpu_torch.comms import mnmg_mutation
from raft_tpu_torch.comms.mnmg_ivf import (
    MnmgIVFPQIndex,
    attach_coarse_index,
    expand_probe_set,
    mnmg_ivf_pq_build,
    mnmg_ivf_pq_build_distributed,
    mnmg_ivf_pq_search,
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
from raft_tpu_torch.comms.mnmg_mutation import (
    MnmgDurableIngest,
    MnmgMutableIndex,
    MnmgMutationState,
    mnmg_delete,
    mnmg_mutable_search,
    mnmg_recover,
    mnmg_upsert,
    resync_rank,
    wrap_mnmg_mutable,
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
    "MnmgDurableIngest",
    "MnmgIVFFlatIndex",
    "MnmgIVFPQIndex",
    "MnmgIVFSQIndex",
    "MnmgMutableIndex",
    "MnmgMutationState",
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
    "mnmg_delete",
    "mnmg_ivf_flat_build",
    "mnmg_ivf_flat_build_distributed",
    "mnmg_ivf_flat_search",
    "mnmg_ivf_pq_build",
    "mnmg_ivf_pq_build_distributed",
    "mnmg_ivf_pq_search",
    "mnmg_ivf_sq_build",
    "mnmg_ivf_sq_build_distributed",
    "mnmg_ivf_sq_search",
    "mnmg_kmeans_fit",
    "mnmg_knn",
    "mnmg_mutable_search",
    "mnmg_mutation",
    "mnmg_recover",
    "mnmg_upsert",
    "place_index",
    "recover_rank",
    "replicate_index",
    "reshard_index",
    "resync_rank",
    "ring_knn",
    "ring_pairwise_distance",
    "run_all_self_tests",
    "self_test",
    "shard_rows",
    "wrap_mnmg_mutable",
]
