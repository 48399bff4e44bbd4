"""Approximate nearest-neighbour indexes of the port: IVF-Flat, IVF-SQ
and IVF-PQ on one sorted-by-list storage layout with their mutation
tier (upsert, delete, compaction, delta checkpoints), the
fixed-degree graph index with its beam search, random ball cover, and
the generic ``approx_knn_*`` entry points."""

from raft_tpu_torch.spatial.ann.approx import (
    approx_knn_build_index,
    approx_knn_search,
)
from raft_tpu_torch.spatial.ann.ball_cover import (
    BallCoverIndex,
    rbc_all_knn_query,
    rbc_build_index,
    rbc_knn_query,
)
from raft_tpu_torch.spatial.ann.common import ListStorage, build_list_storage
from raft_tpu_torch.spatial.ann.graph import (
    GraphIndex,
    GraphParams,
    GraphStorage,
    graph_build,
    graph_delete,
    graph_live_mask,
    graph_restore,
    graph_search,
)
from raft_tpu_torch.spatial.ann.interop import (
    ball_cover_index_from_arrays,
    coarse_index_from_arrays,
    graph_index_from_arrays,
    ivf_flat_index_from_arrays,
    ivf_pq_index_from_arrays,
    ivf_sq_index_from_arrays,
    load_graph,
    load_ivf_flat,
    load_ivf_pq,
    load_ivf_sq,
    load_index,
    mnmg_index_from_arrays,
    mnmg_mutation_state_from_arrays,
    mutable_index_from_arrays,
    save_index,
)
from raft_tpu_torch.spatial.ann.ivf_flat import (
    IVFFlatIndex,
    IVFFlatParams,
    ivf_flat_build,
    ivf_flat_search,
    ivf_flat_search_grouped,
)
from raft_tpu_torch.spatial.ann.ivf_pq import (
    IVFPQIndex,
    IVFPQParams,
    ivf_pq_build,
    ivf_pq_search,
    ivf_pq_search_grouped,
)
from raft_tpu_torch.spatial.ann.mutation import (
    BackgroundCompactor,
    CompactionPolicy,
    DeltaStore,
    MutableIndex,
    apply_delta_checkpoint,
    compact,
    compaction_stats,
    delete,
    delta_checkpoint_watermark,
    lists_changed_since,
    mutable_search,
    mutable_warmup,
    probe_overlap,
    save_delta_checkpoint,
    upsert,
    wrap_mutable,
)
from raft_tpu_torch.spatial.ann.ivf_sq import (
    IVFSQIndex,
    IVFSQParams,
    ivf_sq_build,
    ivf_sq_search,
    ivf_sq_search_grouped,
)

__all__ = [
    "approx_knn_build_index", "approx_knn_search",
    "BallCoverIndex", "ball_cover_index_from_arrays", "rbc_all_knn_query",
    "rbc_build_index", "rbc_knn_query",
    "ListStorage", "build_list_storage",
    "GraphIndex", "GraphParams", "GraphStorage", "graph_build",
    "graph_delete", "graph_index_from_arrays", "graph_live_mask",
    "graph_restore", "graph_search", "load_graph",
    "IVFFlatIndex", "IVFFlatParams", "ivf_flat_build",
    "ivf_flat_index_from_arrays", "ivf_flat_search",
    "ivf_flat_search_grouped", "load_ivf_flat",
    "IVFPQIndex", "IVFPQParams", "ivf_pq_build", "ivf_pq_index_from_arrays",
    "ivf_pq_search", "ivf_pq_search_grouped", "load_ivf_pq",
    "IVFSQIndex", "IVFSQParams", "ivf_sq_build", "ivf_sq_index_from_arrays",
    "ivf_sq_search", "ivf_sq_search_grouped", "load_ivf_sq",
    "coarse_index_from_arrays", "load_index", "mnmg_index_from_arrays",
    "save_index",
    "BackgroundCompactor", "CompactionPolicy", "DeltaStore", "MutableIndex",
    "apply_delta_checkpoint", "compact", "compaction_stats", "delete",
    "delta_checkpoint_watermark", "lists_changed_since",
    "mutable_index_from_arrays", "mutable_search", "mutable_warmup",
    "probe_overlap", "save_delta_checkpoint", "upsert", "wrap_mutable",
]
