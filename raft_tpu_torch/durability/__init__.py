"""Durability tier — crash-consistent ingest for the mutation path (the
port of ``raft_tpu/durability``).

The mutation tier's checkpoints (v4 delta and full v4 archives) bound
what a crash loses to "everything since the last flush"; this package
closes the window to "nothing acked" with a write-ahead log:
CRC32-framed segments byte for byte the JAX package's, host-side group
commit (acks resolve only after fsync), rotation with retention pinned
to the delta-checkpoint LSN watermark, torn-tail repair, and idempotent
monotone-LSN replay. Recovery loads the latest checkpoint and replays
the WAL tail.
"""

from raft_tpu_torch.durability.wal import (
    OP_DELETE,
    OP_UPSERT,
    WAL_VERSION,
    DurableIngest,
    WalAck,
    WalRecord,
    WalWriter,
    decode_delete,
    decode_upsert,
    encode_delete,
    encode_frame,
    encode_upsert,
    read_records,
    recover_mutable,
    repair_wal,
    replay_into,
    scan_segment,
    segment_paths,
    wal_frontier,
)

__all__ = [
    "OP_DELETE",
    "OP_UPSERT",
    "WAL_VERSION",
    "DurableIngest",
    "WalAck",
    "WalRecord",
    "WalWriter",
    "decode_delete",
    "decode_upsert",
    "encode_delete",
    "encode_frame",
    "encode_upsert",
    "read_records",
    "recover_mutable",
    "repair_wal",
    "replay_into",
    "scan_segment",
    "segment_paths",
    "wal_frontier",
]
