"""Test and load-generation helpers of the port: the seeded open-loop
arrival schedules of :mod:`raft_tpu_torch.testing.load`, the kill-9
ingest gate of :mod:`raft_tpu_torch.testing.crash`, and the
multi-process sharded search of :mod:`raft_tpu_torch.testing.dist`."""
