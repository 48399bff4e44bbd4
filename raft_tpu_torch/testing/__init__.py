"""Test and load-generation helpers of the port: the seeded open-loop
arrival schedules of :mod:`raft_tpu_torch.testing.load` and the kill-9
ingest gate of :mod:`raft_tpu_torch.testing.crash`."""
