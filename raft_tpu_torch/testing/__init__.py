"""Test and load-generation helpers of the port: the seeded open-loop
arrival schedules of :mod:`raft_tpu_torch.testing.load`."""
