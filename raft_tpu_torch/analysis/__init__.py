"""Concurrency checks of the port: the runtime lock-order tracer
(:mod:`raft_tpu_torch.analysis.threads.runtime`)."""
