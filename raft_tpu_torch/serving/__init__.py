"""Serving of the port: shape-bucketed micro-batching."""
