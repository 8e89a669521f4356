"""Tensor and data parallelism of the port (`parallel.sharding`)."""
