"""Tensor parallelism of the port: shard specs (``sharding``), process
groups (``group``) and the rank-0-mirrored executor (``tp_executor``)."""
