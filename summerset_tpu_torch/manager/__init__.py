"""Cluster manager oracle, counterpart of ``summerset_tpu/manager``: assigns
replica ids, distributes peer addresses, tracks the leader and injects
control actions (pause / resume / durable reset).  It is not part of
protocol logic."""

from .clusman import ClusterManager  # noqa: F401
