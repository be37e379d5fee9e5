"""Elastic scaling, serving side: replicas join and leave the pool at
runtime (``repro.runtime.elastic.ElasticServingPool``).

The training side of the reference module (``shardings_for`` and
``elastic_restore``, checkpoint-based re-meshing onto an XLA device
mesh) belongs to the XLA/TPU-mesh tooling, which the port scopes out: it
lowers XLA programs for TPU meshes and has no single-card counterpart
(ROADMAP.md, item 6).
"""
from __future__ import annotations


class ElasticServingPool:
    """Serving-side elasticity: replicas join/leave at runtime; the
    dispatcher's subflow set and the launcher's cohort logic adapt on
    the next control tick (no global reconfiguration)."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.joined = 0
        self.left = 0

    def join(self, handle, now: float) -> None:
        # dispatcher replica sets are live views over the cluster
        # registry, so existing stream dispatchers pick the newcomer up
        # on their next tick — nothing to patch
        self.cluster.add_replica(handle)
        self.joined += 1

    def leave(self, replica_id: str, now: float) -> None:
        self.cluster.remove_replica(replica_id, now)
        self.left += 1
