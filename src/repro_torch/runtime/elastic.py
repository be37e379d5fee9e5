"""Elastic scaling — the port of ``repro.runtime.elastic``: checkpoint-
based re-meshing and replica join/leave for the serving path.

``elastic_restore`` restarts from a checkpoint written under mesh A (or
by one process) onto mesh B: the checkpoint stores whole logical
arrays, and each rank of B reads the leaves and keeps its block under
B's shardings (``Checkpointer.restore(shardings=)``).  Nothing in the
step functions changes: they read the blocks' layout from the rule
table in force (``models/sharding.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.checkpoint.checkpointer import (
    Checkpointer, _tree_paths, _unflatten,
)
from repro_torch.models.sharding import MeshSharding


def shardings_for(tree: Any, mesh, spec_fn: Callable[[str, Any], tuple]
                  ) -> Any:
    """A ``MeshSharding`` tree from a per-leaf spec function (key, leaf)
    -> spec, keys as the checkpoint names the leaves."""
    return _unflatten(tree, iter(MeshSharding(mesh, spec_fn(key, leaf))
                                 for key, leaf in _tree_paths(tree)))


def elastic_restore(ckpt: Checkpointer, template: Any, new_mesh,
                    spec_fn: Callable[[str, Any], tuple],
                    step: Optional[int] = None,
                    device=None) -> Tuple[Any, Dict]:
    """Restore a checkpoint onto a *different* mesh (elastic restart):
    this rank's blocks of ``template``'s leaves on ``device``."""
    shardings = shardings_for(template, new_mesh, spec_fn)
    return ckpt.restore(template, step=step, device=device,
                        shardings=shardings)


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
