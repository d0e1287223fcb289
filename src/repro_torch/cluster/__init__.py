"""Replica-sharded serving cluster, the port of ``repro.cluster``.

  router.py - Router: N in-process replicas behind a placement policy
              (least-loaded / affinity / round-robin / class-affinity),
              bit-exact stream migration on retire, cluster-merged
              EngineStats.
  faults.py - the seeded Backoff (the edge client's reconnect pacing).

The router exposes the admit/submit/step/retire surface of one
``ServerEngine``, so the in-process pump and the transport server serve a
replica fleet by holding it instead. Remote replicas and the chaos harness
come with the next slices (ROADMAP.md Queue A).
"""

from repro_torch.cluster.faults import Backoff
from repro_torch.cluster.router import (
    PLACEMENT_POLICIES,
    AffinityPlacement,
    ClassAffinityPlacement,
    LeastLoadedPlacement,
    LocalReplica,
    MigrationError,
    PlacementPolicy,
    RoundRobinPlacement,
    Router,
    make_placement,
)

__all__ = [
    "PLACEMENT_POLICIES",
    "AffinityPlacement",
    "Backoff",
    "ClassAffinityPlacement",
    "LeastLoadedPlacement",
    "LocalReplica",
    "MigrationError",
    "PlacementPolicy",
    "RoundRobinPlacement",
    "Router",
    "make_placement",
]
