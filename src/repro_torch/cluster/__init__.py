"""Replica-sharded serving cluster, the port of ``repro.cluster``.

  router.py - Router: N replicas (in-process, or worker processes)
              behind a placement policy (least-loaded / affinity /
              round-robin / class-affinity), bit-exact stream migration on
              retire, eviction of dead workers, cluster-merged EngineStats.
  remote.py - RemoteReplica: a worker process behind the replica surface,
              over a blocking ControlChannel; spawn_worker starts one.
  faults.py - supervision and chaos: the seeded Backoff, the armable
              FaultyChannel wrapper, and the ChaosInjector that runs a
              ServeSpec's FaultSpec schedule against a live Router.

The router exposes the admit/submit/step/retire surface of one
``ServerEngine``, so the in-process pump and the transport server serve a
replica fleet by holding it instead. Its FaultPolicy decides what follows
an eviction: respawn, device-replay stream recovery, heartbeats.
"""

from repro_torch.cluster.faults import Backoff, ChaosInjector, FaultyChannel
from repro_torch.cluster.remote import (
    ControlChannel,
    RemoteReplica,
    ReplicaGone,
    WorkerError,
    spawn_worker,
)
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
    "ChaosInjector",
    "ClassAffinityPlacement",
    "ControlChannel",
    "FaultyChannel",
    "LeastLoadedPlacement",
    "LocalReplica",
    "MigrationError",
    "PlacementPolicy",
    "RemoteReplica",
    "ReplicaGone",
    "RoundRobinPlacement",
    "Router",
    "WorkerError",
    "make_placement",
    "spawn_worker",
]
