"""Serving layer: persistent ScenarioService with cross-request
continuous batching (see server.py for the architecture notes), the
self-healing resilience layer (see resilience.py: circuit breakers,
load shedding with degraded-fidelity answers, backend-loss recovery,
poison-request quarantine, crash-safe serve journal), the BOOST
design and Monte-Carlo request types (``submit_design`` /
``submit_montecarlo``; engines in ``dervet_tpu_torch.design`` and
``.stochastic``, integration in their ``service`` modules), portfolio
requests (``submit_portfolio``; ``dervet_tpu_torch.portfolio``), and the
multi-replica fleet tier (``fleet.py`` /
``router.py``: N serve-loop replicas behind a ``FleetRouter`` with
structure-affinity routing, health-probed failover, and exactly-once
recovery of a dead replica's in-flight requests; ``lifecycle.py``
respawns dead replicas — on one GPU every replica shares ``cuda:0``,
each with a CUDA context of its own)."""
from ..utils.errors import (FleetUnavailableError, ReplicaAnswerError,
                            ReplicaQuarantinedError)
from .client import ScenarioClient
from .fleet import (LocalReplica, ReplicaHandle, SpoolReplica,
                    spawn_replica, structure_fingerprint)
from .journal import ServiceJournal
from .lifecycle import FleetSupervisor, ReplicaSpec, supervision_enabled
from .queue import (AdmissionQueue, BackendLostError, BreakerOpenError,
                    DeadlineExpiredError, PoisonRequestError,
                    QueueFullError, RequestFailedError,
                    RequestPreemptedError, ServiceClosedError, ServiceError)
from .router import FleetRouter, RoutedResult
from .server import ScenarioService, serve_main

__all__ = [
    "AdmissionQueue", "BackendLostError", "BreakerOpenError",
    "DeadlineExpiredError",
    "FleetRouter", "FleetSupervisor", "FleetUnavailableError",
    "LocalReplica", "PoisonRequestError", "QueueFullError",
    "ReplicaAnswerError", "ReplicaHandle", "ReplicaQuarantinedError",
    "ReplicaSpec", "RequestFailedError", "RequestPreemptedError",
    "RoutedResult", "ScenarioClient", "ScenarioService",
    "ServiceClosedError", "ServiceError", "ServiceJournal",
    "SpoolReplica", "serve_main", "spawn_replica",
    "structure_fingerprint", "supervision_enabled",
]
