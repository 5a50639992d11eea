"""Serving layer: persistent ScenarioService with cross-request
continuous batching (see server.py for the architecture notes), the
self-healing resilience layer (see resilience.py: circuit breakers,
load shedding with degraded-fidelity answers, backend-loss recovery,
poison-request quarantine, crash-safe serve journal), and the BOOST
design and Monte-Carlo request types (``submit_design`` /
``submit_montecarlo``; engines in ``dervet_tpu_torch.design`` and
``.stochastic``, integration in their ``service`` modules).  One device
per service.  The JAX package's fleet tier (``fleet``, ``router``,
``reqcache``, ``lifecycle``) and its portfolio request types are not
ported yet."""
from .client import ScenarioClient
from .journal import ServiceJournal
from .queue import (AdmissionQueue, BackendLostError, BreakerOpenError,
                    DeadlineExpiredError, PoisonRequestError,
                    QueueFullError, RequestFailedError,
                    RequestPreemptedError, ServiceClosedError, ServiceError)
from .server import ScenarioService, serve_main

__all__ = [
    "AdmissionQueue", "BackendLostError", "BreakerOpenError", "DeadlineExpiredError",
    "PoisonRequestError", "QueueFullError", "RequestFailedError",
    "RequestPreemptedError", "ScenarioClient", "ScenarioService",
    "ServiceClosedError", "ServiceError", "ServiceJournal", "serve_main",
]
