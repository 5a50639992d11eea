"""Logging + error types (reference surface: storagevet.ErrorHandling,
re-exported exceptions used across dervet — SURVEY.md §2.8).

The service-facing errors form ONE typed family rooted at
:class:`TypedError`: every member carries a machine-readable ``kind``
slug and a ``retry_hint`` (seconds to wait before a retry makes sense,
or None when retrying as-is cannot help), and serializes uniformly via
:meth:`TypedError.as_dict` — so spool result files, the service
journal, and client-side handling all dispatch on the same two fields
instead of parsing prose."""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional


class TypedError(Exception):
    """Base of the machine-readable error family.

    ``kind`` is a stable slug clients switch on; ``retry_hint`` is the
    seconds-to-wait suggestion (None = resubmitting the identical
    request cannot help — fix the input or wait for an operator)."""

    kind: str = "error"

    def __init__(self, *args):
        super().__init__(*args)
        self.retry_hint: Optional[float] = None

    def as_dict(self) -> Dict:
        """Uniform serialized form for spool result files / journals."""
        return {"error": type(self).__name__, "kind": self.kind,
                "message": str(self), "retry_hint": self.retry_hint}


class ModelParameterError(Exception):
    """Bad model-parameters input (tag/key/value/combination)."""


class ParameterError(Exception):
    """Invalid parameter combination discovered after load."""


class MonthlyDataError(Exception):
    """Monthly data missing or inconsistent with the scenario years."""


class TimeseriesDataError(Exception):
    """Referenced time-series data is missing or inconsistent."""


class SolverError(Exception):
    """Dispatch optimization failed (non-convergence / infeasibility)."""


class AggregatedSolverError(SolverError):
    """Every case of a dispatch failed.  Individual case failures are
    quarantined (the sweep continues without them); only when no case
    survives does the run abort, carrying each case's diagnosis."""

    def __init__(self, failures):
        self.failures = dict(failures)     # case id -> diagnosis
        lines = [f"  case {cid}: {reason}"
                 for cid, reason in self.failures.items()]
        super().__init__(
            f"all {len(self.failures)} case(s) failed dispatch:\n"
            + "\n".join(lines))


class PreemptedError(Exception):
    """The run received SIGTERM/SIGINT and shut down gracefully at a
    window-batch boundary: case checkpoints and the sweep-level
    ``run_manifest.json`` were flushed first, so a re-run with the same
    ``checkpoint_dir`` resumes instead of restarting.  The CLI maps this
    to exit code ``supervisor.EXIT_PREEMPTED`` (75, EX_TEMPFAIL) so job
    schedulers can tell preemption from failure."""


class DeviceLossError(RuntimeError):
    """The accelerator backend died mid-dispatch (the injected analogue
    of an ``XlaRuntimeError`` device loss).  A ``RuntimeError`` subclass
    — NOT part of the typed client family — because it models the
    runtime-layer crash the service's backend-loss recovery exists to
    absorb: clients should never see it, they see either a recovered
    result or a typed failure after recovery is exhausted."""


# ---------------------------------------------------------------------------
# Service typed-error family (kind + retry_hint; re-exported by
# dervet_tpu.service.queue for the historical import path)
# ---------------------------------------------------------------------------

class ServiceError(TypedError):
    """Base of the scenario service's typed errors."""

    kind = "service"


class QueueFullError(ServiceError):
    """Admission rejected: the queue is at capacity (or the ``overload``
    fault forced the rejection).  ``retry_after_s`` is the service's
    resubmission hint, derived from the observed recent drain rate
    (queue depth / requests-per-second served) when round history
    exists, else the static default."""

    kind = "queue_full"

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)
        self.retry_hint = self.retry_after_s


class DeadlineExpiredError(ServiceError):
    """The request's deadline passed before its batch was dispatched.
    Expired requests are dropped at batch-assembly time, BEFORE any LP is
    built — they never poison the batch they would have ridden."""

    kind = "deadline_expired"


class ServiceClosedError(ServiceError):
    """Admission refused: the service is draining or closed."""

    kind = "service_closed"


class RequestPreemptedError(ServiceError):
    """The service was preempted (SIGTERM drain) while this request was
    in flight.  Per-case checkpoints and the request's namespaced
    ``run_manifest.<rid>.json`` were flushed first — resubmitting the
    same request id against the same checkpoint directory resumes
    instead of restarting."""

    kind = "request_preempted"

    def __init__(self, msg: str, manifest_path=None):
        super().__init__(msg)
        self.manifest_path = manifest_path
        self.retry_hint = 0.0       # resubmission resumes immediately


class RequestFailedError(ServiceError):
    """Every case of the request was quarantined by the failure-isolation
    layer; ``failures`` maps case key -> diagnosis."""

    kind = "request_failed"

    def __init__(self, failures: Dict):
        self.failures = dict(failures)
        lines = [f"  case {k}: {r}" for k, r in self.failures.items()]
        super().__init__(
            f"all {len(self.failures)} case(s) of the request failed:\n"
            + "\n".join(lines))


class PoisonRequestError(ServiceError):
    """The request's cases crashed the dispatch twice: it is quarantined
    and its fingerprint blocklisted, so resubmission is rejected fast at
    admission instead of re-crashing a round it would share with
    innocent requests.  ``diagnosis`` carries the crash that earned the
    quarantine."""

    kind = "poison_request"

    def __init__(self, msg: str, diagnosis: Optional[str] = None):
        super().__init__(msg)
        self.diagnosis = diagnosis


class PortfolioInfeasibleError(ServiceError):
    """The portfolio's coupling rows cannot be satisfied by ANY member
    dispatch (e.g. an aggregate import cap below the fleet's must-serve
    load): the dual loop terminates with this typed diagnosis instead of
    burning its outer-iteration budget on a divergent price search.
    ``violations`` lists the violated rows — each a dict with the
    coupling ``kind``, the worst timestep index/stamp, the required vs
    achievable aggregate kW, and the shortfall."""

    kind = "portfolio_infeasible"

    def __init__(self, msg: str, violations=None):
        super().__init__(msg)
        self.violations = list(violations or [])

    def as_dict(self) -> Dict:
        d = super().as_dict()
        d["violations"] = self.violations
        return d


class BreakerOpenError(ServiceError):
    """Refused: a circuit breaker of the service is open — at admission
    the backend breaker (recent rounds lost their backend even after
    re-initialization), in a batch round the certify breaker (a
    certification-rejection storm).  The service is alive but will not
    solve now.  ``retry_hint`` is the breaker's next half-open probe
    time."""

    kind = "breaker_open"

    def __init__(self, msg: str, probe_in_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_hint = probe_in_s


class BackendLostError(ServiceError):
    """The round's backend died and did not come back: re-initialization
    failed ``max_reinits`` consecutive times (a sticky CUDA fault leaves
    the process's context unusable).  The round's requests fail with
    this error rather than being answered from the CPU, which would hide
    a faulty card or kernel behind answers that still certify; only a
    process restart heals the card."""

    kind = "backend_lost"


class FleetUnavailableError(QueueFullError):
    """The fleet router could not place the request on ANY replica:
    every healthy replica rejected it (queue full / inflight bound) or
    every replica's breaker is open.  A :class:`QueueFullError` subclass
    on purpose — the routing hop must not launder the per-replica
    drain-rate hint into an untyped error, so ``retry_after_s`` carries
    the SMALLEST hint any replica offered and existing client backoff
    discipline (capped, ±25% jittered) applies unchanged."""

    kind = "fleet_unavailable"


class ShardCacheMissError(ServiceError):
    """A REFERENCE-mode portfolio shard payload (dual-price vector +
    plan fingerprint, no site cases) reached a replica whose shard case
    cache holds no entry for its ``(seed_tag, plan_fp)`` key — the
    replica is cold for this shard (a failover moved the shard, the
    entry was evicted, or the replica restarted).  The shard executor
    reacts by re-dispatching the SAME shard once with the full site
    payload, which re-seeds the cache; ``retry_hint`` is 0 because the
    full resend can go immediately."""

    kind = "shard_cache_miss"

    def __init__(self, msg: str):
        super().__init__(msg)
        self.retry_hint = 0.0


class ReplicaQuarantinedError(ServiceError):
    """The fleet lifecycle supervisor gave up on a crash-looping
    replica: it died ``crashes`` times in rapid succession (each within
    the rapid-crash window of the previous respawn), so instead of
    hot-looping spawn/crash forever the replica is parked in the typed
    ``quarantined`` terminal state.  An operator (or a config fix) must
    clear it via ``FleetSupervisor.release``; ``retry_hint`` is None
    because respawning the identical replica cannot help."""

    kind = "replica_quarantined"

    def __init__(self, msg: str, replica: Optional[str] = None,
                 crashes: int = 0, last_reason: Optional[str] = None):
        super().__init__(msg)
        self.replica = replica
        self.crashes = int(crashes)
        self.last_reason = last_reason

    def as_dict(self) -> Dict:
        d = super().as_dict()
        d.update(replica=self.replica, crashes=self.crashes,
                 last_reason=self.last_reason)
        return d


class ReplicaAnswerError(ServiceError):
    """A spool replica answered the request with a typed failure; the
    router re-raises it on the client future with the replica's
    machine-readable payload attached (``payload``: the ``as_dict``
    record from the replica's ``.error.json``).  The replica's own
    ``retry_hint`` rides through the routing hop."""

    kind = "replica_request_failed"

    def __init__(self, msg: str, payload: Optional[Dict] = None,
                 replica: Optional[str] = None):
        super().__init__(msg)
        self.payload = dict(payload or {})
        self.replica = replica
        hint = self.payload.get("retry_hint")
        self.retry_hint = float(hint) if hint is not None else None


class TariffError(Exception):
    """Customer tariff missing or malformed."""


class TellUser:
    """Static logger facade, mirrors the reference's TellUser usage."""

    logger = logging.getLogger("dervet_tpu")
    if not logger.handlers:
        _h = logging.StreamHandler()
        _h.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))
        logger.addHandler(_h)
        logger.setLevel(logging.INFO)

    @classmethod
    def attach_file(cls, results_dir: Path, name: str = "dervet_tpu.log") -> None:
        """Route the log to a file; one run-log file at a time — a second
        attach with a different path replaces the first (sequential runs
        in one process must not cross-write each other's logs)."""
        results_dir.mkdir(parents=True, exist_ok=True)
        target = str((results_dir / name).resolve())
        for h in list(cls.logger.handlers):
            if getattr(h, "_dervet_run_log", False):
                if h.baseFilename == target:
                    return
                cls.logger.removeHandler(h)
                h.close()
        fh = logging.FileHandler(target)
        fh._dervet_run_log = True
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s: %(message)s"))
        cls.logger.addHandler(fh)

    @classmethod
    def debug(cls, msg: str) -> None:
        cls.logger.debug(msg)

    @classmethod
    def info(cls, msg: str) -> None:
        cls.logger.info(msg)

    @classmethod
    def warning(cls, msg: str) -> None:
        cls.logger.warning(msg)

    @classmethod
    def error(cls, msg: str) -> None:
        cls.logger.error(msg)
