"""Service resilience: load shedding, backend-loss recovery, poison
quarantine — the self-healing layer around the batch round.

A long-lived service meets failure modes a one-shot run never sees:

* **Sustained overload** — rejecting everything is one answer; BOOST
  (arxiv 2501.10842) shows a cheap low-fidelity solve is a
  legitimate product tier, so :class:`LoadShedder` instead routes
  low-priority requests to a loose-tolerance, short-budget PDHG
  screening solve (``PDHGOptions.screening``) answered with an explicit
  ``fidelity: "degraded"`` mark and NO certificate — clients resubmit
  for a certified answer when the storm passes.
* **Backend death** — a device loss / CUDA runtime death mid-round
  kills the dispatch, not the service: :class:`BackendRecovery` tears
  the backend down (solver cache, CUDA caching allocator), re-warms the
  card (``device.warmup_device``) and replays the round from the
  per-window checkpoint material (DuaLip-GPU-scale LP fleets treat
  worker loss as routine, arxiv 2603.04621).  After N consecutive
  re-init failures the round's requests fail with the typed
  ``BackendLostError``: the port never answers from the CPU in the
  card's place, which would hide a faulty card or kernel behind answers
  that still certify.  A STICKY CUDA error (an illegal address, a
  device-side assert) leaves the process's CUDA context unusable: every
  re-init then fails — only a process restart heals the card.
* **Poison requests** — a request whose cases keep crashing the
  dispatch would re-kill every round it is co-batched into:
  :class:`PoisonRegistry` fingerprints request content, strikes it on
  every attributed crash, and after two strikes quarantines it with a
  typed ``PoisonRequestError`` and blocklists the fingerprint so
  resubmission is rejected fast at admission.
"""
from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.errors import DeviceLossError, TellUser

# result fidelity marks (Result.fidelity): the explicit degraded-answer
# contract — a degraded result is NEVER certificate-stamped, and carries
# a resubmit hint instead
FIDELITY_FULL = "certified"
FIDELITY_DEGRADED = "degraded"


# ---------------------------------------------------------------------------
# Request fingerprinting (poison registry key)
# ---------------------------------------------------------------------------

def case_fingerprint(case) -> str:
    """Content hash of one :class:`CaseParams` — the inputs that
    determine its dispatch (the scenario-level analogue of
    ``MicrogridScenario._checkpoint_fingerprint``, computable WITHOUT
    constructing a scenario, so the admission boundary can consult the
    poison blocklist before any expensive work)."""
    h = hashlib.sha256()
    h.update(repr(sorted(case.scenario.items(), key=str)).encode())
    for tag, der_id, keys in case.ders:
        h.update(repr((tag, der_id, sorted(keys.items()))).encode())
    for tag, keys in sorted(case.streams.items()):
        h.update(repr((tag, sorted(keys.items()))).encode())
    ts = case.datasets.time_series
    if ts is not None:
        h.update(np.ascontiguousarray(
            ts.to_numpy(dtype=np.float64, na_value=np.nan)).tobytes())
    return h.hexdigest()


def request_fingerprint(cases: Dict) -> str:
    """Fingerprint of a whole request's case set (order-independent)."""
    h = hashlib.sha256()
    for key in sorted(cases, key=str):
        h.update(str(key).encode())
        h.update(case_fingerprint(cases[key]).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Backend-loss classification
# ---------------------------------------------------------------------------

# substrings (lowercased) that mark a CUDA runtime death: the CUDA
# runtime's own error strings (``cudaGetErrorString``) for the sticky
# and device-level faults, as torch and the chunk kernels' launch glue
# (``"<kernel> kernel launch failed: CUDA error <code> (<string>)"``)
# report them
_BACKEND_LOSS_MARKERS = (
    "illegal memory access", "illegal address", "unspecified launch failure",
    "device-side assert", "cuda driver", "ecc error",
    "no cuda gpus are available",
    "no cuda-capable device", "misaligned address", "illegal instruction",
    "hardware stack error", "launch timed out", "device lost",
    "gpu is lost", "cuda-capable device(s) is/are busy or unavailable",
)
# messages of code faults that must NEVER read as a loss: a build that
# failed, a shape the kernel does not take, a tensor on the wrong
# device or of the wrong dtype.  Classed as losses they would send the
# round through re-inits that cannot help.
_CODE_FAULT_PREFIXES = ("nvcc not found", "nvcc failed")


def is_backend_loss(exc: BaseException) -> bool:
    """Is this exception a device/runtime death (recoverable by backend
    re-init + replay) rather than a data- or code-shaped crash?  Typed
    check first (the injected :class:`DeviceLossError`), then torch's
    own accelerator error type, then a ``RuntimeError`` whose message
    carries a CUDA death marker.  ``ValueError``/``TypeError`` (an
    unsupported shape, a wrong device or dtype) and nvcc build failures
    are code faults, never losses."""
    if isinstance(exc, DeviceLossError):
        return True
    if isinstance(exc, (ValueError, TypeError)):
        return False
    msg = str(exc).lower()
    if msg.startswith(_CODE_FAULT_PREFIXES):
        return False
    import torch
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    if isinstance(exc, RuntimeError):
        return any(m in msg for m in _BACKEND_LOSS_MARKERS)
    return False


# ---------------------------------------------------------------------------
# Degraded-tier certification bypass
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def certification_disabled():
    """Disable the float64 certification layer for a degraded-tier
    dispatch (its loose screening solutions are honest best-effort — a
    certificate would reject every one and climb the full ladder,
    defeating the shed).  THREAD-LOCAL (``certify.policy_override``):
    only the dispatching thread's rounds are affected — a concurrent
    independent solve in the same process keeps its own env-derived
    policy, so the degraded tier can never silently strip certification
    from a bystander."""
    import dataclasses

    from ..ops import certify
    policy = dataclasses.replace(certify.policy_from_env(), enabled=False)
    with certify.policy_override(policy):
        yield


# ---------------------------------------------------------------------------
# Load shedding
# ---------------------------------------------------------------------------

class LoadShedder:
    """Overload detector + request partitioner for the degraded tier.

    Overload is judged per round from queue pressure (depth at or past
    ``threshold_frac`` of capacity) or deadline-miss pressure (any
    expiries since the last round); shedding engages only once the
    pressure is SUSTAINED for ``sustain_rounds`` consecutive rounds —
    a one-round blip should not degrade anyone's answer — and releases
    the moment a round starts unpressured."""

    def __init__(self, threshold_frac: float = 0.75,
                 sustain_rounds: int = 2, shed_priority_max: int = 0):
        self.threshold_frac = float(threshold_frac)
        self.sustain_rounds = int(sustain_rounds)
        # only requests at or below this priority are shed (degraded);
        # higher-priority work always gets the certified tier
        self.shed_priority_max = int(shed_priority_max)
        self._consecutive = 0
        self._last_expired = 0
        self.shed_rounds = 0
        self.degraded_requests = 0
        # per-request-TYPE shed accounting ("scenario" vs "design"), so
        # design-screening load is distinguishable from scenario load in
        # service.metrics() — a shed design request is answered with a
        # screening-only frontier, a shed scenario request with a
        # degraded screening dispatch
        self.degraded_by_kind: Dict[str, int] = {}

    def observe(self, depth: int, max_depth: int, expired_total: int
                ) -> bool:
        """Feed one round-start observation; returns True when shedding
        is engaged for this round."""
        misses = expired_total - self._last_expired
        self._last_expired = expired_total
        pressured = (max_depth > 0
                     and depth >= self.threshold_frac * max_depth) \
            or misses > 0
        self._consecutive = self._consecutive + 1 if pressured else 0
        return self._consecutive >= self.sustain_rounds

    def partition(self, requests: List) -> Tuple[List, List]:
        """Split a round's requests into (certified, degraded) by the
        shed-priority cutoff.  Call only when shedding is engaged."""
        certified = [r for r in requests
                     if r.priority > self.shed_priority_max]
        degraded = [r for r in requests
                    if r.priority <= self.shed_priority_max]
        if degraded:
            self.shed_rounds += 1
            self.degraded_requests += len(degraded)
            for r in degraded:
                kind = getattr(r, "kind", "scenario") or "scenario"
                self.degraded_by_kind[kind] = \
                    self.degraded_by_kind.get(kind, 0) + 1
        return certified, degraded

    def snapshot(self) -> Dict:
        return {"engaged_streak": self._consecutive,
                "shed_rounds": self.shed_rounds,
                "degraded_requests": self.degraded_requests,
                "degraded_by_kind": dict(self.degraded_by_kind),
                "threshold_frac": self.threshold_frac,
                "shed_priority_max": self.shed_priority_max}


# ---------------------------------------------------------------------------
# Poison-request quarantine
# ---------------------------------------------------------------------------

class PoisonRegistry:
    """Two-strike crash registry keyed by request-content fingerprint.

    ``strike`` records one ATTRIBUTED crash (the request was dispatched
    alone and the dispatch died); at ``threshold`` strikes the
    fingerprint is blocklisted with its diagnosis.  ``blocked`` is the
    admission-time fast path — a blocklisted resubmission is rejected
    in microseconds instead of re-crashing a co-batched round."""

    def __init__(self, threshold: int = 2, max_entries: int = 1024):
        self.threshold = int(threshold)
        # bounded: a service fed unbounded distinct poison must not grow
        # host memory forever; oldest entries are evicted FIFO
        self.max_entries = int(max_entries)
        self._lock = threading.Lock()
        self._strikes: Dict[str, Dict] = {}
        self.quarantined = 0

    def strike(self, fingerprint: str, request_id: str,
               diagnosis: str) -> int:
        """Record one attributed crash; returns the new strike count."""
        with self._lock:
            entry = self._strikes.get(fingerprint)
            if entry is None:
                if len(self._strikes) >= self.max_entries:
                    self._strikes.pop(next(iter(self._strikes)))
                entry = {"count": 0, "diagnosis": "", "request_ids": []}
                self._strikes[fingerprint] = entry
            entry["count"] += 1
            entry["diagnosis"] = str(diagnosis)
            entry["request_ids"].append(str(request_id))
            if entry["count"] == self.threshold:
                self.quarantined += 1
                TellUser.error(
                    f"poison quarantine: request {request_id!r} "
                    f"(fingerprint {fingerprint[:12]}…) crashed the "
                    f"dispatch {entry['count']} times — blocklisted; "
                    f"diagnosis: {diagnosis}")
            return entry["count"]

    def strikes(self, fingerprint: str) -> int:
        with self._lock:
            entry = self._strikes.get(fingerprint)
            return entry["count"] if entry else 0

    def blocked(self, fingerprint: str) -> Optional[str]:
        """The stored diagnosis when the fingerprint is blocklisted,
        else None — the admission-time check."""
        with self._lock:
            entry = self._strikes.get(fingerprint)
            if entry and entry["count"] >= self.threshold:
                return entry["diagnosis"]
            return None

    def snapshot(self) -> Dict:
        with self._lock:
            return {"tracked": len(self._strikes),
                    "quarantined": self.quarantined,
                    "threshold": self.threshold}


# ---------------------------------------------------------------------------
# Backend-loss recovery
# ---------------------------------------------------------------------------

class BackendRecovery:
    """Teardown / re-init policy for backend death.

    One instance per service; the batch round calls :meth:`reinit` after
    classifying a dispatch crash as backend loss.  After
    ``max_reinits`` consecutive failed re-initializations the budget is
    :meth:`exhausted` and the round is lost (``rounds_lost``; its
    requests fail typed); a successful re-init resets the consecutive
    count."""

    def __init__(self, max_reinits: int = 2, device=None):
        self.max_reinits = int(max_reinits)
        # the service's resolved torch device (re-warmed on re-init)
        self.device = device
        self.losses = 0
        self.reinits = 0
        self.reinit_failures = 0
        self.rounds_lost = 0
        self._consecutive_failures = 0

    def note_loss(self) -> None:
        self.losses += 1

    def begin_round(self) -> None:
        """Fresh re-init budget for a new round.  Without this, the
        consecutive-failure counter left at max by one bad episode would
        make EVERY later round skip re-init and fail at once — even
        after the accelerator healed."""
        self._consecutive_failures = 0

    def exhausted(self) -> bool:
        return self._consecutive_failures >= self.max_reinits

    def reinit(self, solver_cache=None) -> bool:
        """Tear down and re-initialize the accelerator backend.  Clears
        the solver cache (its preconditioned operators live on the dead
        device), synchronizes the card and empties the CUDA caching
        allocator, then re-warms every device the elastic scheduler
        places groups on (``warmup_devices``, no solve).  Returns True on success; False counts a consecutive
        failure toward the exhausted budget."""
        if solver_cache is not None:
            # solvers + preconditioning hold dead-device buffers: drop
            # them — including the elastic per-device shards — and the
            # warm cache rebuilds on re-init
            if hasattr(solver_cache, "clear"):
                solver_cache.clear()
            else:
                solver_cache.solvers.clear()
        try:
            import torch

            from ..device import resolve_device
            from ..parallel import elastic
            from ..parallel.mesh import warmup_devices
            dev = resolve_device(self.device)
            devs = elastic.elastic_devices("torch", dev) or [dev]
            for d in devs:
                if d.type == "cuda":
                    # a sticky fault (illegal address, device-side
                    # assert) raises here: the context is unusable for
                    # this process
                    torch.cuda.synchronize(d)
                    torch.cuda.empty_cache()
            # inventory-only probe of every device the elastic scheduler
            # places groups on: re-init must be FAST (it repeats up to
            # max_reinits times against a possibly-dead backend, and the
            # time to a lost round's answer scales with it); the warm
            # solves are a service-START cost, and the first elastic
            # round after recovery rebuilds its shards anyway
            info = warmup_devices(per_device_solve=False, devices=devs)
            # the injected device_loss fault also fails the warm-up
            # probe while armed, so N-consecutive-failure drills work
            from ..utils import faultinject
            faultinject.maybe_device_loss()
            self.reinits += 1
            self._consecutive_failures = 0
            TellUser.warning(
                f"backend recovery: device re-initialized "
                f"({info['n_devices']}x {info['platform']}) — replaying "
                "the in-flight round from checkpoints")
            return True
        except Exception as e:
            self.reinit_failures += 1
            self._consecutive_failures += 1
            TellUser.error(
                f"backend recovery: re-init attempt failed "
                f"({self._consecutive_failures}/{self.max_reinits}): {e}")
            return False

    def snapshot(self) -> Dict:
        return {"losses": self.losses, "reinits": self.reinits,
                "reinit_failures": self.reinit_failures,
                "rounds_lost": self.rounds_lost,
                "max_reinits": self.max_reinits}
