"""Design requests through the scenario service.

A ``design`` request rides the SAME front door as a scenario request —
bounded priority admission, deadlines, backpressure, poison blocklist —
and the same delivery contract (a future, per-request run-health and
ledger slices, spool serialization).  Execution splits into the two
BOOST phases inside one batch cycle:

* **Screening** (:class:`DesignRound`, run by the service before the
  certified round): each design request's population screens through
  ``run_dispatch`` with the ordinal tier's options and the service's
  persistent per-tier :class:`ScreeningCaches` — certification disabled
  thread-locally, so a certified scenario round in the same process is
  untouched.  A load-SHED design request stops here and is answered
  with the screening-only degraded frontier.
* **Certified finalists**: the survivors' top-k candidate cases are
  written into ``req.cases`` and the request joins the ordinary
  certified :class:`~dervet_tpu_torch.service.batcher.BatchRound` — finalists
  CO-BATCH with scenario requests' windows through one ``run_dispatch``
  (the continuous batcher's structure grouping doesn't care which
  request type a window came from), and delivery assembles the
  :class:`DesignFrontier` from the certified scenarios plus the
  screening state carried on the request.

This module deliberately imports nothing from ``dervet_tpu_torch.service``
(the service imports US); the typed errors live in ``utils.errors``.
"""
from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional

from ..io.params import Params
from ..telemetry import trace as telemetry_trace
from ..utils.errors import (DeadlineExpiredError, ParameterError,
                            PreemptedError, RequestFailedError,
                            RequestPreemptedError, TellUser)
from .frontier import (FIDELITY_DEGRADED, DesignFrontier, build_frontier,
                       candidate_key)
from .population import DERBounds, DesignSpec, candidate_case, \
    generate_population
from .screen import ScreenReport, ScreeningCaches, screen_candidates


def design_fingerprint(case, spec: DesignSpec) -> str:
    """Content fingerprint of a design request (poison-registry /
    blocklist key): the base case's content hash plus the normalized
    spec."""
    import json

    from ..service import resilience
    h = hashlib.sha256()
    h.update(resilience.case_fingerprint(case).encode())
    h.update(json.dumps(spec.normalized(), sort_keys=True).encode())
    return h.hexdigest()


class DesignState:
    """Per-request design bookkeeping carried from the screening phase
    to frontier assembly in the certified round's delivery."""

    __slots__ = ("spec", "case", "report", "finalists", "risk")

    def __init__(self, spec: DesignSpec, case, report: ScreenReport,
                 finalists: List, risk: Optional[Dict] = None):
        self.spec = spec
        self.case = case
        self.report = report
        self.finalists = finalists
        # risk-aware mode: per-candidate-index MC risk numbers computed
        # during the screening phase (evaluate_finalist_risk), merged
        # into the frontier at delivery
        self.risk = risk


def finalize_service_request(req, scenarios, ledger,
                             breakers=None) -> DesignFrontier:
    """Assemble a design request's :class:`DesignFrontier` after its
    finalists solved in the certified round (called from the batcher's
    delivery path).  ``scenarios`` is the round's per-request scenario
    map keyed by the finalist case keys (``cand0007``)."""
    from ..io.summary import run_health_report
    from ..service.batcher import slice_request_ledger
    state: DesignState = req.design_state
    final_scens = {}
    for e in state.finalists:
        s = scenarios.get(candidate_key(e.candidate))
        if s is not None:
            final_scens[e.candidate.index] = s
    frontier = build_frontier(state.spec, state.case, state.report,
                              final_scens, request_id=req.request_id,
                              risk_eval=state.risk)
    health = run_health_report(
        {k: getattr(s, "health", {}) for k, s in scenarios.items()},
        {k: s.quarantine for k, s in scenarios.items()
         if s.quarantine is not None},
        certification_by_case={k: getattr(s, "certification", None)
                               for k, s in scenarios.items()})
    health["fidelity"] = frontier.fidelity
    health["design"] = frontier.screen
    if breakers:
        health["breakers"] = breakers
    frontier.run_health = health
    frontier.solve_ledger = slice_request_ledger(
        ledger, req.request_id,
        n_windows=sum(len(s.windows) for s in scenarios.values()))
    if not frontier.all_finalists_certified:
        TellUser.warning(
            f"design request {req.request_id}: not every finalist "
            "certified — see the frontier's 'certified'/'reason' columns")
    return frontier


class DesignRound:
    """The screening phase of one batch cycle's design requests.

    Requests in ``degraded_ids`` (load-shed by the service) are answered
    directly with the screening-only degraded frontier; the rest get
    their finalist cases installed on ``req.cases`` and are returned via
    ``finalist_requests`` for the certified round.  Every failure mode
    answers the request's future here — a design request can never leak
    an unresolved future."""

    def __init__(self, requests: List, *, backend: str, solver_opts=None,
                 caches: Optional[ScreeningCaches] = None,
                 degraded_ids=(), supervisor=None, device=None):
        self.requests = requests
        self.backend = backend
        self.solver_opts = solver_opts
        # the service's resolved device ('torch' backend; None -> cuda:0)
        self.device = device
        self.caches = caches if caches is not None else ScreeningCaches(
            pad_grid=(backend != "cpu"), device=device)
        self.degraded_ids = set(degraded_ids)
        self.supervisor = supervisor
        self.finalist_requests: List = []
        self.answered: List = []        # answered during screening
        self.stats = {"requests": 0, "candidates": 0, "screen_rounds": 0,
                      "screen_s": 0.0, "finalists": 0, "degraded": 0,
                      "dispatches": 0, "compile_events": 0}
        self.last_screen: Optional[Dict] = None

    def _answer(self, req, exc) -> None:
        if not req.future.done():
            req.future.set_exception(exc)
        self.answered.append(req)

    @staticmethod
    def _restore_request_span(req) -> None:
        """Point the rid registry back at the request root span once the
        screen span ended (the certified round's spans parent right)."""
        root = getattr(req, "span", None)
        if root is not None:
            telemetry_trace.register_request(req.request_id, root)

    def _preempt_all(self, pending, e) -> None:
        """Drain signal mid-screening: every unanswered design request
        (current and not-yet-screened) gets the typed resumable answer
        before the signal propagates — screening has no checkpoints, so
        the resume is a clean resubmission."""
        for req in pending:
            if not req.future.done():
                req.future.set_exception(RequestPreemptedError(
                    f"design request {req.request_id!r} preempted during "
                    f"screening ({e}); resubmit to a live service (the "
                    "screen replays from scratch)"))
                self.answered.append(req)

    def run(self) -> None:
        for i, req in enumerate(self.requests):
            if req.expired():
                self._answer(req, DeadlineExpiredError(
                    f"design request {req.request_id!r} expired before "
                    "its screening round"))
                continue
            spec: DesignSpec = req.design_spec
            case = req.design_case
            t0 = time.monotonic()
            # telemetry: the screening tiers run under one design_screen
            # span; the per-tier dispatch-group spans parent under it
            # via the rid registry (re-pointed here, restored after)
            span = telemetry_trace.start_span(
                "design_screen", rid=req.request_id,
                attrs={"backend": self.backend,
                       "refine_rounds": spec.refine_rounds,
                       "top_k": spec.top_k})
            if span:
                telemetry_trace.register_request(req.request_id, span)
            try:
                candidates = generate_population(spec)
                report = screen_candidates(
                    case, candidates, backend=self.backend,
                    device=self.device, base_opts=self.solver_opts,
                    caches=self.caches,
                    refine_rounds=spec.refine_rounds,
                    refine_keep=spec.refine_keep, top_k=spec.top_k,
                    budget=spec.budget, supervisor=self.supervisor,
                    request_id=req.request_id)
            except PreemptedError as e:
                span.end(error=e)
                self._preempt_all(self.requests[i:], e)
                raise
            except Exception as e:
                span.end(error=e)
                self._restore_request_span(req)
                TellUser.error(f"design request {req.request_id}: "
                               f"screening failed: {e}")
                self._answer(req, e)
                continue
            self.stats["requests"] += 1
            self.stats["candidates"] += len(report.entries)
            self.stats["screen_rounds"] += len(report.rounds)
            self.stats["screen_s"] += report.screen_s
            self.stats["dispatches"] += report.dispatches
            self.stats["compile_events"] += report.compile_events
            self.last_screen = {
                "request_id": req.request_id,
                "rounds": report.rounds,
                "compile_events": report.compile_events,
                "dispatches": report.dispatches,
            }
            finalists = report.top(spec.top_k)
            if span:
                degraded = req.request_id in self.degraded_ids
                span.set_attrs({
                    "candidates": len(report.entries),
                    "screen_rounds": len(report.rounds),
                    "screen_s": round(report.screen_s, 4),
                    "compile_events": report.compile_events,
                    "finalists": len(finalists),
                    "fidelity": (FIDELITY_DEGRADED if degraded
                                 else "certified"),
                })
                if degraded:
                    span.event("load_shed",
                               reason="design answered from the screen "
                                      "alone — degraded frontier")
                span.end(error=(None if finalists
                                else "no candidate survived screening"))
                self._restore_request_span(req)
            if not finalists:
                reasons = {e.candidate.index: e.reason
                           for e in report.entries if e.reason}
                self._answer(req, RequestFailedError(
                    dict(list(reasons.items())[:8]) or
                    {"screen": "no candidate survived screening"}))
                continue
            if req.request_id in self.degraded_ids:
                # load-shed design tier: the ordinal frontier IS the
                # answer — explicit degraded mark, no certificates, no
                # certified round
                frontier = build_frontier(spec, case, report, None,
                                          fidelity=FIDELITY_DEGRADED,
                                          request_id=req.request_id)
                frontier.run_health = {"fidelity": FIDELITY_DEGRADED,
                                       "design": frontier.screen}
                frontier.request_latency_s = \
                    time.monotonic() - req.t_submit
                self.stats["degraded"] += 1
                req.future.set_result(frontier)
                self.answered.append(req)
                continue
            self.stats["finalists"] += len(finalists)
            risk = None
            if spec.risk is not None:
                # risk-aware mode: the finalist x sample MC cloud is a
                # screening-tier batch, so it runs HERE against the
                # service's persistent screening caches; delivery merges
                # the numbers into the certified frontier
                from ..stochastic.engine import evaluate_finalist_risk
                try:
                    risk = evaluate_finalist_risk(
                        case, finalists, spec.risk_spec(),
                        backend=self.backend, device=self.device,
                        solver_opts=self.solver_opts, caches=self.caches,
                        supervisor=self.supervisor,
                        request_id=req.request_id)
                except PreemptedError as e:
                    self._restore_request_span(req)
                    self._preempt_all(self.requests[i:], e)
                    raise
                except Exception as e:
                    self._restore_request_span(req)
                    TellUser.error(f"design request {req.request_id}: "
                                   f"risk evaluation failed: {e}")
                    self._answer(req, e)
                    continue
            req.design_state = DesignState(spec, case, report, finalists,
                                           risk=risk)
            req.cases = {candidate_key(e.candidate):
                         candidate_case(case, e.candidate)
                         for e in finalists}
            self.finalist_requests.append(req)
            TellUser.info(
                f"design request {req.request_id}: screened "
                f"{len(report.entries)} candidate(s) in "
                f"{time.monotonic() - t0:.2f}s -> {len(finalists)} "
                "finalist(s) join the certified round")


# ---------------------------------------------------------------------------
# Spool front end: design.json request files
# ---------------------------------------------------------------------------

def is_design_payload(payload) -> bool:
    return isinstance(payload, dict) and "design" in payload


def parse_design_request(payload: Dict, base_path=None):
    """Parse a spool ``design.json`` payload into ``(case, spec)``.

    Shape::

        {"design": {
            "parameters": "path/to/model_params.csv",   # required
            "der": "Battery", "der_id": "1",            # sized DER
            "kw": [200, 2000], "kwh": [500, 8000],      # bounds
            "population": 512, "top_k": 8,
            "budget": 1.5e6,                # optional capex cap
            "duration_hours": [1, 8],       # optional ESS coupling
            "grid": [[500, 1000], ...],     # optional explicit points
            "refine_rounds": 1, "refine_keep": 0.25,
            "risk": {"samples": 256, "seed": 0, "alpha": 0.95}
                                            # optional risk-aware mode
        }}

    Multi-DER specs use ``"bounds": {"Battery:1": {"kw": [..],
    "kwh": [..]}, "PV:1": {"kw": [..]}}`` instead of der/kw/kwh."""
    d = payload.get("design")
    if not isinstance(d, dict):
        raise ParameterError("design request: 'design' must be an object")
    params = d.get("parameters")
    if not params:
        raise ParameterError(
            "design request: 'design.parameters' (model-parameters file "
            "path) is required")

    def _pair(v, what):
        if v is None:
            return None
        if not isinstance(v, (list, tuple)) or len(v) != 2:
            raise ParameterError(
                f"design request: {what} must be a [lo, hi] pair")
        return (float(v[0]), float(v[1]))

    bounds: Dict = {}
    if isinstance(d.get("bounds"), dict):
        for name, b in d["bounds"].items():
            tag, _, der_id = str(name).partition(":")
            bounds[(tag, der_id or "1")] = DERBounds(
                kw=_pair(b.get("kw"), f"bounds[{name}].kw"),
                kwh=_pair(b.get("kwh"), f"bounds[{name}].kwh"))
    else:
        tag = str(d.get("der", "Battery"))
        der_id = str(d.get("der_id", "1"))
        bounds[(tag, der_id)] = DERBounds(
            kw=_pair(d.get("kw"), "kw"), kwh=_pair(d.get("kwh"), "kwh"))
    grid = d.get("grid")
    if grid is not None:
        grid = [(float(a), float(b)) for a, b in grid]
    spec = DesignSpec(
        bounds=bounds,
        population=int(d.get("population", 512)),
        top_k=int(d.get("top_k", 8)),
        budget=(float(d["budget"]) if d.get("budget") is not None
                else None),
        duration_hours=_pair(d.get("duration_hours"), "duration_hours"),
        grid=grid,
        refine_rounds=int(d.get("refine_rounds", 1)),
        refine_keep=float(d.get("refine_keep", 0.25)),
        risk=d.get("risk"))
    spec.validate()     # spec errors surface before any file IO
    from pathlib import Path
    p = Path(params)
    if not p.is_absolute() and base_path is not None:
        p = Path(base_path) / p
    cases = Params.initialize(p, base_path=base_path)
    if len(cases) != 1:
        raise ParameterError(
            f"design request: {params} expands to {len(cases)} "
            "sensitivity cases — a design request sizes ONE case")
    case = cases[min(cases)]
    return case, spec
