"""Monte-Carlo requests through the scenario service.

A ``montecarlo`` request rides the SAME front door as a scenario
request — bounded priority admission, deadlines, backpressure, poison
blocklist — and the same delivery contract (a future, run-health and
ledger slices, spool serialization of the result).  Unlike a design
request, the MC round answers EVERY one of its futures itself: the
engine already runs both tiers (screening mass + certified
quantile-pinning re-solves) through its own ``run_dispatch`` calls, so
there is nothing left to join the certified :class:`BatchRound` with.

Load shed: a shed MC request runs the screening tier only over a
reduced sample count (``DERVET_TPU_MC_DEGRADED_SAMPLES``) and is
answered ``fidelity="degraded"`` with a resubmit hint — never
cert-stamped.

This module deliberately imports nothing from ``dervet_tpu_torch.service``
at module scope (the service imports US); the typed errors live in
``utils.errors``.
"""
from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional

from ..io.params import Params
from ..telemetry import trace as telemetry_trace
from ..utils.errors import (DeadlineExpiredError, ParameterError,
                            PreemptedError, RequestPreemptedError, TellUser)
from .engine import run_montecarlo
from .sampler import MCSpec, mc_spec_from_dict


def montecarlo_fingerprint(case, spec: MCSpec) -> str:
    """Content fingerprint of an MC request (poison-registry / blocklist
    key): the base case's content hash plus the normalized spec — the
    seed and sample count are IN the normalized spec, so two requests
    differing only in seed never share a fingerprint."""
    import json

    from ..service import resilience
    h = hashlib.sha256()
    h.update(resilience.case_fingerprint(case).encode())
    h.update(json.dumps(spec.normalized(), sort_keys=True).encode())
    return h.hexdigest()


class MonteCarloRound:
    """One batch cycle's Monte-Carlo requests, run back to back.

    Each request is ONE engine call (two ``run_dispatch`` rounds: the
    whole sample mass at the screening tier, the quantile-pinning
    samples at the certified tier) against the service's PERSISTENT
    caches — so across requests of the same case structure the solver
    builds amortize to zero.  Every failure mode answers the request's
    future here; an MC request can never leak an unresolved future."""

    def __init__(self, requests: List, *, backend: str, solver_opts=None,
                 caches=None, final_cache=None, degraded_ids=(),
                 supervisor=None, device=None):
        self.requests = requests
        self.backend = backend
        # the service's resolved device ('torch' backend; None -> cuda:0)
        self.device = device
        self.solver_opts = solver_opts
        self.caches = caches
        self.final_cache = final_cache
        self.degraded_ids = set(degraded_ids)
        self.supervisor = supervisor
        self.answered: List = []
        self.stats = {"requests": 0, "samples": 0, "certified_samples": 0,
                      "quarantined": 0, "degraded": 0, "mc_s": 0.0,
                      "dispatches": 0, "compile_events": 0}
        self.last_mc: Optional[Dict] = None

    def _answer(self, req, exc) -> None:
        if not req.future.done():
            req.future.set_exception(exc)
        self.answered.append(req)

    @staticmethod
    def _restore_request_span(req) -> None:
        root = getattr(req, "span", None)
        if root is not None:
            telemetry_trace.register_request(req.request_id, root)

    def _preempt_all(self, pending, e) -> None:
        """Drain signal mid-round: every unanswered MC request gets the
        typed resumable answer before the signal propagates — the engine
        has no mid-request checkpoints, so the resume is a clean
        resubmission (the seeded sampler replays the identical sample
        set)."""
        for req in pending:
            if not req.future.done():
                req.future.set_exception(RequestPreemptedError(
                    f"montecarlo request {req.request_id!r} preempted "
                    f"({e}); resubmit to a live service (the fixed seed "
                    "replays the identical sample set)"))
                self.answered.append(req)

    def run(self) -> None:
        for i, req in enumerate(self.requests):
            if req.expired():
                self._answer(req, DeadlineExpiredError(
                    f"montecarlo request {req.request_id!r} expired "
                    "before its round"))
                continue
            spec: MCSpec = req.mc_spec
            degraded = req.request_id in self.degraded_ids
            span = telemetry_trace.start_span(
                "monte_carlo", rid=req.request_id,
                attrs={"backend": self.backend,
                       "n_samples": spec.n_samples,
                       "seed": spec.seed,
                       "screen_tier": spec.screen_tier})
            if span:
                telemetry_trace.register_request(req.request_id, span)
            try:
                res = run_montecarlo(
                    req.mc_case, spec, backend=self.backend,
                    device=self.device,
                    solver_opts=self.solver_opts, caches=self.caches,
                    final_cache=self.final_cache,
                    supervisor=self.supervisor,
                    certify_tier=not degraded,
                    request_id=req.request_id)
            except PreemptedError as e:
                if span:
                    span.end(error=e)
                self._preempt_all(self.requests[i:], e)
                raise
            except Exception as e:
                if span:
                    span.end(error=e)
                self._restore_request_span(req)
                TellUser.error(f"montecarlo request {req.request_id}: "
                               f"{e}")
                self._answer(req, e)
                continue
            self.stats["requests"] += 1
            self.stats["samples"] += res.stats["n"]
            self.stats["certified_samples"] += res.tier_mix["certified"]
            self.stats["quarantined"] += res.tier_mix["quarantined"]
            self.stats["mc_s"] += res.engine.get("total_s", 0.0)
            self.stats["dispatches"] += res.engine.get("dispatches", 0)
            self.stats["compile_events"] += \
                res.engine.get("compile_events", 0)
            if degraded:
                self.stats["degraded"] += 1
            self.last_mc = {
                "request_id": req.request_id,
                "tier_mix": res.tier_mix,
                "rounds": res.engine.get("rounds", []),
                "dispatches": res.engine.get("dispatches", 0),
                "compile_events": res.engine.get("compile_events", 0),
            }
            if span:
                span.set_attrs({
                    "samples": res.stats["n"],
                    "tier_screening": res.tier_mix["screening"],
                    "tier_certified": res.tier_mix["certified"],
                    "quarantined": res.tier_mix["quarantined"],
                    "compile_events": res.engine.get("compile_events", 0),
                    "fidelity": res.fidelity,
                })
                if degraded:
                    span.event("load_shed",
                               reason="montecarlo answered from a "
                                      "reduced screening-tier sample "
                                      "set — degraded distribution")
                span.end()
                self._restore_request_span(req)
            res.request_latency_s = time.monotonic() - req.t_submit
            req.future.set_result(res)
            self.answered.append(req)


# ---------------------------------------------------------------------------
# Spool front end: montecarlo.json request files
# ---------------------------------------------------------------------------

def is_montecarlo_payload(payload) -> bool:
    return isinstance(payload, dict) and "montecarlo" in payload


def parse_montecarlo_request(payload: Dict, base_path=None):
    """Parse a spool ``montecarlo.json`` payload into ``(case, spec)``.

    Shape::

        {"montecarlo": {
            "parameters": "path/to/model_params.csv",   # required
            "samples": 1024, "seed": 0,                 # sampler
            "alpha": 0.95,
            "quantiles": [0.05, 0.25, 0.5, 0.75, 0.95],
            "price_sigma": 0.10, "price_shape_sigma": 0.02,
            "load_sigma": 0.05, "solar_sigma": 0.10,
            "screen_tier": 0
        }}
    """
    d = payload.get("montecarlo")
    if not isinstance(d, dict):
        raise ParameterError(
            "montecarlo request: 'montecarlo' must be an object")
    params = d.get("parameters")
    if not params:
        raise ParameterError(
            "montecarlo request: 'montecarlo.parameters' "
            "(model-parameters file path) is required")
    spec = mc_spec_from_dict(
        {k: v for k, v in d.items() if k != "parameters"})
    from pathlib import Path
    p = Path(params)
    if not p.is_absolute() and base_path is not None:
        p = Path(base_path) / p
    cases = Params.initialize(p, base_path=base_path)
    if len(cases) != 1:
        raise ParameterError(
            f"montecarlo request: {params} expands to {len(cases)} "
            "sensitivity cases — an MC request values ONE case")
    return cases[min(cases)], spec
