"""Client-side conveniences for the scenario service.

The service is in-process (a network front end would wrap
:class:`~dervet_tpu_torch.service.server.ScenarioService` behind whatever
transport a deployment uses); this module provides the client-side
discipline such a front end needs anyway: retry-after handling for
backpressure rejections and a blocking solve wrapper.
"""
from __future__ import annotations

import inspect
import pickle
import random
import time
from concurrent.futures import Future
from typing import Optional

from ..utils.errors import TellUser
from .queue import QueueFullError


class ScenarioClient:
    """Thin client over a :class:`ScenarioService` — or a
    :class:`~dervet_tpu_torch.service.router.FleetRouter`, which exposes the
    same ``submit`` surface.

    ``submit`` honors the backpressure contract end-to-end: a
    :class:`~dervet_tpu_torch.service.queue.QueueFullError` carries a
    ``retry_after_s`` hint (derived from the service's observed drain
    rate), and the client sleeps it out — CAPPED and JITTERED — and
    retries up to ``max_retries`` times before surfacing the rejection.
    Router redirects preserve the discipline: when every replica behind
    a fleet router rejects, the router raises
    :class:`~dervet_tpu_torch.utils.errors.FleetUnavailableError` — a
    ``QueueFullError`` whose ``retry_after_s`` is the SMALLEST hint any
    replica offered — so the per-replica drain-rate hint survives the
    routing hop and the same capped ±25% backoff applies unchanged.
    The jitter matters at fleet scale: a burst of rejected clients all
    honoring the same hint verbatim would re-arrive in one synchronized
    spike and re-overload the fleet they just backed off from."""

    def __init__(self, service, max_retries: int = 3,
                 backoff_cap_s: float = 30.0, jitter_frac: float = 0.25,
                 jitter_seed: Optional[int] = None):
        self.service = service
        self.max_retries = int(max_retries)
        self.backoff_cap_s = float(backoff_cap_s)
        self.jitter_frac = float(jitter_frac)
        # seedable so drills/tests are deterministic
        self._rng = random.Random(jitter_seed)

    def _backoff_s(self, hint: float) -> float:
        """Cap the server's hint, then jitter ±jitter_frac around it."""
        wait = min(float(hint), self.backoff_cap_s)
        if self.jitter_frac > 0:
            wait *= 1.0 + self._rng.uniform(-self.jitter_frac,
                                            self.jitter_frac)
        return max(0.0, wait)

    def _submit_with_retry(self, label: str, attempt_fn) -> Future:
        """The one retry discipline every request type shares: bounded
        attempts, capped ±jittered backoff on the server's retry-after
        hint (see class docstring)."""
        attempt = 0
        while True:
            try:
                return attempt_fn()
            except QueueFullError as e:
                attempt += 1
                if attempt > self.max_retries:
                    raise
                wait = self._backoff_s(e.retry_after_s)
                TellUser.info(
                    f"client: queue full, {label}retry {attempt}/"
                    f"{self.max_retries} in {wait:.2f}s")
                time.sleep(wait)

    def submit(self, cases, *, request_id=None, priority: int = 0,
               deadline_s: Optional[float] = None) -> Future:
        """Admit with bounded, jittered retry-after backoff on
        queue-full.

        Serialize ONCE: against a fleet router, the case payload is
        pickled and content-digested here, before the retry loop, and
        the same bytes/digest ride every attempt — a queue-full storm
        used to re-pickle the full payload per attempt (and the router
        needs the digest for its request-cache key anyway)."""
        kwargs = {}
        try:
            params = inspect.signature(self.service.submit).parameters
        except (TypeError, ValueError):
            params = {}
        if "cases_blob" in params and "content_digest" in params:
            if not isinstance(cases, dict):
                cases = dict(enumerate(cases))
            try:
                from . import reqcache
                kwargs["cases_blob"] = pickle.dumps(
                    cases, protocol=pickle.HIGHEST_PROTOCOL)
                kwargs["content_digest"] = \
                    reqcache.request_content_digest(cases)
            except Exception:       # fall back to the plain path
                kwargs = {}
        return self._submit_with_retry(
            "", lambda: self.service.submit(cases,
                                            request_id=request_id,
                                            priority=priority,
                                            deadline_s=deadline_s,
                                            **kwargs))

    def solve(self, cases, *, timeout: Optional[float] = None,
              **kwargs):
        """Submit and block for the request's
        :class:`~dervet_tpu_torch.results.result.Result`.  Check
        ``result.fidelity`` — a ``"degraded"`` answer was load-shed to
        the screening tier and should be resubmitted (see
        ``result.resubmit_hint``) when a certified answer is needed."""
        return self.submit(cases, **kwargs).result(timeout=timeout)

    def submit_design(self, case, spec=None, *, request_id=None,
                      priority: int = 0,
                      deadline_s: Optional[float] = None,
                      **spec_kwargs) -> Future:
        """Admit a DESIGN request (BOOST sizing frontier) with the same
        bounded, jittered retry-after backoff as :meth:`submit`."""
        return self._submit_with_retry(
            "design ", lambda: self.service.submit_design(
                case, spec, request_id=request_id, priority=priority,
                deadline_s=deadline_s, **spec_kwargs))

    def design(self, case, spec=None, *,
               timeout: Optional[float] = None, **kwargs):
        """Submit a design request and block for its
        :class:`~dervet_tpu_torch.design.frontier.DesignFrontier`.  Check
        ``frontier.fidelity`` — a ``"degraded"`` frontier was load-shed
        and is ranked by the ordinal screen only (no certificates)."""
        return self.submit_design(case, spec, **kwargs).result(
            timeout=timeout)

    def submit_montecarlo(self, case, spec=None, *, request_id=None,
                          priority: int = 0,
                          deadline_s: Optional[float] = None,
                          **spec_kwargs) -> Future:
        """Admit a MONTE-CARLO request (batched uncertainty valuation)
        with the same bounded, jittered retry-after backoff as
        :meth:`submit`."""
        return self._submit_with_retry(
            "montecarlo ", lambda: self.service.submit_montecarlo(
                case, spec, request_id=request_id, priority=priority,
                deadline_s=deadline_s, **spec_kwargs))

    def montecarlo(self, case, spec=None, *,
                   timeout: Optional[float] = None, **kwargs):
        """Submit a monte-carlo request and block for its
        :class:`~dervet_tpu_torch.stochastic.distribution.MCDistribution`.
        Check ``result.fidelity`` — a ``"degraded"`` distribution was
        load-shed to a reduced screening-tier sample set and carries no
        certificates."""
        return self.submit_montecarlo(case, spec, **kwargs).result(
            timeout=timeout)

    def submit_portfolio(self, spec, *, request_id=None,
                         priority: int = 0,
                         deadline_s: Optional[float] = None) -> Future:
        """Admit a PORTFOLIO request (coupled-fleet co-optimization)
        with the same bounded, jittered retry-after backoff as
        :meth:`submit`."""
        return self._submit_with_retry(
            "portfolio ", lambda: self.service.submit_portfolio(
                spec, request_id=request_id, priority=priority,
                deadline_s=deadline_s))

    def portfolio(self, spec, *, timeout: Optional[float] = None,
                  **kwargs):
        """Submit a portfolio request and block for its
        :class:`~dervet_tpu_torch.portfolio.solve.PortfolioResult`.  Check
        ``result.fidelity`` — a ``"degraded"`` answer was load-shed to
        the screening tier and carries no certificates."""
        return self.submit_portfolio(spec, **kwargs).result(
            timeout=timeout)
