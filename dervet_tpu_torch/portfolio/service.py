"""Portfolio requests through the scenario service.

A ``portfolio`` request rides the same front door as scenario/design
requests — bounded priority admission, deadlines, backpressure, poison
blocklist — and runs as its OWN round inside the batch cycle
(:class:`PortfolioRound`): each request's dual loop dispatches through
the SERVICE's persistent solver cache, so a portfolio inherits the hot
service's solvers and warm-start memory, and repeated
portfolio requests re-amortize everything the first one paid.  A
load-SHED portfolio request runs the degraded tier (screening inner
solves, certification disabled thread-locally, answer explicitly
marked, never certificate-stamped).

Spool front end: a JSON file with a top-level ``"portfolio"`` object
dropped in ``incoming/`` becomes a portfolio request; the answer set
(``portfolio.json`` + aggregate CSV) lands in ``results/<rid>/``.

This module deliberately imports nothing from ``dervet_tpu_torch.service``
(the service imports US); typed errors live in ``utils.errors``.
"""
from __future__ import annotations

import hashlib
import time
from typing import Dict, List, Optional

from ..telemetry import trace as telemetry_trace
from ..utils.errors import (DeadlineExpiredError, ParameterError,
                            PreemptedError, RequestPreemptedError,
                            TellUser)
from .spec import PortfolioSpec
from .solve import solve_portfolio


def portfolio_fingerprint(spec: PortfolioSpec) -> str:
    """Content fingerprint of a portfolio request (poison-registry /
    blocklist key): every member's content hash plus the normalized
    coupling knobs."""
    from ..service import resilience
    h = hashlib.sha256()
    for key in sorted(spec.members, key=str):
        h.update(str(key).encode())
        h.update(resilience.case_fingerprint(spec.members[key]).encode())
    h.update(spec.fingerprint_knobs().encode())
    return h.hexdigest()


class PortfolioRound:
    """The portfolio phase of one batch cycle: run each portfolio
    request's dual loop against the service's persistent caches and
    answer its future.  Every failure mode answers the future HERE — a
    portfolio request can never leak an unresolved future."""

    def __init__(self, requests: List, *, backend: str, solver_opts=None,
                 solver_cache=None, degraded_cache=None,
                 degraded_ids=(), supervisor=None, board=None,
                 device=None):
        self.requests = requests
        self.backend = backend
        self.device = device
        self.solver_opts = solver_opts
        self.solver_cache = solver_cache
        self.degraded_cache = degraded_cache
        self.degraded_ids = set(degraded_ids)
        self.supervisor = supervisor
        self.board = board
        self.answered: List = []
        self.stats = {"requests": 0, "outer_rounds": 0, "windows": 0,
                      "dual_iterate_seeds": 0, "degraded": 0,
                      "infeasible": 0, "failed": 0, "portfolio_s": 0.0}
        self.last_portfolio: Optional[Dict] = None

    def _preempt_all(self, pending, e) -> None:
        for req in pending:
            if not req.future.done():
                req.future.set_exception(RequestPreemptedError(
                    f"portfolio request {req.request_id!r} preempted "
                    f"mid-dual-loop ({e}); resubmit to a live service "
                    "(the dual loop replays, warm-started from the "
                    "service's solution memory)"))
                self.answered.append(req)

    def run(self) -> None:
        for i, req in enumerate(self.requests):
            if req.expired():
                req.future.set_exception(DeadlineExpiredError(
                    f"portfolio request {req.request_id!r} expired "
                    "before its dual loop started"))
                self.answered.append(req)
                continue
            degraded = req.request_id in self.degraded_ids
            cache = (self.degraded_cache if degraded
                     else self.solver_cache)
            t0 = time.monotonic()
            # telemetry: the outer dual loop is one span; the inner
            # dispatch-group spans parent under it via the rid registry
            # (re-pointed here, restored when it ends)
            span = telemetry_trace.start_span(
                "portfolio_dual_loop", rid=req.request_id,
                attrs={"backend": self.backend, "degraded": degraded,
                       "members": len(req.portfolio_spec.members)})
            if span:
                telemetry_trace.register_request(req.request_id, span)
                if degraded:
                    span.event("load_shed",
                               reason="portfolio answered by the "
                                      "degraded screening tier")
            try:
                result = solve_portfolio(
                    req.portfolio_spec, backend=self.backend,
                    solver_opts=self.solver_opts, solver_cache=cache,
                    supervisor=self.supervisor,
                    breaker_board=self.board,
                    request_id=req.request_id, degraded=degraded,
                    device=self.device)
            except PreemptedError as e:
                span.end(error=e)
                self._preempt_all(self.requests[i:], e)
                raise
            except Exception as e:
                from ..utils.errors import PortfolioInfeasibleError
                if isinstance(e, PortfolioInfeasibleError):
                    self.stats["infeasible"] += 1
                    span.event("coupling_infeasible")
                else:
                    self.stats["failed"] += 1
                span.end(error=e)
                self._restore_request_span(req)
                TellUser.error(f"portfolio request {req.request_id}: "
                               f"{type(e).__name__}: {e}")
                req.future.set_exception(e)
                self.answered.append(req)
                continue
            self.stats["requests"] += 1
            self.stats["outer_rounds"] += result.outer_rounds
            self.stats["windows"] += sum(
                r.get("windows", 0) for r in result.rounds)
            self.stats["dual_iterate_seeds"] += sum(
                r.get("dual_iterate", 0) for r in result.rounds)
            self.stats["portfolio_s"] += time.monotonic() - t0
            if degraded:
                self.stats["degraded"] += 1
            self.last_portfolio = result.portfolio_section()
            if span:
                span.set_attrs({
                    "outer_rounds": result.outer_rounds,
                    "windows": sum(r.get("windows", 0)
                                   for r in result.rounds),
                    "dual_iterate_seeds": sum(r.get("dual_iterate", 0)
                                              for r in result.rounds),
                    "gap": self.last_portfolio.get("gap"),
                })
                span.end()
                self._restore_request_span(req)
            result.request_latency_s = time.monotonic() - req.t_submit
            req.future.set_result(result)
            self.answered.append(req)

    @staticmethod
    def _restore_request_span(req) -> None:
        """Point the rid registry back at the request root span once the
        dual-loop span ended (delivery-time spans parent correctly)."""
        root = getattr(req, "span", None)
        if root is not None:
            telemetry_trace.register_request(req.request_id, root)


# ---------------------------------------------------------------------------
# Spool front end: portfolio.json request files
# ---------------------------------------------------------------------------

def is_portfolio_payload(payload) -> bool:
    return isinstance(payload, dict) and "portfolio" in payload


def parse_portfolio_request(payload: Dict,
                            base_path=None) -> PortfolioSpec:
    """Parse a spool ``portfolio.json`` payload into a
    :class:`PortfolioSpec`.

    Shape::

        {"portfolio": {
            "members": [                       # one entry per site
                {"key": "siteA",
                 "parameters": "path/to/model_params.csv"},
                ...
            ],
            # OR, for harness/CI runs without reference datasets:
            "synthetic_members": {"sites": 16, "months": 1, "seed": 0},
            "export_cap_kw": 5000.0,           # scalar or per-step list
            "import_cap_kw": 20000.0,
            "export_bid_kw": null,
            "demand_charge_per_kw": null,
            "gap_tol": 1e-3, "feas_tol": 1e-4,
            "max_outer": 12
        }}
    """
    d = payload.get("portfolio")
    if not isinstance(d, dict):
        raise ParameterError(
            "portfolio request: 'portfolio' must be an object")
    members: Dict[str, object] = {}
    if d.get("members"):
        from pathlib import Path

        from ..io.params import Params
        for i, m in enumerate(d["members"]):
            params = (m or {}).get("parameters")
            if not params:
                raise ParameterError(
                    f"portfolio request: members[{i}].parameters "
                    "(model-parameters file path) is required")
            p = Path(params)
            if not p.is_absolute() and base_path is not None:
                p = Path(base_path) / p
            cases = Params.initialize(p, base_path=base_path)
            if len(cases) != 1:
                raise ParameterError(
                    f"portfolio request: members[{i}] expands to "
                    f"{len(cases)} sensitivity cases — each member is "
                    "ONE site")
            members[str(m.get("key", f"site{i:03d}"))] = \
                cases[min(cases)]
    elif d.get("synthetic_members"):
        sm = d["synthetic_members"]
        members = synthetic_portfolio_members(
            int(sm.get("sites", 4)), months=int(sm.get("months", 1)),
            seed=int(sm.get("seed", 0)),
            hours=(int(sm["hours"]) if sm.get("hours") else None),
            window=sm.get("window"))
    else:
        raise ParameterError("portfolio request: provide 'members' or "
                             "'synthetic_members'")

    def _num(v):
        if v is None:
            return None
        return [float(x) for x in v] if isinstance(v, list) else float(v)

    spec = PortfolioSpec(
        members=members,
        export_cap_kw=_num(d.get("export_cap_kw")),
        import_cap_kw=_num(d.get("import_cap_kw")),
        export_bid_kw=_num(d.get("export_bid_kw")),
        demand_charge_per_kw=(
            None if d.get("demand_charge_per_kw") is None
            else float(d["demand_charge_per_kw"])),
        gap_tol=float(d.get("gap_tol", 1e-3)),
        feas_tol=float(d.get("feas_tol", 1e-4)),
        max_outer=int(d.get("max_outer", 12)),
        price_cap=(None if d.get("price_cap") is None
                   else float(d["price_cap"])),
        max_columns=int(d.get("max_columns", 20)))
    return spec.validate()


def synthetic_portfolio_members(n_sites: int, months: int = 1,
                                seed: int = 0,
                                hours: Optional[int] = None,
                                window=None,
                                pv_kw: float = 9000.0
                                ) -> Dict[str, object]:
    """A synthetic N-site fleet for benches/smokes/tests: each site is
    the Battery+PV+DA case with its OWN price/load realization (per-site
    seed) and a swept battery rating — genuinely different sites that
    still share one LP structure, so they co-batch.  The default PV
    rating makes each site a midday NET EXPORTER (load ~5 MW, PV 9 MW),
    so an aggregate export cap is a genuinely binding coupling row."""
    import dataclasses as _dc

    from ..benchlib import synthetic_case
    members: Dict[str, object] = {}
    for i in range(n_sites):
        c = synthetic_case(seed=seed + i, pv_kw=pv_kw,
                           n=(window if window is not None else "month"))
        c = _dc.replace(c, case_id=i)
        for tag, _, keys in c.ders:
            if tag == "Battery":
                keys["ene_max_rated"] = 8000.0 * (
                    0.7 + 0.6 * i / max(n_sites - 1, 1))
        ts = c.datasets.time_series
        if hours:
            c.datasets.time_series = ts.iloc[:hours]
            c.scenario["allow_partial_year"] = True
        elif months:
            c.datasets.time_series = ts.loc[ts.index.month <= months]
            c.scenario["allow_partial_year"] = True
        members[f"site{i:03d}"] = c
    return members
