"""Certified design frontier: exact solves + certificates for the top-k.

The ordinal screen (``design/screen.py``) picks finalists; this module
gives them the full-trust treatment — a fresh dispatch at the certified
tier (default tolerances, escalation ladder, PR-4 float64 certification
of every window) — and assembles the :class:`DesignFrontier` result: the
ranked certified frontier, the full screened population surface, the
screening-vs-final rank correlation (the ordinal-optimization health
metric: a low correlation means the screen is too loose to trust its
cut), and a dominated-candidate mask over the (capex, operating value)
trade-off.

``run_design`` is the one-shot engine — population -> screen -> certify
-> frontier — used by the CLI and the ``sizing_sweep`` compatibility
shim.  The pieces are public so a serving layer can drive them through
its own batcher.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import pandas as pd

from ..scenario.scenario import MicrogridScenario, run_dispatch
from ..utils.errors import AggregatedSolverError, SolverError, TellUser
from .population import Candidate, DesignSpec, candidate_case, \
    generate_population
from .screen import (ScreenReport, ScreeningCaches, annuity_factor,
                     dispatch_device, score_scenario, screen_candidates,
                     target_capex)

# answer-fidelity marks (mirrors service.resilience without importing it
# — design must stay import-clean of the service package)
FIDELITY_CERTIFIED = "certified"
FIDELITY_DEGRADED = "degraded"


def spearman_rank(a, b) -> Optional[float]:
    """Spearman rank correlation of two paired score vectors (ranks
    computed here; ties get average ranks).  None below 2 points."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    if a.size < 2:
        return None

    def rankdata(v):
        order = np.argsort(v, kind="stable")
        ranks = np.empty(v.size, dtype=float)
        sv = v[order]
        i = 0
        while i < v.size:
            j = i
            while j + 1 < v.size and sv[j + 1] == sv[i]:
                j += 1
            ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
            i = j + 1
        return ranks

    ra, rb = rankdata(a), rankdata(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = float(np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))
    if denom == 0.0:
        return 1.0      # all ties on both sides: order is vacuously kept
    return round(float((ra * rb).sum() / denom), 4)


def dominated_mask(capex, operating_value, cvar=None) -> np.ndarray:
    """Pareto dominance over (capex, operating value) — both
    lower-is-better (operating value is a cost; negative = net benefit).
    Entry i is dominated when some j is at least as good on both axes
    and strictly better on one.  ``cvar`` (risk-aware design mode) adds
    a third lower-is-better axis — CVaR of the operating-value
    distribution — so a design that buys tail-risk protection with a
    slightly worse expectation stays on the frontier."""
    c = np.asarray(capex, dtype=float)
    v = np.asarray(operating_value, dtype=float)
    axes = [c, v]
    if cvar is not None:
        axes.append(np.asarray(cvar, dtype=float))
    n = c.size
    out = np.zeros(n, dtype=bool)
    for i in range(n):
        better_eq = np.ones(n, dtype=bool)
        strictly = np.zeros(n, dtype=bool)
        for a in axes:
            better_eq &= a <= a[i]
            strictly |= a < a[i]
        out[i] = bool(np.any(better_eq & strictly & (np.arange(n) != i)))
    return out


def candidate_key(cand: Candidate) -> str:
    """The finalist's case key inside a request (``cand0007``) — shared
    by the one-shot engine and the service batcher so frontier assembly
    can map solved scenarios back to candidates."""
    return f"cand{cand.index:04d}"


def certified_ok(scenario) -> bool:
    """Did every window of this finalist's dispatch end with an accepted
    float64 certificate?  (The PR-4 contract: certified +
    certified_loose cover all windows, no final rejections, no
    quarantine.)"""
    if scenario.quarantine is not None:
        return False
    cert = getattr(scenario, "certification", None) or {}
    if not cert.get("enabled"):
        return False
    n_ok = int(cert.get("certified", 0)) + int(cert.get("certified_loose",
                                                        0))
    return not int(cert.get("rejected_final", 0)) and \
        n_ok >= len(scenario.windows)


class DesignFrontier:
    """The design request's answer: a ranked certified frontier plus the
    screened population surface it was cut from.

    Attributes mirror the serving layer's :class:`Result` contract where
    the spool loop touches them (``fidelity`` / ``resubmit_hint`` /
    ``request_id`` / ``request_latency_s`` / ``run_health`` /
    ``solve_ledger`` / ``save_as_csv``), so a design request rides the
    same delivery path as a scenario request."""

    def __init__(self, *, population: pd.DataFrame, frontier: pd.DataFrame,
                 rank_correlation: Optional[float], screen: Dict,
                 spec: Dict, fidelity: str = FIDELITY_CERTIFIED,
                 request_id: Optional[str] = None):
        self.population = population
        self.frontier = frontier
        self.rank_correlation = rank_correlation
        self.screen = screen            # screening stats (rounds, rates)
        self.spec = spec                # DesignSpec.normalized()
        self.fidelity = fidelity
        self.resubmit_hint: Optional[str] = None
        self.request_id = request_id
        self.request_latency_s: Optional[float] = None
        self.run_health: Optional[Dict] = None
        self.solve_ledger: Optional[Dict] = None

    # ------------------------------------------------------------------
    @property
    def winner(self) -> Optional[pd.Series]:
        """The frontier's rank-1 candidate (None for an empty frontier)."""
        if self.frontier is None or not len(self.frontier):
            return None
        return self.frontier.iloc[0]

    @property
    def all_finalists_certified(self) -> bool:
        return bool(len(self.frontier)) and \
            bool(self.frontier["certified"].all())

    def as_dict(self) -> Dict:
        """JSON payload (design_frontier.json)."""
        return {
            "request_id": self.request_id,
            "fidelity": self.fidelity,
            "resubmit_hint": self.resubmit_hint,
            "spec": self.spec,
            "rank_correlation": self.rank_correlation,
            "screen": self.screen,
            "frontier": json.loads(
                self.frontier.to_json(orient="records")),
            "population_size": int(len(self.population)),
        }

    def save_as_csv(self, out_dir=None) -> None:
        """Results-layer serialization: the ranked frontier and the full
        population surface as CSVs, the machine-readable frontier +
        screening stats as JSON, plus the request's run-health report —
        all atomic writes."""
        from ..io.summary import run_artifact_name
        from ..utils.supervisor import atomic_output, atomic_write
        out = Path(out_dir or "Results")
        out.mkdir(parents=True, exist_ok=True)
        with atomic_output(out / "design_frontier.csv") as tmp:
            self.frontier.to_csv(tmp, index=False)
        with atomic_output(out / "design_population.csv") as tmp:
            self.population.to_csv(tmp, index=False)
        atomic_write(out / "design_frontier.json",
                     json.dumps(self.as_dict(), indent=2, default=str))
        if self.run_health is not None:
            atomic_write(out / run_artifact_name("run_health.json",
                                                 self.request_id),
                         json.dumps(self.run_health, indent=2))
        if self.request_id is not None and self.solve_ledger is not None:
            atomic_write(out / run_artifact_name("solve_ledger.json",
                                                 self.request_id),
                         json.dumps(self.solve_ledger, indent=2))
        TellUser.info(f"design frontier saved to {out}")


# ---------------------------------------------------------------------------
# Frontier assembly (shared by the one-shot engine and the service)
# ---------------------------------------------------------------------------

def build_frontier(spec: DesignSpec, case, report: ScreenReport,
                   final_scens: Optional[Dict[int, MicrogridScenario]],
                   *, fidelity: str = FIDELITY_CERTIFIED,
                   request_id: Optional[str] = None,
                   risk_eval: Optional[Dict] = None) -> DesignFrontier:
    """Assemble the :class:`DesignFrontier` from the screening report and
    (for the certified tier) the finalists' exactly-solved scenarios
    keyed by candidate index.  ``final_scens=None`` builds a
    screening-only DEGRADED frontier (the load-shed answer): ranked by
    the ordinal screen, certified=False everywhere, explicit resubmit
    hint.  ``risk_eval`` (risk-aware mode: per-candidate-index dicts
    from :func:`~dervet_tpu_torch.stochastic.engine.evaluate_finalist_risk`)
    merges ``mc_mean``/``mc_cvar`` columns in and adds CVaR as a third
    Pareto-dominance axis."""
    finalists = report.top(spec.top_k)
    population = report.table()
    targets = {(t, di or "1") for e in finalists
               for (t, di, _, _) in e.candidate.sizes}
    rows = []
    for e in finalists:
        row: Dict = {"candidate": e.candidate.index}
        single = len(e.candidate.sizes) == 1
        for tag, der_id, kw, kwh in e.candidate.sizes:
            prefix = "" if single else f"{tag}:{der_id or '1'} "
            if kw is not None:
                row[f"{prefix}kW"] = kw
            if kwh is not None:
                row[f"{prefix}kWh"] = kwh
        row.update({"screen_total": e.total,
                    "screen_rank": e.screen_rank,
                    "screen_round": e.screen_round})
        if final_scens is not None:
            s = final_scens.get(e.candidate.index)
            if s is None:
                row.update({"certified": False, "capex": e.capex,
                            "operating_value": float("nan"),
                            "total": float("nan"),
                            "lifetime_npv": float("nan"),
                            "reason": "finalist solve missing"})
            else:
                op = (score_scenario(s) if s.quarantine is None
                      else float("nan"))
                capex = target_capex(s, targets)
                annuity = annuity_factor(case, s)
                row.update({
                    "operating_value": op, "capex": capex,
                    "total": op + capex,
                    "lifetime_npv": -capex - op * annuity,
                    "certified": certified_ok(s),
                    "reason": (s.quarantine or {}).get("reason")
                    if s.quarantine else None})
        else:
            # degraded tier: the screening numbers ARE the answer
            row.update({"operating_value": e.operating_value,
                        "capex": e.capex, "total": e.total,
                        "lifetime_npv": e.lifetime_npv,
                        "certified": False, "reason": e.reason})
        if risk_eval is not None:
            row.update(risk_eval.get(e.candidate.index) or {
                "mc_mean": float("nan"), "mc_cvar": float("nan"),
                "mc_samples": 0, "mc_alpha": float("nan"),
                "mc_quarantined": 0})
        rows.append(row)
    frontier = pd.DataFrame(rows)
    if len(frontier):
        frontier = frontier.sort_values(
            ["total", "candidate"], na_position="last").reset_index(
            drop=True)
        frontier["final_rank"] = np.arange(1, len(frontier) + 1)
        frontier["dominated"] = dominated_mask(
            frontier["capex"].to_numpy(),
            frontier["operating_value"].to_numpy(),
            cvar=(frontier["mc_cvar"].to_numpy()
                  if risk_eval is not None else None))
    corr = None
    if len(frontier) and final_scens is not None:
        solved = frontier[np.isfinite(frontier["total"])]
        if len(solved) >= 2:
            corr = spearman_rank(solved["screen_rank"].to_numpy(),
                                 solved["final_rank"].to_numpy())
    elif len(frontier):
        corr = 1.0      # degraded frontier IS the screening order
    out = DesignFrontier(
        population=population, frontier=frontier, rank_correlation=corr,
        screen={
            "rounds": report.rounds,
            "screen_s": report.screen_s,
            "candidates_per_s": report.candidates_per_s,
            "dispatches": report.dispatches,
            "compile_events": report.compile_events,
            "candidates": len(report.entries),
            "converged": len(report.converged),
            "certification_stamped": report.certification_enabled,
        },
        spec=spec.normalized(), fidelity=fidelity, request_id=request_id)
    if fidelity == FIDELITY_DEGRADED:
        out.resubmit_hint = (
            "degraded-fidelity design answer: the frontier is ranked by "
            "the ordinal screen only and carries NO certificates — "
            "resubmit (higher priority) for a certified frontier")
    return out


# ---------------------------------------------------------------------------
# One-shot engine
# ---------------------------------------------------------------------------

def certify_finalists(case, finalists, *, backend: str = "torch",
                      device=None, solver_opts=None, solver_cache=None,
                      supervisor=None, request_id: Optional[str] = None,
                      id_prefix: str = "design"
                      ) -> Dict[int, MicrogridScenario]:
    """Exactly solve + certify the finalist candidates (fresh scenarios
    — screening solutions are ordinal throwaways and must never leak
    into the certified answer).  Certification runs under the ambient
    (env) policy: every window gets the PR-4 float64 certificate and
    rejections climb the escalation ladder.  Returns scenarios keyed by
    candidate index; a finalist whose case quarantined stays in the map
    (the frontier reports it uncertified with its diagnosis)."""
    device = dispatch_device(backend, device)
    scens: Dict[int, MicrogridScenario] = {}
    for e in finalists:
        c = candidate_case(
            case, e.candidate,
            case_id=f"{id_prefix}.{candidate_key(e.candidate)}")
        s = MicrogridScenario(c)
        if request_id is not None:
            s.request_id = request_id
        scens[e.candidate.index] = s
    try:
        run_dispatch(list(scens.values()), backend=backend,
                     solver_opts=solver_opts, solver_cache=solver_cache,
                     supervisor=supervisor, device=device)
    except AggregatedSolverError:
        pass        # every finalist failed: the frontier reports it
    return scens


def run_design(case, spec: DesignSpec, *, backend: str = "torch",
               device=None, solver_opts=None, screen_opts_override=None,
               caches: Optional[ScreeningCaches] = None,
               final_cache=None, supervisor=None, certify: bool = True,
               request_id: Optional[str] = None) -> DesignFrontier:
    """The BOOST engine end to end: generate the population, screen it
    ordinally (certification off, thread-local), exactly solve + certify
    the top-k, and return the :class:`DesignFrontier`.

    ``certify=False`` returns the screening-only DEGRADED frontier (the
    service's load-shed design tier).  ``screen_opts_override`` pins one
    explicit screening option set for every round (the full-fidelity
    ``sizing_sweep`` shim).  ``device`` is where the 'torch' backend
    solves (``None`` -> the GPU, raising when none is visible;
    ``"cpu"`` runs the kernels' plain versions)."""
    spec.validate()
    device = dispatch_device(backend, device)
    t0 = time.monotonic()
    candidates = generate_population(spec)
    # the screening tiers and the certified finalist tier share one
    # warm-start SolutionMemory: tier i+1 seeds from tier i's iterates,
    # and the finalists seed from the tightest screening iterates —
    # every seeded solve still runs full convergence criteria (and the
    # finalists full certification), so a screening seed can only save
    # iterations, never leak a screening answer into the frontier
    caches = caches if caches is not None else ScreeningCaches(
        pad_grid=(backend != "cpu"), device=device)
    if final_cache is None and certify:
        from ..scenario.scenario import SolverCache
        final_cache = SolverCache(pad_grid=(backend != "cpu"),
                                  memory=caches.memory, device=device)
    report = screen_candidates(
        case, candidates, backend=backend, device=device,
        base_opts=solver_opts,
        screen_opts_override=screen_opts_override, caches=caches,
        refine_rounds=spec.refine_rounds, refine_keep=spec.refine_keep,
        top_k=spec.top_k, budget=spec.budget, supervisor=supervisor,
        request_id=request_id, screen_variant=spec.screen_variant)
    finalists = report.top(spec.top_k)
    if not finalists:
        reasons = sorted({e.reason for e in report.entries if e.reason})
        raise SolverError(
            "design: no candidate survived screening "
            f"({len(report.entries)} screened); reasons: "
            + ("; ".join(reasons[:3]) if reasons else "unknown"))
    if not certify:
        frontier = build_frontier(spec, case, report, None,
                                  fidelity=FIDELITY_DEGRADED,
                                  request_id=request_id)
    else:
        final_scens = certify_finalists(
            case, finalists, backend=backend, device=device,
            solver_opts=solver_opts, solver_cache=final_cache,
            supervisor=supervisor,
            request_id=request_id)
        risk_eval = None
        if spec.risk is not None:
            # risk-aware mode: one screening-tier dispatch over the
            # finalist x sample cross product (lazy import — stochastic
            # imports the design package)
            from ..stochastic.engine import evaluate_finalist_risk
            risk_eval = evaluate_finalist_risk(
                case, finalists, spec.risk_spec(), backend=backend,
                device=device, solver_opts=solver_opts, caches=caches,
                supervisor=supervisor, request_id=request_id)
        frontier = build_frontier(spec, case, report, final_scens,
                                  request_id=request_id,
                                  risk_eval=risk_eval)
        from ..io.summary import run_health_report
        by_key = {candidate_key(e.candidate):
                  final_scens[e.candidate.index] for e in finalists}
        health = run_health_report(
            {k: getattr(s, "health", {}) for k, s in by_key.items()},
            {k: s.quarantine for k, s in by_key.items()
             if s.quarantine is not None},
            certification_by_case={
                k: getattr(s, "certification", None)
                for k, s in by_key.items()})
        health["fidelity"] = frontier.fidelity
        health["design"] = frontier.screen
        frontier.run_health = health
        s0 = next(iter(final_scens.values()), None)
        if s0 is not None:
            frontier.solve_ledger = s0.solve_metadata.get("solve_ledger")
    frontier.request_latency_s = time.monotonic() - t0
    w = frontier.winner
    if w is not None:
        TellUser.info(
            "design: frontier of "
            f"{len(frontier.frontier)} finalist(s) from "
            f"{len(report.entries)} candidate(s); winner total "
            f"{w['total']:.0f} (screen rank {w['screen_rank']}, "
            f"rank correlation {frontier.rank_correlation})")
    return frontier
