"""Ordinal screening: rank a candidate population with cheap solves.

The BOOST premise (PAPERS.md: arxiv 2501.10842): candidate RANKING
converges far earlier than candidate VALUE, so a loose-tolerance,
hard-budget PDHG solve (``PDHGOptions.screening``) of every candidate's
dispatch year is enough to pick the top-k worth an exact certified
solve.  Both fidelities are native here — screening rides the batched
device path through the existing ``run_dispatch`` pipeline (structure
grouping, bucket-grid padding, overlapped staging), certified finalists
ride the PR-4 path — so the screen is a policy change, not a new solver.

Fidelity contract: screening answers are ORDINAL ONLY.  The float64
certification layer is disabled for the screening dispatch via the PR-6
THREAD-LOCAL policy override (``ops.certify.policy_override``), scoped
to the dispatching thread — a certified scenario round solving
concurrently in the same process keeps its own policy, and a screening
answer can never end up certificate-stamped.

Iterative refinement: the population screens at the loosest tier, the
best ``refine_keep`` fraction re-screens at the next tighter tier, and
so on — each round's survivors are re-ranked on the tighter numbers
before the top-k are committed to finalists.  Each tier keeps its OWN
persistent :class:`SolverCache` (tiers differ in compiled solver
options; sharing one structure-keyed cache across tiers would hand a
loose-budget solver to a tight round).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from ..ops import certify
from ..ops.pdhg import PDHGOptions
from ..scenario.scenario import MicrogridScenario, SolverCache, run_dispatch
from ..utils.errors import AggregatedSolverError, ParameterError, TellUser
from .population import Candidate, candidate_case, guard_design_case

# refinement tiers: (eps_rel, eps_abs, max_iters) per round — tier 0 is
# the PDHGOptions.screening default, later tiers tighten toward (but
# never reach) the certified tier's tolerances
SCREEN_TIERS = (
    {"eps_rel": 1e-2, "eps_abs": 1e-3, "max_iters": 4096},
    {"eps_rel": 3e-3, "eps_abs": 3e-4, "max_iters": 8192},
    {"eps_rel": 1e-3, "eps_abs": 1e-4, "max_iters": 16384},
)


def screening_options(base: Optional[PDHGOptions], tier: int,
                      variant: Optional[str] = None) -> PDHGOptions:
    """The screening-tier solver options for refinement round ``tier``
    (clamped to the tightest tier).

    ``variant`` overrides the solver step variant for the screening
    tiers only (see ``ops.pdhg.PDHG_VARIANTS``): a screening solve is a
    HARD-BUDGET truncated solve whose ranking fidelity is set by how far
    the budget gets, so a faster-converging variant buys rank quality at
    the same candidate cost.  None inherits ``base`` (the service
    default); the ``DERVET_TPU_PDHG_VARIANT`` kill switch still wins at
    solver-build time."""
    t = SCREEN_TIERS[min(tier, len(SCREEN_TIERS) - 1)]
    opts = PDHGOptions.screening(base, max_iters=t["max_iters"])
    rep = {"eps_rel": t["eps_rel"], "eps_abs": t["eps_abs"]}
    if variant is not None:
        rep["variant"] = variant
    return dataclasses.replace(opts, **rep)


class ScreeningCaches:
    """Per-tier persistent :class:`SolverCache` set.  One instance lives
    on a long-lived caller across requests, so a warm caller screens
    with zero solver builds; the one-shot engine builds a throwaway.
    Every tier's solvers live on ``device`` (set by ``run_dispatch``
    when left None).

    Warm starts: every tier's cache shares ONE
    :class:`~dervet_tpu_torch.ops.warmstart.SolutionMemory` — tier i+1
    re-screens the same candidates, so its members near-match tier i's
    stored iterates and seed from them instead of starting cold (the
    tolerance tag keeps a looser tier's answer from ever SUBSTITUTING
    at a tighter tier; it can only seed).  ``memory`` injects an
    external memory (the design service shares the certified tier's, so
    finalists seed from the tightest screening iterates too)."""

    def __init__(self, pad_grid: bool = True, warm_start: bool = True,
                 memory=None, device=None):
        self.pad_grid = bool(pad_grid)
        self.device = device
        self._tiers: Dict[int, SolverCache] = {}
        if memory is not None:
            self.memory = memory
        elif warm_start:
            from ..ops import warmstart as _ws
            self.memory = _ws.SolutionMemory() if _ws.enabled() else None
        else:
            self.memory = None

    def tier(self, idx) -> SolverCache:
        """The cache for one option tier.  ``idx`` is the refinement
        round (clamped onto the tier table) or the literal key
        ``"override"`` — caller-pinned options must never share a
        structure-keyed cache with a numbered tier's solvers."""
        if idx != "override":
            idx = min(int(idx), len(SCREEN_TIERS) - 1)
        cache = self._tiers.get(idx)
        if cache is None:
            cache = self._tiers[idx] = SolverCache(pad_grid=self.pad_grid,
                                                   memory=self.memory,
                                                   device=self.device)
        return cache

    def clear(self) -> None:
        for cache in self._tiers.values():
            cache.solvers.clear()

    def snapshot(self) -> Dict:
        return {"tiers": len(self._tiers),
                "builds": sum(c.builds for c in self._tiers.values()),
                "hits": sum(c.hits for c in self._tiers.values()),
                "structures_cached": sum(len(c.solvers)
                                         for c in self._tiers.values()),
                "warm_start": (self.memory.snapshot()
                               if self.memory is not None else None)}


@dataclasses.dataclass
class ScreenedCandidate:
    """One candidate's screening outcome."""
    candidate: Candidate
    capex: float = float("nan")
    operating_value: float = float("nan")
    total: float = float("nan")
    lifetime_npv: float = float("nan")
    converged: bool = False
    feasible: bool = True               # budget/constraint filters
    reason: Optional[str] = None
    screen_round: int = -1              # tier the final score came from
    screen_rank: Optional[int] = None   # 1-based, over converged entries


@dataclasses.dataclass
class ScreenReport:
    """The screening phase's full observable surface: every candidate's
    score/rank, per-round dispatch stats, and the throughput number the
    PERF story is built on (screening candidates/sec)."""
    entries: List[ScreenedCandidate]
    rounds: List[Dict] = dataclasses.field(default_factory=list)
    screen_s: float = 0.0
    certification_enabled: bool = False   # MUST stay False (ordinal tier)

    @property
    def converged(self) -> List[ScreenedCandidate]:
        return [e for e in self.entries if e.converged]

    def top(self, k: int) -> List[ScreenedCandidate]:
        """The k best candidates by screened total (finalists)."""
        ranked = sorted(self.converged,
                        key=lambda e: (e.total, e.candidate.index))
        return ranked[:max(0, int(k))]

    @property
    def candidates_per_s(self) -> Optional[float]:
        solved = sum(r["candidates"] for r in self.rounds)
        return round(solved / self.screen_s, 2) if self.screen_s else None

    @property
    def dispatches(self) -> int:
        return sum(int(r.get("dispatches", 0)) for r in self.rounds)

    @property
    def compile_events(self) -> int:
        return sum(int(r.get("compile_events", 0)) for r in self.rounds)

    def table(self) -> pd.DataFrame:
        """Population DataFrame (one row per candidate, every size
        dimension a column) — the response surface the frontier's
        ``population`` table is built from."""
        rows = []
        for e in self.entries:
            row: Dict = {"candidate": e.candidate.index,
                         "source": e.candidate.source}
            single = len(e.candidate.sizes) == 1
            for tag, der_id, kw, kwh in e.candidate.sizes:
                prefix = "" if single else f"{tag}:{der_id or '1'} "
                if kw is not None:
                    row[f"{prefix}kW"] = kw
                if kwh is not None:
                    row[f"{prefix}kWh"] = kwh
            row.update({
                "operating_value": e.operating_value, "capex": e.capex,
                "total": e.total, "lifetime_npv": e.lifetime_npv,
                "converged": e.converged, "feasible": e.feasible,
                "screen_round": e.screen_round,
                "screen_rank": e.screen_rank, "reason": e.reason})
            rows.append(row)
        return pd.DataFrame(rows)


def dispatch_device(backend: str, device=None):
    """The device a 'torch' dispatch solves on, resolved up front so an
    entry point called with ``device=None`` and no visible GPU raises
    before it builds a population (``device.resolve_device``); None
    for the exact 'cpu' backend."""
    if backend == "cpu":
        return None
    from ..device import resolve_device
    return resolve_device(device)


def annuity_factor(case, scenario) -> float:
    """Lifetime discount factor for the optimized year's recurring net
    operating value (the sizing sweep's vectorized proforma): sum over
    project years of inflation growth over discount."""
    fin = case.finance
    rate = float(fin.get("npv_discount_rate", 0) or 0) / 100.0
    infl = float(fin.get("inflation_rate", 0) or 0) / 100.0
    n_years = scenario.end_year - scenario.start_year + 1
    k = np.arange(1, n_years + 1)
    return float(np.sum((1 + infl) ** (k - 1) / (1 + rate) ** k))


def target_capex(scenario, targets) -> float:
    """Candidate capital cost over the SIZED DERs only (constant
    other-DER capex shifts every candidate's total equally and would
    only blur the ordinal signal)."""
    total = 0.0
    for der in scenario.ders:
        if (der.tag, der.id or "1") in targets:
            total += float(der.get_capex())
    return total


def score_scenario(scenario) -> float:
    """Screened (or certified) operating value: the case's dispatch
    objective summed across windows."""
    return float(sum(b.get("Total Objective", 0.0)
                     for b in scenario.objective_values.values()))


def build_candidate_scenarios(case, candidates: List[Candidate],
                              request_id: Optional[str] = None,
                              id_prefix: str = "design"
                              ) -> List[MicrogridScenario]:
    """One scenario per candidate, fixed-size-guarded.  Window structure
    is identical across candidates by construction, so the dispatch
    driver batches them onto the device axis in a handful of groups."""
    scens = []
    for cand in candidates:
        c = candidate_case(case, cand,
                           case_id=f"{id_prefix}.cand{cand.index:04d}")
        s = MicrogridScenario(c)
        # EVERY candidate is guarded: is_sizing_optimization depends on
        # the candidate's own sizes (a zero-rating grid point would be
        # silently re-sized by the optimizer and scored at a design the
        # caller never asked for), so checking only the first scenario
        # is not enough
        try:
            guard_design_case(s)
        except ParameterError as e:
            raise ParameterError(f"candidate {cand.index} "
                                 f"({cand.label()}): {e}") from e
        if request_id is not None:
            s.request_id = request_id
        scens.append(s)
    return scens


def screen_candidates(case, candidates: List[Candidate], *,
                      backend: str = "torch", device=None,
                      base_opts: Optional[PDHGOptions] = None,
                      screen_opts_override: Optional[PDHGOptions] = None,
                      caches: Optional[ScreeningCaches] = None,
                      refine_rounds: int = 1, refine_keep: float = 0.25,
                      top_k: int = 8, budget: Optional[float] = None,
                      supervisor=None, request_id: Optional[str] = None,
                      screen_variant: Optional[str] = None,
                      ) -> ScreenReport:
    """Screen ``candidates`` and rank them.

    ``screen_opts_override`` (the ``sizing_sweep`` shim) replaces the
    tiered screening options with ONE explicit option set for every
    round — full-fidelity sweeps reuse this engine with their own
    tolerances.  ``budget`` drops over-budget candidates before any
    solve, reported (never silent).  Certification is FORCED OFF for the
    screening dispatch via the thread-local policy override regardless
    of the environment policy.  ``device`` is where the 'torch' backend
    solves (``None`` -> the GPU, raising when none is visible)."""
    if not candidates:
        raise ParameterError("design screen: empty candidate population")
    device = dispatch_device(backend, device)
    caches = caches if caches is not None else ScreeningCaches(
        pad_grid=(backend != "cpu"), device=device)
    t0 = time.perf_counter()
    scens = build_candidate_scenarios(case, candidates,
                                      request_id=request_id)
    if caches.memory is not None:
        # the refinement round and the certified finalists seed from the
        # earlier rounds' entries, one per WINDOW: the LRU must hold the
        # whole population's windows (a 512-candidate full-year screen
        # stores 6,144 in round 0), with room for the later rounds'
        caches.memory.ensure_capacity(
            2 * sum(len(s.windows) for s in scens) + 64)
    entries = [ScreenedCandidate(candidate=c) for c in candidates]
    targets = {(t, di or "1") for c in candidates
               for (t, di, _, _) in c.sizes}
    annuity = annuity_factor(case, scens[0])
    for e, s in zip(entries, scens):
        e.capex = target_capex(s, targets)
    # budget cap: filtered BEFORE any device work, with the count
    # reported — a silently shrunk population would read as covered
    if budget is not None:
        dropped = 0
        for e in entries:
            if e.capex > float(budget):
                e.feasible = False
                e.reason = (f"capex {e.capex:.0f} over the "
                            f"{float(budget):.0f} budget cap")
                dropped += 1
        if dropped:
            TellUser.warning(
                f"design screen: {dropped}/{len(entries)} candidate(s) "
                "dropped by the capex budget cap before screening")
    active = [i for i, e in enumerate(entries) if e.feasible]
    if not active:
        raise ParameterError(
            "design screen: every candidate was filtered out before "
            "screening (budget cap too tight for the bounds?)")

    report = ScreenReport(entries=entries)
    n_rounds = 1 + max(0, int(refine_rounds))
    for rnd in range(n_rounds):
        if not active:
            break
        opts = (screen_opts_override if screen_opts_override is not None
                else screening_options(base_opts, rnd,
                                       variant=screen_variant))
        round_scens = [scens[i] for i in active]
        t_round = time.perf_counter()
        # ordinal tier: certification OFF, scoped to THIS thread only —
        # a concurrent certified dispatch keeps its own policy
        policy = dataclasses.replace(certify.policy_from_env(),
                                     enabled=False)
        all_failed = None
        with certify.policy_override(policy):
            try:
                # one wide structure group — split the single batch
                # over the devices rather than handing it to the
                # elastic scheduler
                run_dispatch(round_scens, backend=backend,
                             solver_opts=opts,
                             solver_cache=caches.tier(
                                 rnd if screen_opts_override is None
                                 else "override"),
                             supervisor=supervisor, device=device,
                             elastic=False)
            except AggregatedSolverError as e:
                all_failed = e      # every candidate failed this round
        # on a whole-round failure the scenarios' solve_metadata still
        # holds the PREVIOUS round's ledger — reading it would
        # double-count dispatches/compiles into the failed round's stats
        ledger = ({} if all_failed is not None
                  else round_scens[0].solve_metadata.get("solve_ledger")
                  or {})
        totals = ledger.get("totals") or {}
        # measured, not assumed: if ANY screening scenario ended with an
        # enabled certification record, the thread-local override failed
        # and the ordinal contract is broken — surface it
        report.certification_enabled = report.certification_enabled or \
            any(bool((getattr(s, "certification", None) or {})
                     .get("enabled")) for s in round_scens)
        for i in active:
            e, s = entries[i], scens[i]
            failed = s.quarantine is not None or all_failed is not None
            if failed:
                reason = ((s.quarantine or {}).get("reason")
                          if s.quarantine is not None else str(all_failed))
                if rnd > 0 and e.converged:
                    # a refinement-round failure must not INVERT the
                    # ordering: this survivor already carries a valid
                    # earlier-round score — marking it unconverged here
                    # would hand the frontier to the refinement-CUT
                    # (worst-screened) candidates.  Keep the prior
                    # score, note what happened.
                    e.reason = (f"refinement round {rnd} failed "
                                f"({reason}); kept the round "
                                f"{e.screen_round} score")
                else:
                    e.converged = False
                    e.reason = reason
                    e.screen_round = rnd
                continue
            e.operating_value = score_scenario(s)
            e.total = e.operating_value + e.capex
            e.lifetime_npv = -e.capex - e.operating_value * annuity
            e.converged = True
            e.reason = None
            e.screen_round = rnd
        report.rounds.append({
            "round": rnd,
            "tier": ("override" if screen_opts_override is not None
                     else min(rnd, len(SCREEN_TIERS) - 1)),
            "eps_rel": float(opts.eps_rel),
            "max_iters": int(opts.max_iters),
            "candidates": len(active),
            "round_s": round(time.perf_counter() - t_round, 3),
            "dispatches": int(totals.get("dispatches", 0)),
            "chunks": int(totals.get("chunks", 0)),
            "compile_events": int(totals.get("compile_events", 0)),
            "device_groups": len([g for g in ledger.get("groups", ())
                                  if g.get("rung") in (None, "initial")]),
            "windows": int(totals.get("windows", 0)),
            # warm-start split of the round's windows (memory seeds)
            **{k: int((ledger.get("warm_start") or {}).get(k, 0))
               for k in ("seeded", "cold", "substituted")},
        })
        if all_failed is not None:
            TellUser.warning(
                f"design screen: round {rnd} failed wholesale "
                f"({all_failed})"
                + ("; stopping refinement — survivors keep their "
                   "previous-round scores" if rnd > 0 else ""))
            break       # a dead round will not get better at tighter eps
        survivors = [i for i in active if entries[i].converged]
        if rnd + 1 < n_rounds and survivors:
            keep = max(int(top_k),
                       int(math.ceil(len(survivors) * float(refine_keep))))
            survivors = sorted(
                survivors, key=lambda i: (entries[i].total,
                                          entries[i].candidate.index))
            active = survivors[:keep]
        else:
            active = survivors
    # final ordinal ranks over every converged candidate (ties broken by
    # candidate index so ranking is deterministic)
    ranked = sorted((e for e in entries if e.converged),
                    key=lambda e: (e.total, e.candidate.index))
    for rank, e in enumerate(ranked, start=1):
        e.screen_rank = rank
    report.screen_s = round(time.perf_counter() - t0, 3)
    n_conv = len(ranked)
    TellUser.info(
        f"design screen: {len(candidates)} candidate(s), "
        f"{len(report.rounds)} round(s), {n_conv} ranked in "
        f"{report.screen_s:.2f}s "
        f"({report.candidates_per_s or 0:.1f} cand/s, "
        f"{report.dispatches} device dispatches)")
    return report
