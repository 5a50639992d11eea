"""Portfolio co-optimization engine: dual-decomposed coupled-site LPs.

The coupled portfolio LP

    min  sum_s c_s' x_s            (+ D * peak aggregate import)
    s.t. x_s in X_s                (every site's own window LPs)
         coupling rows over E(t) = sum_s e_s(t)

decomposes per site under Lagrangian dual decomposition (DuaLip-GPU,
arxiv 2603.04621, is the extreme-scale exemplar): relaxing the coupling
rows with prices ``lam`` leaves ``S`` INDEPENDENT site problems whose
only change from the uncoupled case is a per-timestep price shift on
the net-export terms of ``c`` — exactly the batch axis the whole stack
is built around.  One outer *dual iteration* is therefore ONE
``run_dispatch`` call over every member site's window LPs: the windows
co-batch by structure across sites, ride the dispatch pipeline and
the service's solver cache, every accepted iterate is
float64-certified, and — because the dual update only perturbs ``c`` —
iteration k+1 reseeds every window from its iteration-k iterate through
the warm-start memory's ``dual_iterate`` grade (MPAX, arxiv 2412.09734,
shows PDHG tolerates exactly this class of perturbation).  Solvers
(preconditioning, the compact K forms) are shared across rounds, so
outer round 1 pays the solver builds and every later round builds
NOTHING.  The inner solves run on ONE device (``device``, default
``cuda:0``) in the chunk kernels.

The dual update is a projected dual ascent whose step direction comes
from a RESTRICTED MASTER over the accumulated site columns (classic
Dantzig-Wolfe: each round's per-site solutions join a column pool; a
small host-side HiGHS LP blends them into the best coupling-feasible
convex combination and its row marginals are the next prices).  This
buys three things a bare subgradient loop lacks: a coupling-FEASIBLE
primal answer every round (the blend), a certified Lagrangian duality
gap (master primal vs best dual bound — exact with cpu inner solves,
honest-to-inner-tolerance with f32 PDHG, and the certificate says
which), and finite convergence on exact toy problems (the 2-site
monolithic-agreement test).  The step is damped — ``lam <- lam +
step * (lam_master - lam)`` — and the loop watches the per-round dual
bound: a NON-MONOTONE regression (the ``diverging_duals`` fault's
signature) halves the step and continues; dual corruption costs outer
rounds, never correctness.

Infeasible portfolios terminate typed: a pre-flight float64 bound check
(per-timestep box relaxation of every site's net-export range — a
violated row here is CONCLUSIVE, the relaxation only widens what sites
can do) raises :class:`PortfolioInfeasibleError` with the violated-row
diagnosis before any dual loop runs, and the elastic master's residual
slack raises the same error when the loop proves at runtime that no
column mix can satisfy the rows.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp

from ..ops import certify
from ..scenario.scenario import SolverCache, run_dispatch
from ..telemetry import trace as telemetry_trace
from ..utils import faultinject
from ..utils.errors import (ParameterError, PortfolioInfeasibleError,
                            RequestFailedError, TellUser)
from .site import PortfolioSiteScenario
from .spec import CouplingRows, PortfolioSpec, stabilization_enabled


@dataclasses.dataclass(eq=False)
class Column:
    """One site's solution from one outer round: the TRUE cost
    ``phi = c_base @ x`` (float64), the activity series the coupling
    rows act on, and the full solution arrays (needed for the final
    blend).  ``weight`` is the last master's convex multiplier."""

    phi: float
    activity: np.ndarray
    solution: Dict[str, np.ndarray]
    round_idx: int
    weight: float = 0.0


@dataclasses.dataclass
class MasterSolution:
    objective: float                 # true cost of the blend (+ D*M)
    weights: Dict[str, np.ndarray]
    M: float
    duals: Dict[str, np.ndarray]
    slack: Dict[str, np.ndarray]
    slack_rel_max: float
    slack_worst: Optional[Dict] = None


class PortfolioResult:
    """The portfolio answer: coupling-feasible blended dispatch,
    converged dual prices, per-round dual-loop observables, and the
    float64 portfolio certificate.  ``save_as_csv(dir)`` writes the
    spool artifact set (``portfolio.json`` + aggregate CSV)."""

    def __init__(self):
        self.request_id: Optional[str] = None
        self.fidelity: str = "certified"
        self.resubmit_hint: Optional[str] = None
        self.converged: bool = False
        self.outer_rounds: int = 0
        self.dual_rescales: int = 0
        self.stabilized: bool = True
        self.shard_plan: Optional[List[List[str]]] = None
        self.objective_cx: float = float("nan")
        self.objective_total: float = float("nan")
        self.demand_charge_cost: float = 0.0
        self.primal_objective: float = float("nan")
        self.dual_bound: float = float("-inf")
        self.gap_rel: float = float("inf")
        self.duals: Dict[str, np.ndarray] = {}
        self.price: Optional[np.ndarray] = None
        self.aggregate: Dict[str, np.ndarray] = {}
        self.rounds: List[Dict] = []
        self.per_site: Dict[str, Dict] = {}
        self.site_solutions: Dict[str, Dict[str, np.ndarray]] = {}
        self.certification: Dict = {}
        self.run_health: Dict = {}
        self.solve_ledger: Optional[Dict] = None
        self.index = None
        self.request_latency_s: Optional[float] = None

    # ------------------------------------------------------------------
    def portfolio_section(self) -> Dict:
        """The ``portfolio`` observability section (run_health /
        solve_ledger / service metrics surface)."""
        return {
            "converged": bool(self.converged),
            "outer_rounds": int(self.outer_rounds),
            "dual_rescales": int(self.dual_rescales),
            "stabilized": bool(self.stabilized),
            "shards": (len(self.shard_plan) if self.shard_plan else 1),
            "gap_rel": (None if not np.isfinite(self.gap_rel)
                        else float(self.gap_rel)),
            "objective_cx": float(self.objective_cx),
            "demand_charge_cost": float(self.demand_charge_cost),
            "sites": len(self.per_site),
            "rounds": self.rounds,
            "certification": self.certification,
        }

    def as_json_dict(self) -> Dict:
        def arr(a):
            return None if a is None else [round(float(v), 6) for v in a]
        return {
            "request_id": self.request_id,
            "fidelity": self.fidelity,
            "resubmit_hint": self.resubmit_hint,
            "converged": bool(self.converged),
            "outer_rounds": int(self.outer_rounds),
            "dual_rescales": int(self.dual_rescales),
            "stabilized": bool(self.stabilized),
            "shards": (len(self.shard_plan) if self.shard_plan else 1),
            "objective_cx": float(self.objective_cx),
            "objective_total": float(self.objective_total),
            "demand_charge_cost": float(self.demand_charge_cost),
            "primal_objective": float(self.primal_objective),
            "dual_bound": float(self.dual_bound),
            "gap_rel": (None if not np.isfinite(self.gap_rel)
                        else float(self.gap_rel)),
            "duals": {k: arr(v) for k, v in self.duals.items()},
            "per_site": {k: {"objective_cx": float(v["objective_cx"]),
                             "weights": [round(float(w), 6)
                                         for w in v["weights"]]}
                         for k, v in self.per_site.items()},
            "rounds": self.rounds,
            "certification": self.certification,
        }

    def save_as_csv(self, out_dir) -> None:
        """Persist the portfolio artifact set (the serve loop's results
        contract; the name matches the Result surface it stands in
        for).  Writes ``portfolio.json`` + ``portfolio_aggregate.csv``
        atomically."""
        import json
        from pathlib import Path

        import pandas as pd

        from ..utils.supervisor import atomic_output, atomic_write
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        atomic_write(out / "portfolio.json",
                     json.dumps(self.as_json_dict(), indent=2))
        if self.index is not None and self.aggregate:
            df = pd.DataFrame(index=self.index)
            df["Aggregate Net Export (kW)"] = self.aggregate["net_export"]
            df["Aggregate Load (kW)"] = self.aggregate["load"]
            df["Coupling Price ($/kWh)"] = (
                self.price if self.price is not None else 0.0)
            for kind, lam in self.duals.items():
                df[f"Dual {kind} ($/kWh)"] = lam
            with atomic_output(out / "portfolio_aggregate.csv") as tmp:
                df.to_csv(tmp, index_label="Start Datetime (hb)")


# ---------------------------------------------------------------------------
# Construction + pre-flight
# ---------------------------------------------------------------------------

def build_site_scenarios(spec: PortfolioSpec,
                         request_id: Optional[str] = None
                         ) -> Dict[str, PortfolioSiteScenario]:
    """Construct every member's site scenario and validate the shared
    horizon (identical timestep index + dt across members — the
    coupling rows are per-timestep sums)."""
    scens: Dict[str, PortfolioSiteScenario] = {}
    ref_index = None
    tag = str(request_id) if request_id else "solo"
    for key in sorted(spec.members, key=str):
        case = spec.members[key]
        if request_id:
            case = dataclasses.replace(case,
                                       case_id=f"{request_id}.{key}")
        s = PortfolioSiteScenario(case, site_key=str(key), seed_tag=tag)
        if request_id:
            s.request_id = str(request_id)
        if ref_index is None:
            ref_index = s.index
        elif len(s.index) != len(ref_index) or \
                not (s.index == ref_index).all():
            raise ParameterError(
                f"portfolio member {key!r}: horizon differs from the "
                "first member's — coupled sites must share one "
                "timestep index")
        scens[str(key)] = s
    return scens


def _build_all_lps(s: PortfolioSiteScenario) -> Dict[int, object]:
    """One host-side assembly pass over a site's windows (pre-flight
    bounds + term-name/c0 initialization; the dispatch rebuilds its own
    LPs with template sharing)."""
    reqs = s.service_agg.identify_system_requirements(
        s.ders, s.opt_years, s.index)
    lps: Dict[int, object] = {}
    template = None
    for ctx in s.windows:
        lp = s.build_window_lp(ctx, 1.0, reqs, template=template)
        lps[int(ctx.label)] = lp
        template = None     # window lengths differ; keep it simple
    return lps


def preflight_feasibility(scens: Dict[str, PortfolioSiteScenario],
                          rows: CouplingRows, spec: PortfolioSpec,
                          index) -> float:
    """Conclusive float64 infeasibility check BEFORE any dual loop: the
    per-timestep box relaxation of every site's activity range (sum of
    the power-term variable bounds — intertemporal constraints ignored,
    which only WIDENS what sites can do).  A coupling row violated by
    the relaxation cannot be satisfied by any dispatch; raise the typed
    error with the violated-row diagnosis instead of iterating.

    Returns the fleet's PRICE SCALE — the max |finite c| over any power
    term — which sets the auto dual-price cap: beyond the data's own
    price scale, every site's response to a coupling price is already
    extremal."""
    T = rows.T
    lo = np.zeros(T)
    hi = np.zeros(T)
    price_scale = 0.0
    for s in scens.values():
        lps = _build_all_lps(s)
        slo, shi = s.term_bounds(lps)
        lo += slo
        hi += shi
        for lp in lps.values():
            for name, _sign in s.term_names():
                ref = lp.var_refs.get(name)
                if ref is None:
                    continue
                cc = np.asarray(lp.c[ref.sl], np.float64)
                cc = cc[np.isfinite(cc)]
                if cc.size:
                    price_scale = max(price_scale,
                                      float(np.abs(cc).max()))
    violations: List[Dict] = []
    for kind in rows.kinds:
        if kind == "demand_charge":
            continue        # the epigraph variable absorbs any peak
        # LE-normalized rows: lhs = sign*A (+0); minimum achievable lhs
        best = np.where(rows.sign[kind] > 0, lo * rows.sign[kind],
                        hi * rows.sign[kind])
        rhs = rows.rhs[kind]
        tol = spec.feas_tol * (1.0 + np.abs(rhs) + np.abs(best))
        bad = best > rhs + tol
        if bad.any():
            order = np.argsort(-(best - rhs))
            for t in order[:4]:
                if not bad[t]:
                    break
                violations.append({
                    "kind": kind, "t": int(t),
                    "timestamp": str(index[int(t)]),
                    "required": float(rhs[int(t)]),
                    "achievable_min": float(best[int(t)]),
                    "shortfall_kw": float(best[int(t)] - rhs[int(t)]),
                })
    if violations:
        worst = violations[0]
        raise PortfolioInfeasibleError(
            f"portfolio coupling rows cannot be satisfied: "
            f"{worst['kind']} at {worst['timestamp']} needs aggregate "
            f"activity <= {worst['required']:.1f} kW but the fleet's "
            f"feasible minimum is {worst['achievable_min']:.1f} kW "
            f"(shortfall {worst['shortfall_kw']:.1f} kW; "
            f"{len(violations)} violated row(s) diagnosed)",
            violations=violations)
    return price_scale


# ---------------------------------------------------------------------------
# Restricted master (primal recovery + dual prices)
# ---------------------------------------------------------------------------

def _solve_master(columns: Dict[str, List[Column]], rows: CouplingRows,
                  spec: PortfolioSpec,
                  price_cap: float) -> MasterSolution:
    """Blend the accumulated site columns into the best coupling-
    feasible convex combination (host-side HiGHS; tiny next to one
    device round) and read the next dual prices off the row marginals.
    Elastic: per-row slack at ``10x price_cap`` penalty keeps the
    restricted problem always-feasible, so residual slack is a
    DIAGNOSIS (which rows no column mix can satisfy) instead of a
    solver failure."""
    from scipy.optimize import linprog

    sites = sorted(columns)
    cols: List[tuple] = [(skey, c) for skey in sites
                         for c in columns[skey]]
    n_cols = len(cols)
    T = rows.T
    kinds = rows.kinds
    n_rows = T * len(kinds)
    has_M = "demand_charge" in kinds
    penalty = 10.0 * price_cap

    A_block = np.empty((n_rows, n_cols))
    for j, (_, col) in enumerate(cols):
        for ki, kind in enumerate(kinds):
            A_block[ki * T:(ki + 1) * T, j] = \
                rows.sign[kind] * col.activity
    parts = [sp.csr_matrix(A_block)]
    if has_M:
        m_col = np.zeros(n_rows)
        ki = kinds.index("demand_charge")
        m_col[ki * T:(ki + 1) * T] = -1.0
        parts.append(sp.csr_matrix(m_col[:, None]))
    parts.append(-sp.identity(n_rows, format="csr"))
    A_ub = sp.hstack(parts, format="csr")
    b_ub = np.concatenate([rows.rhs[k] for k in kinds])

    n_vars = n_cols + (1 if has_M else 0) + n_rows
    c = np.zeros(n_vars)
    c[:n_cols] = [col.phi for _, col in cols]
    if has_M:
        c[n_cols] = rows.demand_charge or 0.0
    c[n_cols + (1 if has_M else 0):] = penalty

    A_eq = sp.lil_matrix((len(sites), n_vars))
    for j, (skey, _) in enumerate(cols):
        A_eq[sites.index(skey), j] = 1.0
    res = linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq.tocsr(),
                  b_eq=np.ones(len(sites)), bounds=(0, None),
                  method="highs")
    if res.status != 0 or res.x is None:
        raise RequestFailedError({"portfolio": (
            f"restricted master LP failed (status {res.status}): "
            f"{res.message}")})
    x = np.asarray(res.x, np.float64)
    weights: Dict[str, np.ndarray] = {s: np.zeros(len(columns[s]))
                                      for s in sites}
    pos: Dict[str, int] = {s: 0 for s in sites}
    for j, (skey, col) in enumerate(cols):
        weights[skey][pos[skey]] = x[j]
        col.weight = float(x[j])
        pos[skey] += 1
    M = float(x[n_cols]) if has_M else 0.0
    slack_flat = x[n_cols + (1 if has_M else 0):]
    duals_flat = np.clip(-np.asarray(res.ineqlin.marginals, np.float64),
                         0.0, price_cap)
    duals = rows.unstack_duals(duals_flat)
    slack = rows.unstack_duals(slack_flat)
    true_obj = float(np.asarray(c[:n_cols]) @ x[:n_cols])
    if has_M:
        true_obj += (rows.demand_charge or 0.0) * M
    slack_rel_max = 0.0
    slack_worst = None
    for kind in kinds:
        rel = slack[kind] / (1.0 + np.abs(rows.rhs[kind]))
        j = int(np.argmax(rel)) if rel.size else -1
        if j >= 0 and rel[j] > slack_rel_max:
            slack_rel_max = float(rel[j])
            slack_worst = {"kind": kind, "t": j,
                           "slack_kw": float(slack[kind][j]),
                           "rhs": float(rows.rhs[kind][j])}
    return MasterSolution(objective=true_obj, weights=weights, M=M,
                          duals=duals, slack=slack,
                          slack_rel_max=slack_rel_max,
                          slack_worst=slack_worst)


def _trim_columns(columns: Dict[str, List[Column]], cap: int) -> None:
    """Bound the per-site column pool: drop the oldest ZERO-weight
    columns first (their blend value is spent), then the oldest."""
    for skey, cols in columns.items():
        while len(cols) > cap:
            victim = next((c for c in cols if c.weight <= 0.0), cols[0])
            cols.remove(victim)


# ---------------------------------------------------------------------------
# The outer dual loop
# ---------------------------------------------------------------------------

def solve_portfolio(spec: PortfolioSpec, *, backend: str = "torch",
                    solver_opts=None, solver_cache=None,
                    supervisor=None, breaker_board=None,
                    request_id: Optional[str] = None,
                    degraded: bool = False, fleet=None,
                    on_round=None, device=None) -> PortfolioResult:
    """Solve one coupled portfolio (see module docstring).

    ``solver_cache`` (a :class:`SolverCache`) injects a long-lived
    cache — the service passes its own, so a portfolio request inherits
    the hot service's solvers AND its warm-start memory;
    solo callers get a fresh pad-grid cache (bucket padding keeps the
    round-over-round program set fixed even when exact substitution
    shrinks a batch).  ``degraded`` runs the load-shed tier: screening
    solver options, certification disabled thread-locally, the answer
    explicitly marked and NEVER certificate-stamped.

    ``fleet`` (a :class:`~dervet_tpu_torch.service.router.FleetRouter`)
    shards each dual round's member batch across the fleet's replicas
    (``spec.shards`` shards, default one per replica): shard payloads
    ride the replica transport with the dual-price vector, the sticky
    per-shard affinity keeps each shard on the replica whose cached
    solvers and ``dual_iterate`` hints are warm for it, and a dead
    replica's shard re-routes through the exactly-once failover.
    Without a fleet, ``spec.shards > 1`` runs the same shard plan
    in-process (concurrent dispatches, per-shard caches).  For a FIXED
    shard plan the per-site columns and costs are identical across all
    three executors.  ``on_round(k, result)`` fires after each round's
    record lands (smoke/bench hooks).

    ``device`` is where the in-process inner solves run (``None`` ->
    ``cuda:0``, raising without a GPU; ``"cpu"`` runs the kernels' plain
    versions); the exact ``backend="cpu"`` takes none.  A fleet's
    replicas solve on their own devices."""
    if backend not in ("torch", "cpu"):
        raise ValueError(f"backend must be 'torch' or 'cpu', got "
                         f"{backend!r}")
    if backend != "cpu":
        from ..device import resolve_device
        device = resolve_device(device)
    spec.validate()
    t_start = time.monotonic()
    scens = build_site_scenarios(spec, request_id)
    index = next(iter(scens.values())).index
    T = len(index)
    load_total = np.zeros(T)
    site_loads: Dict[str, np.ndarray] = {}
    for key, s in scens.items():
        site_loads[key] = s.load_series()
        load_total += site_loads[key]
    rows = CouplingRows.build(spec, T, load_total)
    price_scale = preflight_feasibility(scens, rows, spec, index)
    # effective dual-price cap (see PortfolioSpec.price_cap)
    price_cap = (float(spec.price_cap) if spec.price_cap is not None
                 else max(10.0 * price_scale, 1e-6))

    if degraded:
        from ..ops.pdhg import PDHGOptions
        opts = PDHGOptions.screening(solver_opts)
        cert_ctx = lambda: certify.policy_override(    # noqa: E731
            certify.CertPolicy(enabled=False))
    else:
        opts = solver_opts
        cert_ctx = contextlib.nullcontext
    cache = solver_cache if solver_cache is not None else \
        SolverCache(pad_grid=(backend != "cpu"), warm_start=True,
                    device=device)
    if cache.memory is not None:
        # the dual loop reseeds every window from its previous round's
        # iterate (the hint table) and substitutes windows whose prices
        # stopped moving (the primary store): both must hold a whole
        # round, or a large portfolio evicts its own seeds between
        # rounds and runs them cold.  The JAX package never raises it.
        cache.memory.ensure_capacity(
            2 * sum(len(s.windows) for s in scens.values()) + 64)

    # ---- shard plan + round executor --------------------------------
    # (shard.py; the degraded tier stays monolithic — its screening
    # round is cheap by construction and the thread-local cert override
    # is simplest to reason about on one dispatch thread)
    from .shard import (FleetShardExecutor, LocalShardExecutor,
                        MonolithicExecutor, plan_shards)
    if fleet is not None and not degraded:
        n_shards = (int(spec.shards) if spec.shards is not None
                    else len(fleet.replicas))
        plan = plan_shards(scens, n_shards)
        # anonymous solves get a UNIQUE portfolio id: shard rids embed
        # it, and the router's exactly-once memo refuses a reused rid —
        # two back-to-back anonymous solves on one router must not
        # collide on "pf.s00.r000"
        import uuid as _uuid
        executor = FleetShardExecutor(
            {str(k): v for k, v in spec.members.items()}, plan, fleet,
            backend=backend, solver_opts=opts,
            portfolio_id=(request_id
                          or f"pf-{_uuid.uuid4().hex[:10]}"))
    else:
        n_shards = 1 if degraded else spec.effective_shards(len(scens))
        if n_shards > 1 and backend != "cpu":
            from ..parallel import elastic as _elastic
            if not _elastic.elastic_enabled() and \
                    len(_elastic.visible_devices(device)) > 1:
                # the plain pipeline splits every batch over all the
                # devices and runs one such solve at a time; concurrent
                # local shards would run several at once — clamp
                TellUser.warning(
                    "portfolio: DERVET_TPU_ELASTIC=0 splits every "
                    "dispatch over all devices, one at a time "
                    f"— ignoring shards={n_shards}, running the round "
                    "monolithically")
                n_shards = 1
        plan = plan_shards(scens, n_shards)
        if len(plan) > 1:
            executor = LocalShardExecutor(
                scens, plan, backend=backend, solver_opts=opts,
                supervisor=supervisor, breaker_board=breaker_board,
                cert_ctx=cert_ctx, memory=cache.memory, device=device)
        else:
            executor = MonolithicExecutor(
                scens, backend=backend, solver_opts=opts,
                solver_cache=cache, supervisor=supervisor,
                breaker_board=breaker_board, cert_ctx=cert_ctx,
                device=device)

    duals = rows.zero_duals()
    duals_best = rows.zero_duals()      # the prices behind best_dual
    step = 1.0
    best_dual = float("-inf")
    prev_gap_abs: Optional[float] = None
    prev_master_feasible = False
    dual_rescales = 0
    # stabilized Dantzig-Wolfe master (in-out / proximal-level): the
    # separation point blends the STABILITY CENTER (duals_best, the
    # prices behind the best dual bound) toward the master marginals by
    # ``alpha``; a level-set test on the next round's dual bound
    # classifies serious (lengthen alpha) vs null (contract alpha)
    # steps.  Kill switch DERVET_TPU_PORTFOLIO_STABILIZE=0 (or
    # spec.master_stabilization=False) skips every line of this state
    # and runs the legacy three-regime step bit for bit.
    stabilize = stabilization_enabled(spec)
    alpha = 0.5                         # in-out blend coefficient
    alpha_min, alpha_max = 0.1, 1.0
    level_frac = 0.3                    # level set: best + frac * gap
    level_prev: Optional[float] = None
    nulls = 0                           # consecutive null steps
    columns: Dict[str, List[Column]] = {k: [] for k in scens}
    result = PortfolioResult()
    result.request_id = request_id
    result.stabilized = stabilize
    result.fidelity = "degraded" if degraded else "certified"
    if degraded:
        result.resubmit_hint = (
            "degraded-fidelity portfolio answer (service was shedding "
            "load): screening-tier inner solves, no certificates — "
            "resubmit with a higher priority for a certified answer")
    result.index = index
    result.shard_plan = plan
    master: Optional[MasterSolution] = None
    ledger = None
    last_rd = None
    scen_list = list(scens.values())

    for k in range(spec.max_outer):
        if k:
            # trim BEFORE this round appends: the pool the loop exits
            # with is exactly the pool the last master weighted, so the
            # final blend's column weights stay aligned
            _trim_columns(columns, spec.max_columns - 1)
        price = rows.price(duals)
        t0 = time.monotonic()
        rd = executor.dispatch_round(price, k, request_id=request_id)
        round_wall = time.monotonic() - t0
        last_rd = rd
        for key, oc in rd.outcomes.items():
            if oc.quarantine is not None:
                raise RequestFailedError(
                    {key: oc.quarantine["reason"]})
        ledger = rd.ledger

        # dual bound (Lagrangian): sum of shifted site minima minus
        # lam'b — EXACT with cpu inner solves, inner-tolerance-honest
        # with f32 PDHG (the certificate records which)
        shifted_sum = sum(oc.shifted for oc in rd.outcomes.values())
        dual_bound_k = shifted_sum - rows.dual_rhs_term(duals)
        regressed = False
        if k > 0 and prev_master_feasible and np.isfinite(best_dual):
            # the detector arms only after a SLACK-FREE master: while
            # elastic slack is active the marginals are penalty-driven
            # by construction and a wild bound is expected, not a fault
            # the guard must sit above normal column-generation bound
            # fluctuation (degenerate master vertices wobble the
            # marginals, and f32 inner minima make each round's bound a
            # few percent soft — observed up to ~10% of scale) yet far
            # below a corrupted update's damage (out-of-scale prices
            # move the bound by ORDERS OF MAGNITUDE of the objective)
            scale = 1.0 + abs(best_dual)
            guard = max(10.0 * (prev_gap_abs or 0.0), 0.25 * scale)
            if dual_bound_k < best_dual - guard:
                # non-monotone dual progress — the diverging_duals
                # signature: a corrupted/overshot price update sent the
                # sites to a uselessly wrong response.  Rescale the
                # dual step and re-anchor the next update at the
                # best-known prices (the corrupted vector never becomes
                # an anchor).
                regressed = True
                dual_rescales += 1
                if stabilize:
                    # a corrupted probe is the hardest null step there
                    # is: contract toward the stability center
                    alpha = max(0.5 * alpha, alpha_min)
                else:
                    step = max(0.5 * step, 0.125)
                TellUser.warning(
                    f"portfolio: dual bound regressed at outer round "
                    f"{k} ({dual_bound_k:.6g} vs best {best_dual:.6g})"
                    f" — dual step rescaled to "
                    f"{alpha if stabilize else step:g}")
        if dual_bound_k > best_dual:
            best_dual = dual_bound_k
            duals_best = {kk: np.array(v) for kk, v in duals.items()}

        for key, oc in rd.outcomes.items():
            columns[key].append(Column(
                phi=oc.phi,
                activity=oc.activity,
                solution=oc.solution,
                round_idx=k))
        # telemetry: one master_solve child per round under the
        # portfolio_dual_loop span (gap/slack/regime attrs) — `dervet-
        # tpu trace` shows where a slow portfolio round went
        mspan = telemetry_trace.start_span(
            "master_solve", rid=request_id,
            attrs={"round": k, "stabilized": stabilize,
                   "columns": sum(len(c) for c in columns.values())})
        try:
            master = _solve_master(columns, rows, spec, price_cap)
        except BaseException as e:
            mspan.end(error=e)
            raise
        gap_abs = max(master.objective - best_dual, 0.0)
        gap_rel = gap_abs / (1.0 + abs(master.objective)
                             + abs(best_dual))
        prev_gap_abs = gap_abs
        mspan.set_attrs({"gap_rel": float(gap_rel),
                         "slack_rel_max": float(master.slack_rel_max),
                         "primal": float(master.objective),
                         "dual_bound": float(dual_bound_k)})

        summ = rd.summary
        result.rounds.append({
            "round": k,
            "wall_s": round(round_wall, 3),
            "iters_p50": summ.get("iters_p50"),
            "iters_p50_seeded": summ.get("iters_p50_seeded"),
            "iters_p50_cold": summ.get("iters_p50_cold"),
            "seeded": int(summ.get("seeded", 0)),
            "dual_iterate": int(summ.get("dual_iterate", 0)),
            "substituted": int(summ.get("substituted", 0)),
            "compile_events": int(summ.get("compile_events", 0)),
            "windows": int(summ.get("windows", 0)),
            "shards": len(plan),
            "shard_detail": rd.shard_records,
            "dual_bound": round(float(dual_bound_k), 6),
            "primal": round(float(master.objective), 6),
            "gap_rel": round(float(gap_rel), 9),
            "slack_rel_max": round(float(master.slack_rel_max), 9),
            "step": (alpha if stabilize else step),
            "regime": None,     # filled by this round's dual update
            "regressed": regressed,
        })
        TellUser.info(
            f"portfolio round {k}: primal {master.objective:.6g}, "
            f"dual bound {best_dual:.6g}, gap {gap_rel:.2e} rel, "
            f"slack {master.slack_rel_max:.2e}, "
            f"iters p50 {result.rounds[-1]['iters_p50']}, "
            f"{result.rounds[-1]['compile_events']} compile(s)")
        if on_round is not None:
            on_round(k, result)
        if gap_rel <= spec.gap_tol and \
                master.slack_rel_max <= spec.feas_tol:
            result.converged = True
            result.outer_rounds = k + 1
            result.rounds[-1]["regime"] = "converged"
            mspan.set_attr("regime", "converged").end()
            break
        if master.slack_rel_max > spec.feas_tol and k >= 2:
            # runtime infeasibility: the elastic slack persists while
            # its rows' prices sit at the cap and new columns stopped
            # helping — no dispatch mix can satisfy the rows
            prev_slack = result.rounds[-2]["slack_rel_max"]
            w = master.slack_worst or {}
            at_cap = bool(w) and duals.get(w.get("kind")) is not None \
                and float(np.max(duals[w["kind"]])) >= 0.99 * price_cap
            if at_cap and master.slack_rel_max > 0.9 * prev_slack:
                err = PortfolioInfeasibleError(
                    "portfolio coupling rows proved unsatisfiable at "
                    f"runtime: {w.get('kind')} row t={w.get('t')} "
                    f"keeps {w.get('slack_kw', 0.0):.1f} kW of elastic "
                    f"slack with its dual price at the "
                    f"{price_cap:g} cap",
                    violations=[{**w, "runtime": True}])
                mspan.end(error=err)
                raise err
        # projected dual-ascent step toward the master's marginals,
        # three regimes:
        #  * elastic slack active (or the FIRST feasible master): JUMP
        #    to the marginals outright — penalty prices must be
        #    escaped, not averaged into;
        #  * far from the gap tolerance: stabilized step (weighted
        #    Dantzig-Wolfe, cap 0.35) — pure marginals oscillate
        #    between degenerate master vertices, the damped center
        #    converges faster;
        #  * NEAR the tolerance (gap within 10x): harmonically
        #    DECAYING step — the prices are already close to lam*, and
        #    a vanishing step drives the round-over-round price delta
        #    toward zero, which is exactly what the dual_iterate warm
        #    seeds feed on (measured: late rounds collapse to ~1/8 of
        #    a cold solve at bench shapes).
        # A detected regression re-anchors at the best-known prices
        # with a halved step (the corrupted vector never anchors).
        was_feasible = prev_master_feasible
        prev_master_feasible = master.slack_rel_max <= spec.feas_tol
        target = master.duals
        new_duals = {}
        if regressed:
            regime = "regressed"
            a = alpha if stabilize else step
            for kind in rows.kinds:
                lam = duals_best[kind] + a * (target[kind]
                                              - duals_best[kind])
                new_duals[kind] = np.clip(lam, 0.0, price_cap)
        elif not (prev_master_feasible and was_feasible):
            regime = "jump"
            for kind in rows.kinds:
                new_duals[kind] = np.clip(target[kind], 0.0, price_cap)
        elif stabilize:
            # in-out / proximal-level step.  Serious/null test: did this
            # round's probe (the dual bound at the CURRENT prices) reach
            # the level set last round carved between the best bound and
            # the master objective?  Serious — the in-out point is
            # paying — lengthen alpha toward the master marginals; null
            # — a degenerate-vertex excursion — contract toward the
            # stability center.  The separation point always leaves the
            # CENTER (duals_best), never the last probe, so vertex
            # oscillation cannot compound across rounds; and as the gap
            # closes both the center and the marginals pin to lam*, the
            # round-over-round price delta vanishes, and the
            # dual_iterate warm seeds keep their food supply.
            serious = level_prev is None or dual_bound_k >= level_prev
            if serious:
                alpha = min(alpha_max, 1.5 * alpha)
                nulls = 0
                regime = "in_out_serious"
            else:
                alpha = max(alpha_min, 0.5 * alpha)
                nulls += 1
                regime = "in_out_null"
            level_prev = best_dual + level_frac * gap_abs
            a_eff = alpha
            if nulls >= 2:
                # stall escape: two consecutive null probes mean the
                # in-out point stopped teaching the master anything —
                # probe the PURE marginals once (the exact-CG
                # separation point), which is what preserves finite
                # convergence on exact toy problems and re-arms the
                # level test on a genuinely new vertex
                a_eff = 1.0
                nulls = 0
                regime = "in_out_exact"
            for kind in rows.kinds:
                lam = duals_best[kind] + a_eff * (target[kind]
                                                  - duals_best[kind])
                new_duals[kind] = np.clip(lam, 0.0, price_cap)
        else:
            if gap_rel <= 10.0 * spec.gap_tol:
                n_close = sum(1 for r in result.rounds
                              if r["gap_rel"] <= 10.0 * spec.gap_tol)
                step = max(2.0 / (2.0 + n_close), 0.02)
                regime = "harmonic"
            else:
                step = min(0.35, step * 1.6)
                regime = "capped"
            for kind in rows.kinds:
                lam = duals[kind] + step * (target[kind] - duals[kind])
                new_duals[kind] = np.clip(lam, 0.0, price_cap)
        flat = rows.stack_duals(new_duals)
        bad = faultinject.maybe_diverge_duals(k, flat)
        if bad is not None:
            # the corrupted vector stays sign-valid but NOT cap-valid:
            # a diverging update is precisely an out-of-scale price
            new_duals = rows.unstack_duals(np.maximum(bad, 0.0))
        if rows.demand_charge is not None and \
                "demand_charge" in new_duals:
            # dual feasibility of the epigraph block: sum mu <= D
            tot = float(np.sum(new_duals["demand_charge"]))
            if tot > rows.demand_charge > 0:
                new_duals["demand_charge"] *= rows.demand_charge / tot
        duals = new_duals
        result.rounds[-1]["regime"] = regime
        mspan.set_attr("regime", regime).end()
    else:
        result.outer_rounds = spec.max_outer

    # ---- final blend + certification --------------------------------
    assert master is not None
    A_blend = np.zeros(T)
    for key, s in scens.items():
        blend: Dict[str, np.ndarray] = {}
        for col in columns[key]:
            if col.weight <= 0.0:
                continue
            for name, arr in col.solution.items():
                if name not in blend:
                    blend[name] = np.zeros_like(np.asarray(arr,
                                                           np.float64))
                blend[name] += col.weight * np.asarray(arr, np.float64)
        result.site_solutions[key] = blend
        site_A = scens[key].activity_series(blend)
        A_blend += site_A
        result.per_site[key] = {
            "objective_cx": float(sum(col.weight * col.phi
                                      for col in columns[key])),
            "weights": [float(col.weight) for col in columns[key]],
            "net_export": site_A - site_loads[key],
        }
    result.objective_cx = float(sum(v["objective_cx"]
                                    for v in result.per_site.values()))
    c0_total = float(sum(sum(s._c0_by_label.values())
                         for s in scen_list))
    result.demand_charge_cost = (rows.demand_charge or 0.0) * master.M
    result.objective_total = (result.objective_cx + c0_total
                              + result.demand_charge_cost)
    result.primal_objective = master.objective
    result.dual_bound = best_dual
    gap_abs = max(result.primal_objective - best_dual, 0.0)
    result.gap_rel = gap_abs / (1.0 + abs(result.primal_objective)
                                + abs(best_dual))
    result.dual_rescales = dual_rescales
    result.duals = duals
    result.price = rows.price(duals)
    result.aggregate = {"activity": A_blend,
                        "net_export": A_blend - load_total,
                        "load": load_total}
    if not result.outer_rounds:
        result.outer_rounds = len(result.rounds)

    coupling_rows = [{"kind": kind,
                      "lhs": rows.activity(kind, A_blend, M=master.M),
                      "rhs": rows.rhs[kind]}
                     for kind in rows.kinds]
    cert_by_site = {k: oc.certification
                    for k, oc in last_rd.outcomes.items()}
    n_windows = sum(len(s.windows) for s in scen_list)
    n_cert = sum(int(c.get("certified", 0))
                 + int(c.get("certified_loose", 0))
                 for c in cert_by_site.values() if c)
    per_site_cert = {"windows_total": int(n_windows),
                     "windows_certified": int(n_cert),
                     "all_certified": bool(n_cert >= n_windows)}
    policy = (certify.CertPolicy(enabled=False) if degraded
              else certify.policy_from_env())
    result.certification = certify.certify_portfolio(
        coupling_rows, result.primal_objective, result.dual_bound,
        policy, inner_exact=(backend == "cpu"), per_site=per_site_cert)

    from ..io.summary import run_health_report
    health = run_health_report(
        {k: (oc.health or {}) for k, oc in last_rd.outcomes.items()},
        {k: oc.quarantine for k, oc in last_rd.outcomes.items()
         if oc.quarantine is not None},
        certification_by_case=cert_by_site)
    health["fidelity"] = result.fidelity
    health["portfolio"] = result.portfolio_section()
    result.run_health = health
    if ledger is not None:
        ledger = dict(ledger)
        ledger["portfolio"] = result.portfolio_section()
    result.solve_ledger = ledger
    result.request_latency_s = time.monotonic() - t_start
    TellUser.info(
        f"portfolio: {len(scens)} site(s), {result.outer_rounds} outer "
        f"round(s), gap {result.gap_rel:.2e} rel, "
        f"verdict {result.certification.get('verdict')}, "
        f"{result.request_latency_s:.2f}s")
    return result


# ---------------------------------------------------------------------------
# Monolithic reference (tests / cross-validation)
# ---------------------------------------------------------------------------

def monolithic_reference(spec: PortfolioSpec) -> Dict:
    """Solve the FULL coupled portfolio LP as one monolithic HiGHS
    problem — every member's window LPs stacked block-diagonally with
    the coupling rows appended — the exactness reference the 2-site
    decomposition test agrees with to 1e-6.  Host-only; scales to toy
    portfolios, which is its whole job."""
    from scipy.optimize import linprog
    spec.validate()
    scens = build_site_scenarios(spec)
    index = next(iter(scens.values())).index
    T = len(index)
    load_total = np.zeros(T)
    for s in scens.values():
        load_total += s.load_series()
    rows = CouplingRows.build(spec, T, load_total)

    blocks = []          # (site, ctx, lp, var_offset)
    offset = 0
    c_parts, l_parts, u_parts = [], [], []
    for key in sorted(scens, key=str):
        s = scens[key]
        lps = _build_all_lps(s)
        for ctx in s.windows:
            lp = lps[int(ctx.label)]
            blocks.append((key, ctx, lp, offset))
            c_parts.append(np.asarray(lp.c, np.float64))
            l_parts.append(np.asarray(lp.l, np.float64))
            u_parts.append(np.asarray(lp.u, np.float64))
            offset += lp.n
    n_tot = offset
    has_M = "demand_charge" in rows.kinds
    c = np.concatenate(c_parts + ([np.array([rows.demand_charge or 0.0])]
                                  if has_M else []))
    lo = np.concatenate(l_parts + ([np.array([0.0])] if has_M else []))
    hi = np.concatenate(u_parts + ([np.array([np.inf])] if has_M else []))

    eq_r, eq_c, eq_v, eq_b = [], [], [], []
    ub_r, ub_c, ub_v, ub_b = [], [], [], []
    eq_row = ub_row = 0
    for key, ctx, lp, off in blocks:
        K = lp.K.tocoo()
        q = np.asarray(lp.q, np.float64)
        for r, cc, v in zip(K.row, K.col, K.data):
            if r < lp.n_eq:
                eq_r.append(eq_row + r)
                eq_c.append(off + cc)
                eq_v.append(v)
            else:
                # ge rows -> LE form: -Kx <= -q
                ub_r.append(ub_row + (r - lp.n_eq))
                ub_c.append(off + cc)
                ub_v.append(-v)
        eq_b.extend(q[:lp.n_eq])
        ub_b.extend(-q[lp.n_eq:])
        eq_row += lp.n_eq
        ub_row += lp.m - lp.n_eq
    # coupling rows (LE-normalized): sign * sum_s A_s(t) (- M) <= rhs
    scen_terms = {key: scens[key].term_names() for key in scens}
    for kind in rows.kinds:
        for t in range(T):
            for key, ctx, lp, off in blocks:
                pos = int(np.searchsorted(scens[key].index,
                                          ctx.index[0]))
                if not pos <= t < pos + ctx.T:
                    continue
                for name, sign in scen_terms[key]:
                    ref = lp.var_refs.get(name)
                    if ref is None or ref.size != ctx.T:
                        continue
                    ub_r.append(ub_row)
                    ub_c.append(off + ref.start + (t - pos))
                    ub_v.append(rows.sign[kind] * sign)
            if kind == "demand_charge":
                ub_r.append(ub_row)
                ub_c.append(n_tot)
                ub_v.append(-1.0)
            ub_b.append(rows.rhs[kind][t])
            ub_row += 1
    n_vars = n_tot + (1 if has_M else 0)
    A_eq = sp.coo_matrix((eq_v, (eq_r, eq_c)),
                         shape=(eq_row, n_vars)).tocsr()
    A_ub = sp.coo_matrix((ub_v, (ub_r, ub_c)),
                         shape=(ub_row, n_vars)).tocsr()
    res = linprog(c, A_ub=A_ub, b_ub=np.asarray(ub_b),
                  A_eq=A_eq, b_eq=np.asarray(eq_b),
                  bounds=np.stack([lo, hi], axis=1), method="highs")
    return {"status": int(res.status),
            "objective_cx": (float(res.fun) if res.fun is not None
                             else float("nan")),
            "message": str(res.message)}


# ---------------------------------------------------------------------------
# Observability schema
# ---------------------------------------------------------------------------

def validate_portfolio_section(section: Dict) -> Dict:
    """Schema-check a ``portfolio`` observability section (the
    run_health / solve_ledger / metrics surface).  Raises ``ValueError``
    naming the missing field; returns the section unchanged."""
    if not isinstance(section, dict):
        raise ValueError(
            f"portfolio section must be a dict, got {type(section)}")
    for k in ("converged", "outer_rounds", "dual_rescales", "stabilized",
              "shards", "gap_rel", "objective_cx", "sites", "rounds",
              "certification"):
        if k not in section:
            raise ValueError(f"portfolio section missing {k!r}")
    if not isinstance(section["rounds"], list) or not section["rounds"]:
        raise ValueError("portfolio section rounds must be a non-empty "
                         "list")
    for i, r in enumerate(section["rounds"]):
        for k in ("round", "iters_p50", "seeded", "dual_iterate",
                  "substituted", "compile_events", "windows", "shards",
                  "regime", "gap_rel", "slack_rel_max", "step"):
            if k not in r:
                raise ValueError(
                    f"portfolio section rounds[{i}] missing {k!r}")
    certify.validate_portfolio_certification(section["certification"])
    return section
