"""Portfolio specification: member sites + the coupling constraints.

A portfolio request solves a FLEET of sites as one coupled LP.  Each
member is an ordinary :class:`~dervet_tpu_torch.io.params.CaseParams` (one
site's DER fleet + value streams + data); the coupling constraints tie
their dispatches together through the aggregate net export

    E(t) = sum_s e_s(t)        e_s(t) = site s net export at the POI

which the per-site LPs expose linearly through their DER power terms
(``POI.net_export_terms``) minus each site's constant load.  Four
coupling families are supported, each a row block over the shared
horizon (all are LE-normalized internally; see ``coupling_rows``):

* ``export_cap_kw``    — aggregate market/feeder export cap:
                         ``E(t) <= cap(t)``
* ``import_cap_kw``    — aggregate feeder/transformer import cap:
                         ``-E(t) <= icap(t)``
* ``export_bid_kw``    — a shared export bid the portfolio must
                         deliver: ``E(t) >= bid(t)`` (the bid revenue
                         itself is a constant and never moves the
                         argmin; delivery is the constraint)
* ``demand_charge_per_kw`` — a portfolio-level demand charge ``D`` on
                         the peak aggregate import: epigraph variable
                         ``M >= -E(t)`` priced ``D`` in the master,
                         whose duals are simplex-bounded
                         ``sum_t mu_t <= D``

Scalars broadcast over the horizon; arrays must match its length.
Every kind contributes a non-negative dual price vector; the combined
per-timestep price on net export, ``p(t) = lam_exp(t) - lam_imp(t)
- nu_bid(t) - mu_dem(t)``, is the ONLY thing the inner per-site solves
ever see — a dual update perturbs each site's cost vector ``c`` and
nothing else, which is what makes the inner step a plain
``run_dispatch`` batch and the warm-start memory's ``dual_iterate``
grade the reseeding path.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, List, Optional

import numpy as np

from ..utils.errors import ParameterError

# kill switch for the stabilized Dantzig-Wolfe master: =0 restores the
# legacy three-regime step (jump / 0.35-capped / harmonic decay) bit for
# bit, spec.master_stabilization notwithstanding
STABILIZE_ENV = "DERVET_TPU_PORTFOLIO_STABILIZE"
# shard-count override for the fleet-sharded inner rounds (solo callers;
# the spec field wins when set)
SHARDS_ENV = "DERVET_TPU_PORTFOLIO_SHARDS"


def stabilization_enabled(spec: "PortfolioSpec") -> bool:
    """The effective master-stabilization switch: the spec default is
    ON; the env kill switch forces the legacy loop regardless (read per
    call so an operator can flip it mid-incident)."""
    if os.environ.get(STABILIZE_ENV, "1").strip().lower() in (
            "0", "false", "off"):
        return False
    return bool(spec.master_stabilization)

# the kinds, in canonical order (dual vectors stack in this order for
# fault injection / serialization)
COUPLING_KINDS = ("export_cap", "import_cap", "export_bid",
                  "demand_charge")

# objective-breakdown label the dual price shift rides under, so the
# per-window labeled components still sum exactly to the reported total
# (the invariant audit's objective_components check)
COUPLING_LABEL = "Portfolio Coupling Price"


def _as_profile(value, T: int, what: str) -> Optional[np.ndarray]:
    """Scalar -> constant profile; array -> validated length-T float64
    profile; None passes through."""
    if value is None:
        return None
    arr = np.asarray(value, np.float64)
    if arr.ndim == 0:
        return np.full(T, float(arr))
    if arr.shape != (T,):
        raise ParameterError(
            f"portfolio: {what} profile has length {arr.shape}, the "
            f"shared horizon has {T} steps")
    if not np.all(np.isfinite(arr)):
        raise ParameterError(f"portfolio: {what} profile has non-finite "
                             "entries")
    return arr


@dataclasses.dataclass
class PortfolioSpec:
    """One coupled-portfolio request.

    ``members`` maps a site key (names artifacts; same alphabet rules as
    request ids) to its :class:`CaseParams`.  At least one coupling
    field must be set — an uncoupled portfolio is just a batch of
    independent requests and should be submitted as one.

    Solver knobs: ``gap_tol`` / ``feas_tol`` are the RELATIVE duality-
    gap and coupling-feasibility termination tolerances (the float64
    portfolio certificate grades against the certification policy's own
    bands independently); ``max_outer`` bounds the dual iterations;
    ``price_cap`` bounds every dual price — an elastic master keeps
    restricted infeasibility diagnosable instead of unbounded, and a
    price AT the cap with persistent slack is the runtime infeasibility
    signal.  The default (None) auto-derives the cap as 10x the fleet's
    own maximum cost coefficient on a power term: beyond the data's
    price scale every site response is already extremal, and handing
    PDHG penalty-scale prices just burns inner iterations.
    ``max_columns`` bounds the per-site column pool the primal-recovery
    master blends over.

    ``master_stabilization`` (default ON) runs the dual update as an
    in-out / proximal-level stabilized step: the separation point blends
    the STABILITY CENTER (the prices behind the best dual bound) toward
    the restricted master's marginals, with a level-set test on the dual
    bound deciding serious vs null steps — degenerate-vertex dual
    oscillation stops burning outer rounds (the column-generation tail
    the harmonic-decay step only papered over).  ``False`` — or the
    ``DERVET_TPU_PORTFOLIO_STABILIZE=0`` kill switch — restores the
    legacy three-regime loop bit for bit.

    ``shards`` partitions one dual round's member batch into N
    structure-aware shards dispatched concurrently (in-process on the
    one device, or across fleet replicas when ``solve_portfolio``
    is handed a ``fleet`` router).  ``None``/1 keeps today's one-
    dispatch round bit for bit; the ``DERVET_TPU_PORTFOLIO_SHARDS`` env
    var overrides a ``None`` for solo callers."""

    members: Dict[str, object]
    export_cap_kw: Optional[object] = None
    import_cap_kw: Optional[object] = None
    export_bid_kw: Optional[object] = None
    demand_charge_per_kw: Optional[float] = None
    gap_tol: float = 1e-3
    feas_tol: float = 1e-4
    max_outer: int = 12
    price_cap: Optional[float] = None
    max_columns: int = 20
    master_stabilization: bool = True
    shards: Optional[int] = None

    def validate(self) -> "PortfolioSpec":
        if not isinstance(self.members, dict) or not self.members:
            raise ParameterError(
                "portfolio: members must be a non-empty dict of "
                "site key -> CaseParams")
        if len(self.members) < 2:
            raise ParameterError(
                "portfolio: a portfolio couples >= 2 sites (submit a "
                "single site as an ordinary request)")
        if not any(v is not None for v in (
                self.export_cap_kw, self.import_cap_kw,
                self.export_bid_kw, self.demand_charge_per_kw)):
            raise ParameterError(
                "portfolio: no coupling constraint set — an uncoupled "
                "portfolio is just independent requests")
        if self.demand_charge_per_kw is not None \
                and float(self.demand_charge_per_kw) < 0:
            raise ParameterError("portfolio: demand_charge_per_kw < 0")
        if self.max_outer < 1:
            raise ParameterError("portfolio: max_outer must be >= 1")
        if self.gap_tol <= 0 or self.feas_tol <= 0:
            raise ParameterError("portfolio: gap_tol/feas_tol must be "
                                 "positive")
        if self.price_cap is not None and self.price_cap <= 0:
            raise ParameterError("portfolio: price_cap must be positive")
        if self.max_columns < 2:
            raise ParameterError("portfolio: max_columns must be >= 2")
        if self.shards is not None and int(self.shards) < 1:
            raise ParameterError("portfolio: shards must be >= 1")
        return self

    def effective_shards(self, n_sites: int) -> int:
        """The shard count one dual round actually runs with: the spec
        field, else the env override, else 1 (monolithic) — always
        clamped to the site count (an empty shard is never planned)."""
        n = self.shards
        if n is None:
            try:
                n = int(os.environ.get(SHARDS_ENV, "1"))
            except ValueError:
                n = 1
        return max(1, min(int(n), int(n_sites)))

    # ------------------------------------------------------------------
    def coupling_profiles(self, T: int) -> Dict[str, np.ndarray]:
        """kind -> length-T cap/bid profile (only the kinds set)."""
        out = {}
        exp = _as_profile(self.export_cap_kw, T, "export_cap_kw")
        if exp is not None:
            out["export_cap"] = exp
        imp = _as_profile(self.import_cap_kw, T, "import_cap_kw")
        if imp is not None:
            out["import_cap"] = imp
        bid = _as_profile(self.export_bid_kw, T, "export_bid_kw")
        if bid is not None:
            out["export_bid"] = bid
        if self.demand_charge_per_kw is not None:
            out["demand_charge"] = np.zeros(T)   # rhs filled from load
        return out

    def normalized(self) -> Dict:
        """JSON-stable spec summary (fingerprints, artifacts) — member
        CONTENT is fingerprinted separately by the service."""
        def _p(v):
            if v is None:
                return None
            a = np.asarray(v, np.float64)
            return float(a) if a.ndim == 0 else [float(x) for x in a]
        return {
            "sites": sorted(str(k) for k in self.members),
            "export_cap_kw": _p(self.export_cap_kw),
            "import_cap_kw": _p(self.import_cap_kw),
            "export_bid_kw": _p(self.export_bid_kw),
            "demand_charge_per_kw": (
                None if self.demand_charge_per_kw is None
                else float(self.demand_charge_per_kw)),
            "gap_tol": float(self.gap_tol),
            "feas_tol": float(self.feas_tol),
            "max_outer": int(self.max_outer),
            "price_cap": (None if self.price_cap is None
                          else float(self.price_cap)),
            "max_columns": int(self.max_columns),
            "master_stabilization": bool(self.master_stabilization),
            "shards": (None if self.shards is None else int(self.shards)),
        }

    def fingerprint_knobs(self) -> str:
        import json
        h = hashlib.sha256()
        h.update(json.dumps(self.normalized(), sort_keys=True).encode())
        return h.hexdigest()


@dataclasses.dataclass
class CouplingRows:
    """The LE-normalized coupling row system over the shared horizon.

    Every family is expressed on the aggregate VARIABLE activity
    ``A(t) = sum_s (site power-term contributions)`` — site constant
    loads fold into the rhs (``A(t) = E(t) + L(t)`` where ``L`` is the
    portfolio's total fixed load):

    * export_cap:     ``+A(t) <= cap(t) + L(t)``
    * import_cap:     ``-A(t) <= icap(t) - L(t)``
    * export_bid:     ``-A(t) <= -(bid(t) + L(t))``
    * demand_charge:  ``-A(t) - M <= -L(t)``   (M the epigraph var)

    ``sign[kind]`` is the coefficient on ``A(t)``; the combined dual
    price on net export is ``p(t) = sum_kind sign_kind * lam_kind(t)``.
    """

    T: int
    kinds: List[str]
    sign: Dict[str, float]
    rhs: Dict[str, np.ndarray]
    demand_charge: Optional[float] = None

    @classmethod
    def build(cls, spec: PortfolioSpec, T: int,
              total_load: np.ndarray) -> "CouplingRows":
        profiles = spec.coupling_profiles(T)
        kinds, sign, rhs = [], {}, {}
        L = np.asarray(total_load, np.float64)
        if "export_cap" in profiles:
            kinds.append("export_cap")
            sign["export_cap"] = +1.0
            rhs["export_cap"] = profiles["export_cap"] + L
        if "import_cap" in profiles:
            kinds.append("import_cap")
            sign["import_cap"] = -1.0
            rhs["import_cap"] = profiles["import_cap"] - L
        if "export_bid" in profiles:
            kinds.append("export_bid")
            sign["export_bid"] = -1.0
            rhs["export_bid"] = -(profiles["export_bid"] + L)
        if "demand_charge" in profiles:
            kinds.append("demand_charge")
            sign["demand_charge"] = -1.0
            rhs["demand_charge"] = -L
        return cls(T=T, kinds=kinds, sign=sign, rhs=rhs,
                   demand_charge=(None if spec.demand_charge_per_kw is None
                                  else float(spec.demand_charge_per_kw)))

    def zero_duals(self) -> Dict[str, np.ndarray]:
        return {k: np.zeros(self.T) for k in self.kinds}

    def price(self, duals: Dict[str, np.ndarray]) -> np.ndarray:
        """Combined per-timestep dual price on the aggregate activity
        ``A(t)`` (equivalently on each site's net export terms)."""
        p = np.zeros(self.T)
        for k in self.kinds:
            p += self.sign[k] * np.asarray(duals[k], np.float64)
        return p

    def stack_duals(self, duals: Dict[str, np.ndarray]) -> np.ndarray:
        return np.concatenate([np.asarray(duals[k], np.float64)
                               for k in self.kinds]) \
            if self.kinds else np.zeros(0)

    def unstack_duals(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        out = {}
        for i, k in enumerate(self.kinds):
            out[k] = np.asarray(flat[i * self.T:(i + 1) * self.T],
                                np.float64)
        return out

    def activity(self, kind: str, A: np.ndarray,
                 M: float = 0.0) -> np.ndarray:
        """LE-normalized lhs of one family for aggregate activity ``A``
        (and epigraph value ``M`` for the demand-charge rows)."""
        lhs = self.sign[kind] * np.asarray(A, np.float64)
        if kind == "demand_charge":
            lhs = lhs - float(M)
        return lhs

    def dual_rhs_term(self, duals: Dict[str, np.ndarray]) -> float:
        """``sum_r lam_r * b_r`` — the constant the Lagrangian dual
        bound subtracts (all rows LE-normalized, duals >= 0)."""
        return float(sum(np.asarray(duals[k], np.float64) @ self.rhs[k]
                         for k in self.kinds))
