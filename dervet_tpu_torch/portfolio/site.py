"""Per-site scenario for the portfolio dual loop.

``PortfolioSiteScenario`` is a :class:`MicrogridScenario` whose window
LPs carry the CURRENT dual prices on the coupling rows: the dual update
only ever perturbs each site's cost vector ``c`` (by ``p(t) * sign``
on every DER power term), so the whole inner step stays an ordinary
``run_dispatch`` batch over structure-identical windows — the same
cached solvers round after round, which is what amortizes the solver
builds to zero after the first outer round.  The price shift also
registers as an
explicit objective-breakdown component (``spec.COUPLING_LABEL``) so the
invariant audit's components-sum-to-total check keeps holding, and the
TRUE (unshifted) site cost stays recoverable in float64.

Each built LP additionally carries ``lp.seed_hint = (tag, site,
window)`` — the warm-start memory's ``dual_iterate`` grade key — so
dual iteration k+1 reseeds every window from its iteration-k iterate
even though the price shift moves every float16-quantized digest
feature (ops/warmstart.py).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ops.lp import LP
from ..scenario.scenario import MicrogridScenario
from ..scenario.window import WindowContext
from ..utils.errors import ParameterError
from .spec import COUPLING_LABEL


class _RefLookup:
    """Minimal LPBuilder facade over an assembled LP's ``var_refs`` —
    just enough surface (``[]`` and ``has``) for the DER models'
    ``power_terms`` to resolve their variable blocks."""

    def __init__(self, var_refs):
        self._refs = var_refs

    def __getitem__(self, name):
        return self._refs[name]

    def has(self, name) -> bool:
        return name in self._refs


class PortfolioSiteScenario(MicrogridScenario):
    """One member site inside a portfolio solve."""

    def __init__(self, case, site_key: str, seed_tag: Optional[str] = None):
        super().__init__(case)
        self.site_key = str(site_key)
        # hint namespace: the service passes the request id so two
        # concurrent portfolio requests sharing one memory never
        # cross-seed; one-shot engines get a fresh default
        self._seed_tag = str(seed_tag) if seed_tag else "portfolio"
        # combined per-timestep dual price on net export (full horizon);
        # None or all-zero = the independent (round 0) solve
        self.coupling_price: Optional[np.ndarray] = None
        # (name, sign) power terms, resolved from the first built LP
        self._term_names: Optional[List[Tuple[str, float]]] = None
        # per-window constant objective offsets (fixed O&M etc.) —
        # needed to recover float64 c@x from the reported breakdown
        self._c0_by_label: Dict[int, float] = {}
        self._validate_member()

    # ------------------------------------------------------------------
    def _validate_member(self) -> None:
        """Portfolio members are plain dispatch cases: the dual loop
        re-solves every window per outer round, which is incompatible
        with one-shot sizing freezes, MILP windows, and SOH stepping."""
        what = f"portfolio member {self.site_key!r}"
        if self.poi.is_sizing_optimization:
            raise ParameterError(f"{what}: sizing cases cannot join a "
                                 "portfolio (freeze sizes first)")
        if self.incl_binary:
            raise ParameterError(f"{what}: binary (MILP) formulations "
                                 "cannot join a portfolio")
        if any(getattr(d, "incl_cycle_degrade", False) for d in self.ders):
            raise ParameterError(f"{what}: degradation-coupled cases "
                                 "cannot join a portfolio")
        if not self.opt_engine:
            raise ParameterError(f"{what}: reliability-only cases have "
                                 "no dispatch to couple")
        for yr in self.opt_years:
            if any(not d.operational(yr) for d in self.ders):
                raise ParameterError(
                    f"{what}: every DER must be operational across the "
                    f"horizon (a DER retires in {yr})")

    # ------------------------------------------------------------------
    def build_window_lp(self, ctx: WindowContext, annuity_scalar=1.0,
                        requirements=None,
                        template: Optional[LP] = None) -> LP:
        lp = super().build_window_lp(ctx, annuity_scalar, requirements,
                                     template=template)
        self._c0_by_label[int(ctx.label)] = float(lp.c0)
        if self._term_names is None:
            b = _RefLookup(lp.var_refs)
            self._term_names = [(ref.name, float(sign))
                                for ref, sign in
                                self.poi.net_export_terms(b)]
        p = self.coupling_price
        if p is not None and lp.integrality is None:
            pos = int(np.searchsorted(self.index, ctx.index[0]))
            pw = np.asarray(p[pos:pos + ctx.T], np.float64)
            if pw.any():
                dc = np.zeros(lp.n)
                for name, sign in self._term_names:
                    ref = lp.var_refs.get(name)
                    if ref is not None and ref.size == ctx.T:
                        dc[ref.sl] += sign * pw
                # c was freshly assembled for this window (build/
                # build_data never alias the template's c) — in-place is
                # safe, and registering the shift as its own labeled
                # component keeps the audit's component-sum identity
                lp.c = lp.c + dc
                lp.cost_groups[COUPLING_LABEL] = (dc, 0.0)
        # dual-iterate reseeding key (ops/warmstart.py hint table)
        lp.seed_hint = ("portfolio", self._seed_tag, self.site_key,
                        int(ctx.label))
        return lp

    # ------------------------------------------------------------------
    def term_names(self) -> List[Tuple[str, float]]:
        if self._term_names is None:
            raise RuntimeError("term_names before any window LP was "
                               "built")
        return list(self._term_names)

    def activity_series(self, solution: Optional[Dict] = None
                        ) -> np.ndarray:
        """Full-horizon aggregate of this site's power-term VARIABLES
        ``A_s(t) = sum(sign * x)`` — the quantity the coupling rows act
        on (net export is ``A_s(t) - load_s(t)``)."""
        sol = solution if solution is not None else self._solution
        A = np.zeros(len(self.index))
        for name, sign in self.term_names():
            arr = sol.get(name)
            if arr is not None:
                A += sign * np.asarray(arr, np.float64)
        return A

    def load_series(self) -> np.ndarray:
        """Full-horizon constant load (site load + DER fixed loads)."""
        self.poi.grab_active_ders(int(self.index[0].year))
        ctx = WindowContext(label=-1, index=self.index,
                            ts=self.time_series,
                            monthly=self.case.datasets.monthly,
                            dt=self.dt)
        return np.asarray(self.poi.site_load(ctx), np.float64)

    def true_cost_cx(self) -> float:
        """Float64 ``c_base @ x`` of the CURRENT solution over all
        windows — the shifted solver objective minus the coupling
        component, both recovered from the float64 breakdown (the
        reported ``Total Objective`` is ``c@x + c0 - tilt``; the tilt
        and coupling columns ride the breakdown explicitly)."""
        from ..models.streams.markets import TILT_LABEL
        total = 0.0
        for label, breakdown in self.objective_values.items():
            t = breakdown.get("Total Objective")
            if t is None:
                continue
            cx_shifted = (t - self._c0_by_label.get(int(label), 0.0)
                          + breakdown.get(TILT_LABEL, 0.0))
            total += cx_shifted - breakdown.get(COUPLING_LABEL, 0.0)
        return float(total)

    def shifted_cost_cx(self) -> float:
        """Float64 ``(c_base + dc) @ x`` over all windows — the inner
        subproblem's own objective, the dual bound's raw material."""
        from ..models.streams.markets import TILT_LABEL
        total = 0.0
        for label, breakdown in self.objective_values.items():
            t = breakdown.get("Total Objective")
            if t is None:
                continue
            total += (t - self._c0_by_label.get(int(label), 0.0)
                      + breakdown.get(TILT_LABEL, 0.0))
        return float(total)

    def term_bounds(self, lps_by_label: Dict[int, LP]
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-timestep (lo, hi) bounds on this site's activity
        ``A_s(t)`` from the window LPs' variable boxes — the relaxation
        the pre-flight infeasibility check uses (intertemporal coupling
        ignored, so a violated bound is CONCLUSIVE infeasibility)."""
        T = len(self.index)
        lo = np.zeros(T)
        hi = np.zeros(T)
        for ctx in self.windows:
            lp = lps_by_label.get(int(ctx.label))
            if lp is None:
                continue
            pos = int(np.searchsorted(self.index, ctx.index[0]))
            for name, sign in self.term_names():
                ref = lp.var_refs.get(name)
                if ref is None or ref.size != ctx.T:
                    continue
                l = np.asarray(lp.l[ref.sl], np.float64) * sign
                u = np.asarray(lp.u[ref.sl], np.float64) * sign
                lo[pos:pos + ctx.T] += np.minimum(l, u)
                hi[pos:pos + ctx.T] += np.maximum(l, u)
        return lo, hi
