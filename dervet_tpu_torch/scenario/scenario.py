"""Scenario runtime: the per-case orchestrator and batched dispatch loop.

Re-designs dervet/MicrogridScenario.py + the storagevet Scenario surface
(reference :281-346 solves windows one CVXPY problem at a time).  The
batched difference: optimization windows are grouped by length, every
same-length group shares one preconditioned LP structure (K fixed, c/q/l/u
per window) and solves as a SINGLE batched PDHG call — 12 monthly windows
become 3 batched solves (31/30/28-day groups), a multi-year sensitivity
run becomes a few large batches instead of hundreds of solver calls.

Backend 'torch' runs the batched PDHG solver on the resolved device (the
GPU unless the caller passes ``device="cpu"``), its iteration chunks in the
hand-written CUDA kernels of ``ops/fused_chunk.py``; backend 'cpu' runs
scipy/HiGHS per window for cross-validation — the reference's GLPK role.
With several visible devices, ``run_dispatch`` places structure groups
across them (the elastic scheduler, ``parallel/elastic.py``) or splits
each batch over them (``parallel/mesh.py``).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import pandas as pd

from ..io.params import CaseParams
from ..models.der.base import DER
from ..models.der.ess import Battery
from ..models.streams.base import ValueStream
from ..models.streams.da import DAEnergyTimeShift
from ..models.streams.markets import TILT_LABEL
from ..ops.lp import LP, LPBuilder
from ..ops import certify, cpu_ref
from ..telemetry import trace as telemetry_trace
from ..utils import faultinject
from ..utils.errors import (AggregatedSolverError, MonthlyDataError,
                            ParameterError, SolverError, TellUser,
                            TimeseriesDataError)
from .aggregator import ServiceAggregator
from .poi import POI
from .window import WindowContext, make_windows


def _build_tech_map():
    """Tag -> constructor(keys, scenario, der_id, datasets); mirrors
    TECH_CLASS_MAP at MicrogridScenario.py:71-82."""
    from ..models.der.caes import CAES
    from ..models.der.ev import ElectricVehicle1, ElectricVehicle2
    from ..models.der.generators import CT, CHP, ICE, DieselGenset
    from ..models.der.load import ControllableLoad
    from ..models.der.pv import PV

    def battery(keys, scenario, der_id, datasets):
        return Battery(keys, scenario, der_id, cycle_life=datasets.cycle_life)

    def simple(cls):
        return lambda keys, scenario, der_id, datasets: cls(
            keys, scenario, der_id, datasets)

    return {
        "Battery": battery,
        "CAES": simple(CAES),
        "PV": simple(PV),
        "ICE": simple(ICE),
        "DieselGenset": simple(DieselGenset),
        "CT": simple(CT),
        "CHP": simple(CHP),
        "Load": simple(ControllableLoad),
        "ElectricVehicle1": simple(ElectricVehicle1),
        "ElectricVehicle2": simple(ElectricVehicle2),
    }


def _build_vs_map():
    """Tag -> ValueStream class; mirrors VS_CLASS_MAP (MicrogridScenario.py:83-98)."""
    from ..models.streams import registry
    return registry()


class MicrogridScenario:
    """One sensitivity case: DER fleet + value streams + dispatch loop."""

    def __init__(self, case: CaseParams):
        self.case = case
        self.scenario = case.scenario
        self.dt = float(self.scenario.get("dt", 1))
        self.n = self.scenario.get("n", "year")
        opt_years = self.scenario.get("opt_years", [])
        self.opt_years = [int(y) for y in
                          (opt_years if isinstance(opt_years, list) else [opt_years])]
        self.start_year = int(self.scenario.get("start_year", self.opt_years[0]))
        self.end_year = int(self.scenario.get("end_year", self.opt_years[-1]))
        self.incl_binary = bool(self.scenario.get("binary", False))
        self.opt_engine = True

        ts = case.datasets.time_series
        if ts is None:
            raise TimeseriesDataError("a time_series_filename is required")
        # A missing opt_year is growth-synthesized ONLY when it extends the
        # data contiguously (its prior year exists in the data or was
        # itself synthesized); a gap is rejected.  This is the reference's
        # observable rule (test_1params.py:97-124 + test_3battery.py:94):
        # 007 (data 2017, opt 2017+2018) runs, 025 (data 2017, opt
        # 2017+2019) raises TimeseriesDataError, 039 (monthly 2017, opt
        # 2017+2019) raises MonthlyDataError.
        def check_contiguous(years_in_data, exc, what):
            avail = set(years_in_data)
            for y in sorted(self.opt_years):
                if y not in avail:
                    if y - 1 in avail:
                        avail.add(y)      # synthesizable by growth
                    else:
                        raise exc(
                            f"{what} has no rows for opt_year {y} and no "
                            f"{y - 1} data to grow it from")

        check_contiguous((int(y) for y in ts.index.year.unique()),
                         TimeseriesDataError, "time series data")
        if case.datasets.monthly is not None:
            check_contiguous(
                (int(y) for y in
                 case.datasets.monthly.index.get_level_values(0)),
                MonthlyDataError, "monthly data")
        from ..io.growth import (column_growth_rates, fill_extra_data,
                                 fill_extra_monthly)
        rates = column_growth_rates(self.scenario, case.streams, ts.columns)
        ts = fill_extra_data(ts, self.opt_years, rates)
        case.datasets.time_series = ts
        if case.datasets.monthly is not None:
            case.datasets.monthly = fill_extra_monthly(
                case.datasets.monthly, self.opt_years)
        keep = ts.index.year.isin(self.opt_years)
        ts = ts.loc[keep]
        if not len(ts):
            raise TimeseriesDataError(
                f"time series has no data for opt_years {self.opt_years}")
        self.time_series = ts
        self.index = ts.index
        steps_per_hour = round(1 / self.dt)
        allow_partial = bool(self.scenario.get("allow_partial_year", False))
        for yr in self.opt_years:
            n_steps = int((self.index.year == yr).sum())
            from .window import hours_in_year
            expected = int(hours_in_year(yr) / self.dt)
            if n_steps in (expected, 8760 * steps_per_hour):
                continue
            if allow_partial and n_steps < expected:
                TellUser.warning(
                    f"year {yr}: partial horizon ({n_steps}/{expected} "
                    "steps) — non-optimized project years fill forward "
                    "from PARTIAL-year values")
                continue
            # too many steps is a data-integrity error regardless of the
            # partial-year gate (duplicated timestamps / DST artifacts)
            if n_steps > expected:
                raise TimeseriesDataError(
                    f"year {yr}: {n_steps} steps in time series but only "
                    f"{expected} exist at dt={self.dt} — check for "
                    "duplicated timestamps / DST artifacts")
            raise TimeseriesDataError(
                f"year {yr}: {n_steps} steps in time series, expected "
                f"{expected} at dt={self.dt} (set allow_partial_year "
                "to run a shorter horizon)")

        self.ders: List[DER] = []
        tech_map = _build_tech_map()
        for tag, der_id, keys in case.ders:
            ctor = tech_map.get(tag)
            if ctor is None:
                raise ParameterError(f"unknown DER technology tag {tag!r}")
            self.ders.append(ctor(keys, self.scenario, der_id, case.datasets))

        vs_map = _build_vs_map()
        self.streams: Dict[str, ValueStream] = {}
        for tag, keys in case.streams.items():
            cls = vs_map.get(tag)
            if cls is None:
                raise ParameterError(f"unknown value stream tag {tag!r}")
            self.streams[tag] = cls(keys, self.scenario, case.datasets)

        # analysis-horizon modes 2/3 derive the end year from the shortest/
        # longest DER lifetime (reference initialize_cba ->
        # CBA.find_end_year, MicrogridScenario.py:131-156 / CBA.py:94-130);
        # find_end_year is mode-aware and a no-op for mode 1
        from ..financial.cba import CostBenefitAnalysis
        self.cba = CostBenefitAnalysis(case.finance, self.start_year,
                                       self.end_year, self.opt_years, self.dt)
        new_end = self.cba.find_end_year(self.ders)
        if new_end != self.end_year:
            TellUser.info(f"analysis_horizon_mode "
                          f"{self.cba.analysis_horizon_mode}: end year "
                          f"{self.end_year} -> {new_end}")
            self.end_year = new_end
            self.cba.end_year = new_end
        if self.cba.ecc_mode:
            self.cba.ecc_checks(self.ders, self.streams)
        # lifecycle horizon must be known BEFORE dispatch so that
        # grab_active_ders can drop equipment past its end of life
        for der in self.ders:
            der.set_failure_years(self.end_year, self.start_year)
        self.poi = POI(self.scenario, self.ders)
        self.service_agg = ServiceAggregator(self.streams)
        self.windows = make_windows(self.index, self.time_series,
                                    case.datasets.monthly, self.n, self.dt)
        self.objective_values: Dict[int, Dict[str, float]] = {}
        self.solve_metadata: Dict[str, Any] = {}
        # serving layer: the request this case belongs to (set by the
        # scenario service when it coalesces cases from multiple requests
        # into one dispatch) — threaded into the solve ledger's per-group
        # entries so a request's ledger slice can be reconstructed
        self.request_id: Optional[str] = None
        # case-level failure isolation (resilience layer): a case whose
        # window exhausts the escalation ladder — or fails the pre-dispatch
        # input guards — is quarantined with its diagnosis instead of
        # killing the whole sweep; ``health`` counts every window's path
        # through the ladder for the run-health report
        self.quarantine: Optional[Dict[str, Any]] = None
        self.health: Dict[str, Any] = _new_health()
        # numerical trust layer: per-window float64 certification counts
        # (ops/certify.py) + deterministic shadow-solve drift stats
        self.certification: Dict[str, Any] = certify.new_certification(
            certify.policy_from_env().enabled)
        self._shadow_labels: set = set()

    # ------------------------------------------------------------------
    def build_window_lp(self, ctx: WindowContext, annuity_scalar: float = 1.0,
                        requirements=None, template: Optional[LP] = None) -> LP:
        """Assemble one window's LP.  With ``template`` (a sibling
        sensitivity case's LP for the same window), only the per-case
        data vectors are assembled and the constraint matrix is shared —
        verified byte-exact via the builder's structure digest, falling
        back to a full build on any mismatch (VERDICT r5 #1)."""
        ctx.annuity_scalar = annuity_scalar
        ctx.market_bids = {}
        b = LPBuilder()
        self.poi.grab_active_ders(ctx.year)
        ctx.fixed_load = self.poi.site_load(ctx)
        for der in self.poi.active_ders:
            der.build(b, ctx)
        self.service_agg.build(b, ctx, self.poi.active_ders)
        self.poi.build(b, ctx, requirements or [])
        return b.build_data(template) if template is not None else b.build()

    # ------------------------------------------------------------------
    def sizing_module(self) -> None:
        """Pre-dispatch sizing decisions (reference
        MicrogridScenario.sizing_module, :158-206): reliability-driven
        sizing runs its own module then disables dispatch-based sizing;
        deferral sizing floors the ESS ratings; reliability-only cases skip
        the dispatch engine entirely."""
        rel = self.streams.get("Reliability")
        deferral = self.streams.get("Deferral")
        if self.poi.is_sizing_optimization:
            if deferral is not None:
                if len(self.ders) != 1 or \
                        self.ders[0].technology_type != "Energy Storage System":
                    raise ParameterError(
                        "sizing for deferral is only implemented for a "
                        "single-ESS case (reference restriction)")
                deferral.deferral_analysis(self.ders, self.opt_years,
                                           self.end_year)
                self._deferral_set_min_size(deferral)
            if rel is not None and not rel.post_facto_only:
                n_ess = sum(d.technology_type == "Energy Storage System"
                            for d in self.ders)
                if n_ess > 1:
                    raise ParameterError("multi-ESS reliability sizing is "
                                         "not implemented (reference "
                                         "restriction)")
                if rel.outage_duration <= self.dt:
                    raise ParameterError(
                        f"reliability target must exceed dt={self.dt}h")
                rel.sizing_module(self.ders, self.index)
                self.poi.is_sizing_optimization = False
            else:
                pass  # dispatch-based sizing checks run in the opt loop
        if self.service_agg.is_reliability_only() or \
                self.service_agg.post_facto_reliability_only_and_user_defined_constraints():
            if rel is not None:
                rel.use_sizing_module_results = True
            self.opt_engine = False

    def _deferral_set_min_size(self, deferral) -> None:
        """Deferral requirements floor the ESS size variables at the LAST
        deferred year's (growth-scaled, largest) requirement; both power
        ratings are floored (reference MicrogridServiceAggregator.set_size,
        :81-107 uses deferral_df.loc[start + min_years - 1] and applies the
        min power to ch_max_rated and dis_max_rated)."""
        dd = deferral.deferral_df
        if dd is None or not len(dd):
            return
        last_deferred = self.start_year + max(deferral.min_years - 1, 0)
        row = dd.loc[last_deferred] if last_deferred in dd.index else dd.iloc[0]
        p_req = float(row["Power Requirement (kW)"])
        e_req = float(row["Energy Requirement (kWh)"])
        ess = self.ders[0]
        for which, req in (("ene", e_req), ("dis", p_req), ("ch", p_req)):
            lo, hi = ess.user_bounds[which]
            ess.user_bounds[which] = (max(lo, req), hi)

    # ------------------------------------------------------------------
    def _checkpoint_path(self, checkpoint_dir):
        from pathlib import Path
        return Path(checkpoint_dir) / f"case{self.case.case_id}_windows.npz"

    def _checkpoint_fingerprint(self) -> str:
        """Hash of the inputs that determine per-window solutions — a
        checkpoint from different inputs must be discarded, not resumed.
        Memoized: the inputs are fixed at construction, and the manifest
        consult + checkpoint load would otherwise hash the full time
        series twice per case."""
        memo = getattr(self, "_fingerprint_memo", None)
        if memo is not None:
            return memo
        import hashlib
        h = hashlib.sha256()
        h.update(repr((str(self.index[0]), str(self.index[-1]),
                       len(self.index), self.dt, str(self.n),
                       self.opt_years)).encode())
        for tag, der_id, keys in self.case.ders:
            h.update(repr((tag, der_id, sorted(keys.items()))).encode())
        for tag, keys in sorted(self.case.streams.items()):
            h.update(repr((tag, sorted(keys.items()))).encode())
        ts = self.case.datasets.time_series
        if ts is not None:
            h.update(np.ascontiguousarray(
                ts.to_numpy(dtype=np.float64, na_value=np.nan)).tobytes())
        self._fingerprint_memo = h.hexdigest()
        return self._fingerprint_memo

    def _load_checkpoint(self, checkpoint_dir, solution):
        """Resume per-window results saved by a previous run (SURVEY §5:
        the reference has no checkpointing; per-window results are cheap to
        persist and make long sweeps restartable)."""
        path = self._checkpoint_path(checkpoint_dir)
        if not path.exists():
            return set()
        try:
            data = np.load(path, allow_pickle=True)
            if str(data["__fingerprint__"]) != self._checkpoint_fingerprint():
                TellUser.warning(f"checkpoint {path} was created from "
                                 "different inputs — ignoring it")
                return set()
            labels = set(int(x) for x in data["__labels__"])
            for name in data.files:
                if not name.startswith("__"):
                    solution[name] = data[name]
            import json
            self.objective_values.update(
                {int(k): v for k, v in
                 json.loads(str(data["__objectives__"])).items()})
        except Exception as e:    # truncated/corrupt file: start fresh
            TellUser.warning(f"could not resume checkpoint {path}: {e}")
            return set()
        TellUser.info(f"resumed {len(labels)} solved window(s) from {path}")
        return labels

    def _save_checkpoint(self, checkpoint_dir, solution, solved_labels):
        import json
        from ..utils.supervisor import atomic_output
        path = self._checkpoint_path(checkpoint_dir)
        # tmp + fsync + replace: interruption keeps the old file whole
        with atomic_output(path) as tmp:
            np.savez(tmp,
                     __fingerprint__=self._checkpoint_fingerprint(),
                     __labels__=np.array(sorted(solved_labels)),
                     __objectives__=json.dumps(
                         {str(k): v
                          for k, v in self.objective_values.items()}),
                     **solution)

    # ------------------------------------------------------------------
    # Dispatch runs in phases so that N sensitivity cases can batch their
    # same-structure windows into ONE batched device solve (replaces the
    # reference's serial per-case for-loop, dervet/DERVET.py:75-83).  ``run_dispatch`` below
    # is the driver; ``optimize_problem_loop`` keeps the single-case API.
    # ------------------------------------------------------------------
    def optimize_problem_loop(self, backend: str = "torch",
                              solver_opts=None, checkpoint_dir=None,
                              device=None) -> None:
        """Group windows by structure, batch-solve each group, scatter."""
        run_dispatch([self], backend=backend, solver_opts=solver_opts,
                     checkpoint_dir=checkpoint_dir, device=device)

    def place_walks(self, backend: str, device=None) -> None:
        """Reliability's outage walks run where the dispatch runs: on the
        CPU under the exact backend, else on the dispatch device (``None``
        -> the first GPU, raising when none is visible)."""
        rel = self.streams.get("Reliability")
        if rel is not None:
            from ..device import resolve_device
            rel.device = resolve_device("cpu" if backend == "cpu"
                                        else device)

    def prepare_dispatch(self, backend: str, solver_opts=None,
                         checkpoint_dir=None, device=None) -> None:
        """Sizing module + requirements + (CPU) sizing window; leaves the
        remaining windows pending for the batched driver.  ``device`` is
        the dispatch device (see :meth:`place_walks`)."""
        self.place_walks(backend, device)
        self.sizing_module()
        self._t0 = time.time()
        self._backend = backend
        self._solver_opts = solver_opts
        self._checkpoint_dir = checkpoint_dir
        self._n_solves = 0
        self._ckpt_backlog = 0
        self.quarantine = None
        self.health = _new_health()
        self.certification = certify.new_certification(
            certify.policy_from_env().enabled)
        self._shadow_labels = set()
        self._scattered = False
        self._solution: Dict[str, np.ndarray] = {}
        self._solved: set = set()
        deferral = self.streams.get("Deferral")
        if deferral is not None and deferral.deferral_df is None:
            deferral.deferral_analysis(self.ders, self.opt_years, self.end_year)
        self._requirements = self.service_agg.identify_system_requirements(
            self.ders, self.opt_years, self.index)
        self._annuity_scalar = 1.0
        self._pending: List[WindowContext] = []
        self._deg_pos = 0
        self._degrading = [d for d in self.ders
                           if getattr(d, "incl_cycle_degrade", False)]
        if self.poi.is_sizing_optimization:
            self.check_opt_sizing_conditions()
            self._annuity_scalar = self.cba.annuity_scalar(self.opt_years)
            self.solve_metadata["annuity_scalar"] = self._annuity_scalar
        if not self.opt_engine:
            return
        if checkpoint_dir:
            self._solved = self._load_checkpoint(checkpoint_dir, self._solution)
        windows = self.windows
        if self.poi.is_sizing_optimization:
            # solve the first window with size variables, freeze the sizes,
            # then batch the remaining windows at fixed size (reference:
            # der.set_size() after window 1, MicrogridScenario.py:361-363).
            # The sizing LP runs on the exact CPU simplex regardless of
            # backend: it is ONE hard, badly-scaled LP solved once per run
            # (size vars ~1e4 against $/kWh costs ~1e-2 stall f32 PDHG),
            # while the GPU's advantage is the batched operational axis —
            # the division of labor SURVEY §2.9 prescribes.
            if backend != "cpu":
                TellUser.info("sizing window routed to the CPU exact solver; "
                              "operational windows stay on the batched "
                              f"{backend} backend")
            ctx0 = windows[0]
            pairs = [(ctx0, self.build_window_lp(ctx0, self._annuity_scalar,
                                                 self._requirements))]
            items0 = guard_items([(self, ctx0, pairs[0][1])])
            if not items0:
                return          # sizing inputs rejected: case quarantined
            health_snap = dict(self.health)
            # the sizing pre-solve is provisional (the window re-solves at
            # frozen integer ratings below): roll its certificate counts
            # back with the health buckets so it is certified exactly once
            cert_snap = {k: self.certification[k]
                         for k in certify.CERT_COUNT_KEYS}
            cert_win_snap = dict(self.certification["windows"])
            xs, objs, ok, diags = resolve_group(items0, "cpu", solver_opts)
            self.apply_subgroup(pairs, xs, objs, ok, diags, "cpu",
                                freeze_sizes=True)
            if self.quarantine is not None:
                return          # sizing window exhausted the ladder
            # integer-sizing polish (VERDICT r3 #6): set_size snapped the
            # ratings onto the reference's integer grid, so the sizing
            # window's CONTINUOUS-size dispatch is stale — mark it
            # unsolved and let the batched driver re-solve it once at the
            # frozen integer ratings (degradation replay for it then runs
            # through the normal phase-2 path against the final dispatch).
            # The pre-solve was provisional: roll its bucket back so the
            # re-solve's outcome is the window's ONE health entry (ladder
            # wall time genuinely spent is kept)
            health_snap["retry_seconds"] = self.health["retry_seconds"]
            self.health = health_snap
            for k in certify.CERT_COUNT_KEYS:
                self.certification[k] = cert_snap[k]   # cert_s kept
            self.certification["windows"] = cert_win_snap
            self._solved.discard(ctx0.label)
            # capacity-dependent requirements (Reliability min-SOE, RA
            # qualifying capacity) were computed against zero ratings;
            # recompute them now that sizes are frozen so the remaining
            # windows are constrained correctly
            self._requirements = self.service_agg.identify_system_requirements(
                self.ders, self.opt_years, self.index)
        self._pending = list(windows)

    def prepare_resume(self, backend: str, solver_opts=None,
                       checkpoint_dir=None, device=None) -> bool:
        """Manifest fast path: when a prior run recorded this case as
        fully ``done``, reload its persisted per-window results and skip
        the dispatch machinery entirely — no LP assembly, no grouping, no
        device calls (the per-window checkpoint path merely skipped
        *windows inside* the case).  Returns False — leaving the case for
        the normal ``prepare_dispatch`` — whenever the skip cannot be
        proven sound: sizing cases (frozen sizes are recovered by
        re-solving the sizing window), degradation-coupled cases (SOH
        replay needs the windows stepped in order), or a checkpoint that
        is missing/mismatched/incomplete."""
        if self.poi.is_sizing_optimization:
            return False
        if any(getattr(d, "incl_cycle_degrade", False) for d in self.ders):
            return False
        solution: Dict[str, np.ndarray] = {}
        solved = self._load_checkpoint(checkpoint_dir, solution)
        if {ctx.label for ctx in self.windows} - set(solved):
            return False          # incomplete: fall back to dispatch
        self.place_walks(backend, device)
        self.sizing_module()
        # deferral analysis feeds the deferral_results drill-down, not the
        # dispatch LPs — a resumed case must still produce it or its
        # output set would differ from an uninterrupted run's
        deferral = self.streams.get("Deferral")
        if deferral is not None and deferral.deferral_df is None:
            deferral.deferral_analysis(self.ders, self.opt_years,
                                       self.end_year)
        self._t0 = time.time()
        self._backend = backend
        self._solver_opts = solver_opts
        self._checkpoint_dir = checkpoint_dir
        self._n_solves = 0
        self._ckpt_backlog = 0
        self.quarantine = None
        self.health = _new_health()
        self.certification = certify.new_certification(
            certify.policy_from_env().enabled)
        self._shadow_labels = set()
        self._scattered = False
        self._solution = solution
        self._solved = solved
        self._requirements = []
        self._annuity_scalar = 1.0
        self._pending = []
        self._deg_pos = 0
        self._degrading = []
        self._resumed_done = True
        self.solve_metadata["resumed_from_manifest"] = True
        TellUser.info(
            f"case {self.case.case_id}: manifest says done — "
            f"{len(solved)} window result(s) reloaded, case not "
            "re-dispatched")
        return True

    # id(K) -> (weakref to K, K-bytes digest): template siblings share one
    # K object, so each distinct matrix hashes once per dispatch
    _skey_memo: Dict[int, tuple] = {}

    @staticmethod
    def _structure_key(lp: LP):
        """Windows whose constraint matrix is byte-identical (and split
        eq/ineq the same way) may share a compiled solver — data-dependent
        structure (e.g. EV plug sessions) falls into its own group
        automatically.  Cases differing only in prices/bounds/rhs produce
        equal keys, so sensitivity cases batch together across the case
        axis for free.  The key is a cryptographic digest of the ASSEMBLED
        K's bytes, NOT Python's salted 64-bit hash (a collision would
        co-batch mismatched LPs, ADVICE r3) and NOT the builder's
        structure digest: builder coefficient streams differ between
        months whose assembled K is byte-identical (monthly tariff masks),
        and keying on the builder digest split Usecase2's 3 window groups
        into 12 singles — a ~10x dispatch regression on the CPU test
        platform (caught r5).  The id-memo (weakref-guarded against id
        reuse) keeps the cost at one ~60 KB hash per DISTINCT matrix."""
        import hashlib
        import weakref

        memo = MicrogridScenario._skey_memo
        entry = memo.get(id(lp.K))
        dig = None
        if entry is not None and entry[0]() is lp.K:
            dig = entry[1]
        if dig is None:
            h = hashlib.sha256()
            h.update(lp.K.indptr.tobytes())
            h.update(lp.K.indices.tobytes())
            h.update(lp.K.data.tobytes())
            dig = h.digest()
            if len(memo) > 4096:     # drop stale id->dead-weakref entries
                memo.clear()
            memo[id(lp.K)] = (weakref.ref(lp.K), dig)
        return (lp.K.shape, lp.n_eq, dig)

    def _cheap_group_key(self, ctx) -> tuple:
        """Pre-grouping fingerprint that needs NO LP assembly: window
        length + the structural configuration that determines which
        constraint rows a window gets.  Windows sharing this key USUALLY
        share a byte-identical K (sensitivity sweeps vary bounds/prices,
        not structure); the dispatch driver VERIFIES with the exact
        `_structure_key` once the group's LPs are built and splits on
        mismatch (e.g. DR event windows, an rte sweep, EV plug sessions)
        — so this is purely an assembly-cost optimization, never a
        correctness assumption.  Profiled r4: fingerprint-building every
        window LP twice was ~40% of a 128-case sweep's wall clock."""
        return (ctx.T, self.dt, self.incl_binary,
                tuple(sorted((d.tag, d.id) for d in self.ders)),
                tuple(sorted(self.streams)),
                tuple(sorted((r.kind, r.sense, r.source)
                             for r in (self._requirements or []))))

    def pending_window_groups(self):
        """Yield ``(cheap_key, ctx)`` for every unsolved
        non-degradation-coupled window.  No LP is built here — the driver
        builds each group's LPs once, at solve time, verifying exact
        structure then."""
        if not self.opt_engine or self._degrading or self.quarantine:
            return
        for ctx in self._pending:
            if ctx.label in self._solved:
                continue
            yield (self._cheap_group_key(ctx), ctx)

    # -- degradation stepping: windows are time-sequential WITHIN a case
    # (SOH feeds the next window's energy bounds, reference
    # Battery.py:87-110) but window t of N cases can solve as one batch --
    def next_degradation_item(self):
        """Advance through solved windows (replaying degradation), then
        return ``(structure_key, ctx, lp)`` for the first window that still
        needs a solve — or None when the case is done."""
        if not self.opt_engine or not self._degrading or self.quarantine:
            return None
        while self._deg_pos < len(self._pending):
            ctx = self._pending[self._deg_pos]
            if ctx.label not in self._solved:
                lp = self.build_window_lp(ctx, self._annuity_scalar,
                                          self._requirements)
                return (self._structure_key(lp), ctx, lp)
            self._replay_degradation(ctx)
            self._deg_pos += 1
        return None

    def _replay_degradation(self, ctx) -> None:
        pos = np.searchsorted(self.index, ctx.index[0])
        for d in self._degrading:
            arr = self._solution.get(f"{d.tag}-{d.id or '1'}/ene")
            if arr is not None:
                d.calc_degradation(ctx.index, arr[pos:pos + ctx.T])

    def finish_dispatch(self) -> None:
        if self.opt_engine:
            # a manifest-resumed case solved nothing: rewriting an
            # identical checkpoint would be wasted IO
            if self._checkpoint_dir and self._solved and \
                    not getattr(self, "_resumed_done", False):
                self._save_checkpoint(self._checkpoint_dir, self._solution,
                                      self._solved)
            if self.quarantine is None and \
                    not getattr(self, "_scattered", False):
                # the on_case_solved fast path may have scattered already
                # (api overlaps per-case post with the remaining solves)
                self._scatter_to_ders(self._solution)
            # windows never dispatched because the case quarantined first
            # land in 'skipped', so a quarantined case's buckets still sum
            # to n_windows and the report's denominators reconcile against
            # sweep size.  (Clean cases need no plug: every window they
            # dispatch this run is bucketed at solve time; windows
            # restored from a checkpoint are not re-dispatched and are
            # deliberately not counted.)
            if self.quarantine is not None:
                from ..io.summary import HEALTH_KEYS
                counted = sum(self.health[k] for k in HEALTH_KEYS
                              if k != "skipped")
                self.health["skipped"] = max(0,
                                             len(self.windows) - counted)
        self.solve_metadata.update({
            "backend": self._backend,
            # wall-clock of the WHOLE batched dispatch this case rode in —
            # co-batched cases share device calls, so a per-case split of
            # solve time is not well-defined
            "solve_seconds": time.time() - self._t0,
            "batched_solves": self._n_solves,
            "n_windows": len(self.windows),
            "health": dict(self.health),
            "certification": dict(self.certification),
            "quarantined": self.quarantine,
        })

    # ------------------------------------------------------------------
    def _flush_checkpoint(self) -> None:
        """Write any batched-up checkpoint state NOW — called before a
        case leaves the dispatch loop (quarantine), so up to 8
        already-solved degradation windows are not re-solved on resume."""
        if self._checkpoint_dir and self._ckpt_backlog and self._solved:
            self._save_checkpoint(self._checkpoint_dir, self._solution,
                                  self._solved)
            self._ckpt_backlog = 0

    def quarantine_case(self, reason: str, label=None) -> None:
        """Case-level failure isolation: mark this case failed with its
        diagnosis and drop it from the remaining dispatch — the sweep's
        other cases keep solving.  ``run_dispatch`` raises an aggregated
        ``SolverError`` at the end only if EVERY case is quarantined."""
        if self.quarantine is not None:
            return
        self._flush_checkpoint()
        self.quarantine = {"case_id": self.case.case_id, "reason": reason,
                           "window": label}
        TellUser.error(f"case {self.case.case_id} quarantined"
                       + (f" (window {label})" if label is not None else "")
                       + f": {reason}")

    def apply_subgroup(self, pairs, xs, objs, ok, diags, backend,
                       freeze_sizes: bool = False) -> None:
        """Post-solve half of a window-group solve: binary MILP rescue,
        objective bookkeeping, solution scatter, size freezing.  A member
        still unconverged HERE has exhausted the escalation ladder
        upstream (``resolve_group``): the case is quarantined — after the
        converged members are recorded and the checkpoint flushed — so
        the sweep's other cases continue instead of losing their work.
        Runs even for an already-quarantined case: with pipelining a
        group may still be in flight when a later group quarantines the
        case, and its converged members must be recorded and
        checkpointed, not thrown away."""
        ctxs = [p[0] for p in pairs]
        lps = [p[1] for p in pairs]
        solver_opts = self._solver_opts
        solution = self._solution
        self._n_solves += 1
        # binary on/off cases: the batched backend solves the RELAXATION;
        # only windows whose relaxed solution is not binary-repairable
        # (simultaneous ch/dis, sub-min-power running) re-solve on the
        # exact CPU MILP — typical windows never leave the device
        if backend != "cpu":
            # check tolerance follows the relaxation's own accuracy so
            # loosened PDHG settings don't read first-order noise as
            # cheating and forfeit the batched path
            bin_tol = max(getattr(solver_opts, "eps_rel", 0.0) or 0.0, 1e-4)
            policy = certify.policy_from_env()
            for i, lp in enumerate(lps):
                if lp.integrality is None:
                    continue
                # binary windows were NOT bucketed (or certified) in
                # resolve_group — the outcome of the binary check / MILP
                # rescue below is the window's final health bucket
                # (failures join `failed` and count as quarantined), and
                # the FINAL solution is what gets the float64 certificate
                relax_rejected = False
                if ok[i] and cpu_ref.binary_feasible(lp, xs[i], tol=bin_tol):
                    cert = (_certify_and_record(self, ctxs[i].label, lp,
                                                xs[i], objs[i], policy)
                            if policy.enabled else None)
                    if cert is None or cert.accepted:
                        with _health_lock:
                            self.health["clean"] += 1
                        continue
                    relax_rejected = True
                # relaxation cheated (fractional on/off), failed to
                # converge, or its solution was rejected by the float64
                # certifier: either way the exact MILP rescues it
                TellUser.info(
                    f"window {ctxs[i].label}: "
                    + ("certifier rejected the relaxation solution"
                       if relax_rejected else
                       "relaxation exploits fractional on/off"
                       if ok[i] else "relaxation did not converge")
                    + "; re-solving as exact MILP")
                was_unconverged = not ok[i]
                res = cpu_ref.solve_lp_cpu(lp)
                xs[i], objs[i] = res.x, res.obj
                ok[i] = res.status == 0
                diags[i] = res.message or diags[i]
                if ok[i] and policy.enabled:
                    cert = _certify_and_record(self, ctxs[i].label, lp,
                                               xs[i], objs[i], policy,
                                               was_rejected=relax_rejected)
                    if not cert.accepted:
                        ok[i] = False
                        diags[i] = (f"{certify.REJECT_DIAG_PREFIX} exact "
                                    f"MILP solution rejected: {cert.reason}")
                        with _health_lock:
                            self.certification["rejected_final"] += 1
                elif not ok[i] and relax_rejected:
                    # the cert-rejected relaxation's MILP rescue failed
                    # outright: the window's LAST certificate verdict was
                    # the rejection, so the partition invariant
                    # (rejections = recovered + final) must count it here
                    with _health_lock:
                        self.certification["rejected_final"] += 1
                if ok[i]:
                    # an unconverged relaxation rescued by the exact MILP
                    # is a CPU-fallback recovery in health terms; a
                    # fractional-on/off repair is normal binary operation
                    with _health_lock:
                        self.health["cpu_fallback" if was_unconverged
                                    else "clean"] += 1
        failed = []
        for ctx, lp, x, obj, converged, diag in zip(ctxs, lps, xs, objs, ok,
                                                    diags):
            if not converged:
                failed.append((ctx, diag))
                continue
            breakdown = lp.objective_breakdown(x)
            # the tiebreak tilt is a solver-only vertex selector, not a
            # revenue: report it as its own explicit column and subtract
            # it from the total, so the labeled per-stream components sum
            # EXACTLY to the reported total (the invariant audit asserts
            # this to 1e-9; closes the ADVICE r5 component-sum finding).
            # The total is the float64 recompute of c@x, NOT the solver's
            # f32-accumulated objective — the components are float64 and
            # an f32 total would leave a ~1e-8 phantom residual.
            obj64 = float(np.asarray(lp.c, np.float64)
                          @ np.asarray(x, np.float64))
            breakdown["Total Objective"] = obj64 + lp.c0 \
                - breakdown.get(TILT_LABEL, 0.0)
            self.objective_values[ctx.label] = breakdown
            pos = np.searchsorted(self.index, ctx.index[0])
            for name, ref in lp.var_refs.items():
                short = name.split("/", 1)[-1]
                if short.startswith("size"):
                    continue      # scalar size vars are frozen, not dispatch
                if name not in solution:
                    solution[name] = np.zeros(len(self.index))
                solution[name][pos:pos + ctx.T] = x[ref.sl]
            if freeze_sizes:
                for der in self.ders:
                    prefix = f"{der.tag}-{der.id or '1'}/"
                    sizes = {name[len(prefix):]: float(x[ref.sl][0])
                             for name, ref in lp.var_refs.items()
                             if name.startswith(prefix)
                             and name[len(prefix):].startswith("size")}
                    if sizes:
                        der.set_size(sizes)
            self._solved.add(ctx.label)
        if self._checkpoint_dir:
            # group solves checkpoint after every apply; the window-at-a-
            # time degradation path batches writes in strides of 8 —
            # full-horizon npz writes are not free (finish_dispatch writes
            # the final state either way).  A failure flushes the backlog
            # unconditionally: the quarantine below drops this case from
            # the dispatch, and an unflushed stride would re-solve up to 8
            # already-solved windows on resume.
            self._ckpt_backlog += len(ctxs) - len(failed)
            if not self._degrading or self._ckpt_backlog >= 8 or failed:
                self._save_checkpoint(self._checkpoint_dir, self._solution,
                                      self._solved)
                self._ckpt_backlog = 0
        if failed:
            with _health_lock:
                self.health["quarantined"] += len(failed)
            ctx_f, diag_f = failed[0]
            self.quarantine_case(
                f"window {ctx_f.label} ({ctx_f.index[0]}..{ctx_f.index[-1]}) "
                f"did not solve: {diag_f}", label=ctx_f.label)

    def check_opt_sizing_conditions(self) -> None:
        """Sizing feasibility guards (reference MicrogridScenario.py:208-247):
        year-long windows required, no binary + power sizing, no post-facto-
        only reliability sizing, wholesale power sizing needs participation
        limits."""
        error = False
        if str(self.n).strip().lower() != "year":
            TellUser.error("sizing requires the optimization window n='year'")
            error = True
        if self.incl_binary:
            TellUser.error("sizing with the binary formulation is nonlinear "
                           "(reference forbids it, MicrogridPOI.py:132-147)")
            error = True
        if self.service_agg.post_facto_reliability_only():
            TellUser.error("trying to size for reliability with post-facto-"
                           "only calculations; turn off post_facto_only or "
                           "stop sizing")
            error = True
        if self.service_agg.is_whole_sale_market():
            power_sized = any(
                getattr(d, "sizing_ch", False) or getattr(d, "sizing_dis", False)
                or (d.technology_type == "Generator" and d.being_sized())
                for d in self.ders)
            ts = self.case.datasets.time_series
            from .window import grab_column
            has_limits = any(
                grab_column(ts, col) is not None
                for col in ("FR Reg Up Max (kW)", "SR Max (kW)",
                            "NSR Max (kW)", "LF Reg Up Max (kW)"))
            if power_sized and not has_limits:
                TellUser.error("sizing power against unbounded wholesale "
                               "market participation is unbounded; add "
                               "market max participation constraints")
                error = True
        if error:
            raise ParameterError(
                "sizing pre-checks failed; see log for details")

    def _scatter_to_ders(self, solution: Dict[str, np.ndarray]) -> None:
        for der in self.ders:
            prefix = f"{der.tag}-{der.id or '1'}/"
            values = {name[len(prefix):]: arr
                      for name, arr in solution.items()
                      if name.startswith(prefix)}
            if values:
                der.store_dispatch(self.index, values)
        for vs in self.streams.values():
            store = getattr(vs, "store_dispatch", None)
            if store is not None:
                store(self.index, solution)

    # ------------------------------------------------------------------
    def evaluation_clones(self):
        """DER/stream copies re-priced with the case's Evaluation values
        (reference: CBA deep-copies instances and places evaluation data,
        CBA.py:235-275).  Dispatch results and frozen sizes carry over; only
        the financial inputs change."""
        over = self.case.cba_overrides
        if not over:
            return self.ders, self.streams, self.case.finance
        tech_map = _build_tech_map()
        vs_map = _build_vs_map()
        ders = []
        for der in self.ders:
            keys = dict(der.keys)
            touched = False
            for (t, i, k), v in over.items():
                if t == der.tag and (i or "") == (der.id or ""):
                    keys[k] = v
                    touched = True
            if not touched:
                ders.append(der)
                continue
            clone = tech_map[der.tag](keys, self.scenario, der.id,
                                      self.case.datasets)
            clone.variables_df = der.variables_df
            for attr in ("ene_max_rated", "ch_max_rated", "dis_max_rated",
                         "rated_power", "rated_capacity", "soh"):
                if hasattr(der, attr) and hasattr(clone, attr):
                    setattr(clone, attr, getattr(der, attr))
            for flag in ("sizing_ene", "sizing_ch", "sizing_dis"):
                if hasattr(clone, flag):
                    setattr(clone, flag, False)
            ders.append(clone)
        streams = {}
        for tag, vs in self.streams.items():
            keys = dict(vs.keys)
            touched = False
            for (t, _, k), v in over.items():
                if t == tag:
                    keys[k] = v
                    touched = True
            if not touched:
                streams[tag] = vs
                continue
            clone = vs_map[tag](keys, self.scenario, self.case.datasets)
            if getattr(vs, "dispatch", None) is not None:
                clone.dispatch = vs.dispatch
            streams[tag] = clone
        finance = dict(self.case.finance)
        for (t, _, k), v in over.items():
            if t == "Finance":
                finance[k] = v
        # filename-type evaluation overrides re-price from DIFFERENT data
        # files; only the tariff reload is implemented — refuse the rest
        # loudly rather than silently reusing the optimization data
        filename_keys = [(t, k) for (t, _, k) in over if k.endswith("_filename")]
        for t, k in filename_keys:
            if (t, k) == ("Finance", "customer_tariff_filename"):
                import dataclasses as _dc
                from ..io.params import load_tariff, normalize_path
                datasets = _dc.replace(
                    self.case.datasets,
                    tariff=load_tariff(normalize_path(
                        finance["customer_tariff_filename"],
                        self.case.base_path)))
                for tag in ("retailTimeShift", "DCM"):
                    if tag in streams:
                        streams[tag] = _build_vs_map()[tag](
                            streams[tag].keys, self.scenario, datasets)
            else:
                raise ParameterError(
                    f"Evaluation override of {t}.{k} is not supported "
                    "(only customer_tariff_filename re-pricing)")
        return ders, streams, finance

    # ------------------------------------------------------------------
    def timeseries_results(self) -> pd.DataFrame:
        frames = [self.poi.merge_reports(self.index, self.time_series)]
        for der in self.ders:
            if der.variables_df is not None:
                frames.append(der.timeseries_report())
        frames.append(self.service_agg.timeseries_report(self.index))
        out = pd.concat(frames, axis=1)
        return out.reindex(sorted(out.columns), axis=1)


# ---------------------------------------------------------------------------
# Batched solve + multi-case dispatch driver
# ---------------------------------------------------------------------------

class SolverCache:
    """Per-dispatch cache of ``CompiledLPSolver`` keyed by LP structure.

    Preconditioning (Ruiz equilibration + the ||K|| power iteration)
    depends only on the constraint matrix — the structure key — never on
    the per-instance ``c/q/l/u``.  Phase-2 degradation stepping calls
    ``solve_group`` once per window step on identical structure, so the
    cache keeps a multi-year degradation case from re-preconditioning the
    same LP dozens of times.  Every solver of one cache lives on
    ``device`` (set by ``run_dispatch`` when left None; a name such as
    ``"cuda"`` is resolved here).

    Elastic dispatch (``parallel/elastic.py``) solves on per-device cache
    SHARDS (``shard_for``): each holds solvers whose constants live on its
    device, so the worker threads solve concurrently without sharing a
    solver.  The warm-start memory, the iteration-baseline hints and the
    key->device stickiness live on the ROOT cache, shared by every shard;
    a persistent service keeps its shards across rounds."""

    def __init__(self, pad_grid: bool = False, warm_start: bool = False,
                 memory=None, device=None):
        self.solvers: Dict[tuple, object] = {}
        self.builds = 0
        self.hits = 0
        if device is not None:
            from ..device import resolve_device
            device = resolve_device(device)
        self.device = device
        self.device_index: Optional[int] = None
        self._parent: Optional["SolverCache"] = None
        self._shards: Dict[int, "SolverCache"] = {}
        self._iters_ewma: Dict[tuple, float] = {}
        self._key_device: Dict[tuple, int] = {}
        # serving mode: pad each group's batch up to the compaction bucket
        # grid ({8, 32, 128, ...}); off for one-shot runs
        self.pad_grid = bool(pad_grid)
        # warm-start solution memory (ops/warmstart.py): long-lived callers
        # opt in; OFF by default for one-shot dispatches, which pin
        # byte-identity against the serial reference path
        if memory is not None:
            self.memory = memory
        elif warm_start:
            from ..ops import warmstart as _ws
            self.memory = _ws.SolutionMemory() if _ws.enabled() else None
        else:
            self.memory = None
        # get() is called from the dispatch pipeline's worker threads: the
        # lock makes check-then-insert atomic and the counters exact
        self._lock = threading.Lock()

    def get(self, key, lp0: LP, solver_opts):
        with self._lock:
            solver = self.solvers.get(key)
            if solver is None:
                from ..ops.pdhg import CompiledLPSolver, PDHGOptions
                opts = solver_opts or PDHGOptions()
                # escalation retries key as ("retry", base_key): clone the
                # base structure's solver (shared preconditioning, new
                # runtime budget) instead of re-preconditioning
                base = (self.solvers.get(key[1])
                        if isinstance(key, tuple) and len(key) == 2
                        and key[0] == "retry" else None)
                if base is not None:
                    solver = base.with_options(opts)
                else:
                    donor = self._donor(key)
                    if donor is not None:
                        # a sibling shard (or the root) already
                        # preconditioned this structure: copy its
                        # operator instead of re-running Ruiz + the
                        # power iteration
                        solver = donor.to_device(self.device)
                    else:
                        solver = CompiledLPSolver(lp0, opts,
                                                  device=self.device)
                self.solvers[key] = solver
                self.builds += 1
                self._mirror(key, built=True)
            else:
                self.hits += 1
                self._mirror(key, built=False)
        return solver

    # -- elastic per-device shards (parallel/elastic.py) ---------------
    def shard_for(self, device, index: int) -> "SolverCache":
        """The per-device cache shard for ``device`` at scheduler slot
        ``index`` (created on first use, persistent on this root cache so
        a service's shards survive across rounds).  Shards share the
        root's pad_grid policy and warm-start memory; their builds/hits
        mirror into the root counters so dispatch metadata stays a single
        surface."""
        root = self._parent or self
        with root._lock:
            shard = root._shards.get(index)
            if shard is None:
                shard = SolverCache(pad_grid=root.pad_grid,
                                    memory=root.memory, device=device)
                shard.device_index = index
                shard._parent = root
                root._shards[index] = shard
        return shard

    def _donor(self, key):
        """A solver for ``key`` on some OTHER shard (or the root) whose
        preconditioning a new shard can copy.  Called under the shard's
        lock; takes only the root's lock (shard -> root is the one
        ordering used anywhere, so no deadlock)."""
        root = self._parent
        if root is None:
            return None
        with root._lock:
            donor = root.solvers.get(key)
            if donor is not None:
                return donor
            for shard in root._shards.values():
                if shard is not self:
                    donor = shard.solvers.get(key)
                    if donor is not None:
                        return donor
        return None

    def _mirror(self, key, built: bool) -> None:
        """Mirror a shard's build/hit into the root counters and record
        key->device stickiness (placement affinity: a structure solves
        where its solver already lives)."""
        root = self._parent
        if root is None:
            if self.device_index is not None:
                self._key_device.setdefault(key, self.device_index)
            return
        with root._lock:
            if built:
                root.builds += 1
            else:
                root.hits += 1
            if self.device_index is not None:
                root._key_device.setdefault(key, self.device_index)

    def device_index_for(self, key) -> Optional[int]:
        """Sticky device slot for a structure key (None = unplaced)."""
        root = self._parent or self
        with root._lock:
            return root._key_device.get(key)

    def structures_cached(self) -> int:
        """Distinct structure keys with a solver anywhere — the root plus
        every per-device shard (the elastic path builds only in
        shards)."""
        root = self._parent or self
        with root._lock:
            keys = set(root.solvers)
            for shard in root._shards.values():
                keys.update(shard.solvers)
        return len(keys)

    def clear(self) -> None:
        """Drop every solver (root + shards); stickiness resets with them
        so placement re-balances from scratch."""
        root = self._parent or self
        with root._lock:
            root.solvers.clear()
            for shard in root._shards.values():
                shard.solvers.clear()
            root._key_device.clear()

    def note_iters(self, key, iters_p50: float) -> None:
        """Feed a group's measured iteration count into the rolling
        per-structure baseline the elastic placement costs groups by."""
        root = self._parent or self
        with root._lock:
            prev = root._iters_ewma.get(key)
            root._iters_ewma[key] = (float(iters_p50) if prev is None
                                     else 0.5 * prev + 0.5 * iters_p50)

    def iters_hint(self, key) -> Optional[float]:
        root = self._parent or self
        with root._lock:
            return root._iters_ewma.get(key)


def batch_bucket(n: int) -> int:
    """Service batch grid: the same 4x bucket steps the pdhg active-set
    compaction uses ({8, 32, 128, 512, ...}), so a serving layer that pads
    its coalesced groups UP to the next bucket runs a handful of batch
    shapes.  n <= 1 stays unpadded."""
    from ..ops.pdhg import compaction_bucket
    return n if n <= 1 else compaction_bucket(n)


def _batch_pad_to(cache, n: int, multi_dev: bool = False
                  ) -> Optional[int]:
    """The bucket width a group of ``n`` instances should pad to, or
    None when padding is off (no serving cache / ``pad_grid`` unset),
    inapplicable (n <= 1), or left to the sharded multi-device solve,
    which pads to a device multiple itself."""
    if cache is None or not getattr(cache, "pad_grid", False) or n <= 1 \
            or multi_dev:
        return None
    b = batch_bucket(n)
    return b if b > n else None


def _subset_pad_to(cache, n_mem: int, n_dev: int,
                   multi_dev: bool = False) -> Optional[int]:
    """Bucket width for a warm-start-substitution-shrunken device subset
    (``n_dev`` of ``n_mem`` members still need the device): the FULL
    group's bucket, so substitution never changes the batch shape.  The
    sharded multi-device solve keeps its own device-multiple padding."""
    if cache is not None and not multi_dev \
            and getattr(cache, "pad_grid", False):
        return batch_bucket(n_mem)
    return _batch_pad_to(cache, n_dev, multi_dev)


def _stack_group_data(lps: List[LP], sdt, pad_to: Optional[int] = None):
    """Stack per-instance ``c/q/l/u`` for a structure group, cast to the
    solver dtype in the same pass.  A vector IDENTICAL across the group
    (e.g. costs in a bounds-only sensitivity sweep) collapses to 1-D — the
    solver broadcasts it on the device, so a (512, n) block never crosses
    the bus.  ``pad_to`` (serving mode, see :func:`batch_bucket`) pads the
    batch axis to the bucket width by repeating the LAST instance's rows —
    inert duplicates whose results are trimmed after the solve."""
    def stack_cast(attr):
        rows = [getattr(lp, attr) for lp in lps]
        first = rows[0]
        if all(r is first or np.array_equal(r, first) for r in rows[1:]):
            return np.asarray(first, sdt)
        B = pad_to if pad_to else len(lps)
        out = np.empty((B, first.shape[0]), sdt)
        for i, r in enumerate(rows):
            out[i] = r
        if B > len(rows):
            out[len(rows):] = rows[-1]
        return out

    return tuple(stack_cast(a) for a in ("c", "q", "l", "u"))


class StagedGroupData:
    """A subgroup's stacked instance data with its host->device copy
    already ENQUEUED (pinned host memory, ``non_blocking``): staging group
    i+1 on the dispatch thread while group i's solve is in flight overlaps
    the upload with the running solve.  ``host`` keeps the pinned source
    buffers alive until the copies have run."""
    __slots__ = ("arrays", "host", "stack_s", "h2d_s", "h2d_bytes")

    def __init__(self, arrays, host, stack_s, h2d_s, h2d_bytes):
        self.arrays = arrays
        self.host = host
        self.stack_s = stack_s
        self.h2d_s = h2d_s
        self.h2d_bytes = h2d_bytes


def stage_group_data(items, solver_opts, device,
                     pad_to: Optional[int] = None
                     ) -> Optional[StagedGroupData]:
    """Stack + start uploading a verified subgroup's LP data to ``device``
    (see ``StagedGroupData``).  Single-window groups without padding ride
    the explicit solver.solve path, which takes the LP's own vectors —
    nothing to stage.  ``pad_to`` applies the serving layer's bucket
    padding at stage time so the upload matches the solved shape."""
    import torch
    from ..ops.pdhg import PDHGOptions
    if len(items) < 2 and not pad_to:
        return None
    lps = [lp for (_, _, lp) in items]
    sdt = np.dtype((solver_opts or PDHGOptions()).dtype)
    t0 = time.perf_counter()
    arrs = _stack_group_data(lps, sdt, pad_to=pad_to)
    t1 = time.perf_counter()
    host = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]
    if device.type == "cuda":
        host = [h.pin_memory() for h in host]
    dev = tuple(h.to(device, non_blocking=True) for h in host)
    t2 = time.perf_counter()
    return StagedGroupData(dev, host, t1 - t0, t2 - t1,
                           sum(a.nbytes for a in arrs))


def solve_group(lp0: LP, lps: List[LP], backend: str, solver_opts,
                key=None, cache: Optional[SolverCache] = None, labels=None,
                staged: Optional[StagedGroupData] = None, ledger=None,
                ledger_meta=None, y_sink: Optional[dict] = None,
                seeds=None, iterate_sink: Optional[dict] = None,
                device=None):
    """Solve a group of structure-identical LPs.  Backend 'cpu' = exact
    HiGHS per instance; 'torch' = ONE batched PDHG solve on ``device``
    (the cache's device when a cache is given).  With ``key``/``cache``
    set, the preconditioned solver is reused across calls that share a
    structure key.  ``labels`` (parallel
    to ``lps``) names each window in diagnostics.

    ``staged`` carries the group's instance data already stacked and
    uploaded (the dispatch pipeline stages group i+1 under group i's
    solve); ``ledger``/``ledger_meta`` collect the per-group solve-ledger
    entry (VERDICT r5 #1) — batch shape, wall-clock split, device-traffic
    stats, iteration percentiles.

    Warm starts (ops/warmstart.py): when the cache carries a
    ``SolutionMemory``, each member is looked up before the device solve
    — an exact data+tolerance hit whose stored solution passes the
    float64 host replica of the full convergence criteria is SHIPPED
    VERBATIM (zero device work, ``iters == 0``, byte-identical to its
    cold counterpart), a near hit seeds the solver's iterates through
    ``init_state(x0=, y0=)``, and converged members are stored back as
    seeds for future solves.  ``seeds=(X0, Y0)`` (unscaled, parallel to
    ``lps``) seeds explicitly and bypasses the memory — the escalation
    ladder's retry rung re-solves failed members from their own last
    iterate this way.  ``iterate_sink`` (a dict) receives the device
    result's dual handle + member->row map so the ladder can build those
    retry seeds without an extra fetch on the happy path.  The per-group
    ledger entry records seeded-vs-cold membership with the iteration
    split, so the warm-start win is measured, not asserted.

    Returns ``(xs, objs, ok, diags, statuses)`` — statuses are the
    ``ops.pdhg.STATUS_*`` codes (CPU results are mapped onto them), so the
    escalation ladder upstream can tell a certified infeasibility from an
    iteration-limit exit."""
    from ..ops.pdhg import (STATUS_CONVERGED, STATUS_INACCURATE,
                            STATUS_ITER_LIMIT, STATUS_PRIMAL_INFEASIBLE,
                            CompiledLPSolver, PDHGOptions,
                            diagnose_infeasibility, fetch_result_host,
                            status_message, to_host)
    t_wall = time.perf_counter()
    if backend == "cpu":
        xs, objs, ok, diags, statuses = [], [], [], [], []
        for lp in lps:
            res = cpu_ref.solve_lp_cpu(lp)
            xs.append(res.x)
            objs.append(res.obj)
            ok.append(res.status == 0)
            diags.append(getattr(res, "message", "") or "solver failure")
            # scipy linprog/milp statuses: 0 optimal, 2 infeasible; map
            # onto the PDHG codes the ladder dispatches on
            statuses.append(
                STATUS_CONVERGED if res.status == 0 else
                STATUS_PRIMAL_INFEASIBLE if res.status == 2 else
                STATUS_ITER_LIMIT)
        if ledger is not None:
            ledger.append({**(ledger_meta or {}),
                           "backend": "cpu", "m": lp0.m, "n": lp0.n,
                           "batch": len(lps),
                           "solve_s": round(time.perf_counter() - t_wall,
                                            4)})
        return xs, objs, ok, diags, statuses
    if cache is not None and key is not None:
        solver = cache.get(key, lp0, solver_opts)
    else:
        solver = CompiledLPSolver(lp0, solver_opts or PDHGOptions(),
                                  device=device)
    import torch
    from ..ops import warmstart
    from ..ops.pdhg import DRIVER_FIELDS, SolveStats
    from ..parallel import elastic as _elastic
    # caller-owned stats: the pipeline can route two same-structure
    # subgroups to ONE cached solver from different workers, and a shared
    # solver.last_stats read-back would cross-wire their ledger entries
    stats = SolveStats()
    # a pinned ``device`` (elastic dispatch) keeps the group on ONE
    # solver; with none pinned and several visible devices, a batch is
    # split over all of them (parallel/mesh.py)
    shard_devs = (_elastic.visible_devices(solver.device)
                  if device is None else [])
    multi_dev = len(shard_devs) > 1
    n_mem = len(lps)

    # ---- warm-start plan: exact-hit substitution + iterate seeds ----
    # Binary windows are excluded (the memory would store the provisional
    # relaxation, not the post-MILP x that actually ships); an explicit
    # ``seeds`` (the retry rung) bypasses the memory entirely.
    memory = getattr(cache, "memory", None) if cache is not None else None
    plan_w = None
    if (seeds is None and memory is not None and key is not None
            and lp0.integrality is None and warmstart.enabled()):
        plan_w = warmstart.plan_group(
            memory, key, lps, solver.opts,
            labels if labels is not None else list(range(n_mem)))
    substituted = ([mp.substituted for mp in plan_w] if plan_w is not None
                   else [False] * n_mem)
    dev_idx = [i for i in range(n_mem) if not substituted[i]]
    lps_dev = [lps[i] for i in dev_idx]
    # serving mode (cache.pad_grid): pad the batch axis up to the pdhg
    # compaction-bucket grid so a hot service's varying coalesced batch
    # widths reuse a handful of batch shapes; padded rows repeat the
    # last instance and are trimmed below
    if len(lps_dev) != n_mem:
        # subset batch: the staged upload covered the FULL group's
        # shape, and the subset pads back to that shape's bucket so
        # substitution never mints a new program (see _subset_pad_to)
        staged = None
        pad_to = _subset_pad_to(cache, n_mem, len(lps_dev), multi_dev)
    else:
        pad_to = _batch_pad_to(cache, n_mem, multi_dev)

    # iterate seeds for the device members: explicit retry seeds, or the
    # plan's near/failed-exact entries.  Zero rows reproduce the cold
    # start member-for-member (clip(0 / dc) == clip(0)), so a partially
    # seeded batch leaves its cold members' trajectories untouched; a
    # memory-active group always seeds (zero seeds when nothing matched).
    X0 = Y0 = None
    if seeds is not None:
        X0, Y0 = (np.asarray(a) for a in seeds)
    elif plan_w is not None and lps_dev:
        sdt = np.dtype(solver.opts.dtype)
        X0 = np.zeros((len(lps_dev), lp0.n), sdt)
        Y0 = np.zeros((len(lps_dev), lp0.m), sdt)
        for row, i in enumerate(dev_idx):
            mp = plan_w[i]
            if mp.entry is not None and not mp.substituted:
                X0[row] = mp.entry.x
                Y0[row] = mp.entry.y
    if X0 is not None and np.ndim(X0) == 2 and pad_to \
            and np.shape(X0)[0] < pad_to:
        # match the data padding: repeat the last member's seed rows
        reps = pad_to - X0.shape[0]
        X0 = np.concatenate([X0, np.repeat(X0[-1:], reps, axis=0)])
        Y0 = np.concatenate([Y0, np.repeat(Y0[-1:], reps, axis=0)])

    # the dual block leaves the device only when the certification
    # policy's dual side (y_sink) or the warm-start memory (which stores
    # converged (x, y) pairs) needs it — and then it rides the one fused
    # result fetch, preserving the single-round-trip discipline
    want_y = (y_sink is not None) or (plan_w is not None)

    t_stack = 0.0
    res = None
    dev_x = dev_obj = dev_conv = dev_it = dev_pr = dev_gap = dev_st = None
    dev_y = None
    if lps_dev:
        if len(lps_dev) == 1 and pad_to is None:
            # pass the instance data explicitly: a cached solver's
            # built-in defaults belong to the FIRST window of its group
            lp = lps_dev[0]
            sx = sy = None
            if X0 is not None:
                sx = X0[0] if np.ndim(X0) == 2 else X0
                sy = Y0[0] if np.ndim(Y0) == 2 else Y0
            res = solver.solve(c=lp.c, q=lp.q, l=lp.l, u=lp.u, stats=stats,
                               x0=sx, y0=sy)
        else:
            if staged is not None:
                C, Q, L, U = staged.arrays
            else:
                sdt = np.dtype(solver.opts.dtype)
                t0 = time.perf_counter()
                C, Q, L, U = _stack_group_data(lps_dev, sdt, pad_to=pad_to)
                t_stack = time.perf_counter() - t0
            if all(np.ndim(a) == 1 for a in (C, Q, L, U)):
                # fully-degenerate group (nothing varies): keep one axis
                # batched so solve() returns per-instance results —
                # broadcast ON DEVICE so the transfer stays the 1-D vector
                Q = torch.as_tensor(np.asarray(Q), device=solver.device
                                    ).expand(pad_to or len(lps_dev),
                                             Q.shape[0])
            if multi_dev:
                from ..parallel.mesh import solve_batch_sharded
                res, _ = solve_batch_sharded(solver, shard_devs, c=C, q=Q,
                                             l=L, u=U, stats=stats,
                                             x0=X0, y0=Y0)
            else:
                res = solver.solve(c=C, q=Q, l=L, u=U, stats=stats,
                                   x0=X0, y0=Y0)
        # one device->host fetch of every consumed result field (x, obj,
        # converged, iters, residuals, status — plus y only when the
        # warm-start memory or the dual certificate wants it)
        fetched = fetch_result_host(res, stats, want_y=want_y)
        x_h, obj_h, conv_h, iters_h, pr_h, gap_h, st_h, rst_h = fetched[:8]
        y_h = fetched[8] if want_y else None
        k = len(lps_dev)
        if np.ndim(x_h) == 1:
            dev_x = [np.asarray(x_h)]
            dev_obj = [float(obj_h)]
            dev_conv = [bool(conv_h)]
            dev_it = [int(iters_h)]
            dev_pr = [float(pr_h)]
            dev_gap = [float(gap_h)]
            dev_st = [int(st_h)]
            dev_rst = [int(rst_h)]
            dev_y = [np.asarray(y_h)] if y_h is not None else None
        else:
            # [:k] trims the serving layer's bucket-padding rows (a
            # no-op slice when unpadded)
            dev_x = list(np.asarray(x_h)[:k])
            dev_obj = [float(o) for o in np.asarray(obj_h)[:k]]
            dev_conv = [bool(v) for v in np.asarray(conv_h)[:k]]
            dev_it = [int(v) for v in np.atleast_1d(
                np.asarray(iters_h))[:k]]
            dev_pr = [float(v) for v in np.atleast_1d(
                np.asarray(pr_h))[:k]]
            dev_gap = [float(v) for v in np.atleast_1d(
                np.asarray(gap_h))[:k]]
            dev_st = [int(s) for s in np.asarray(st_h)[:k]]
            dev_rst = [int(v) for v in np.atleast_1d(
                np.asarray(rst_h))[:k]]
            dev_y = (list(np.asarray(y_h)[:k]) if y_h is not None
                     else None)
    if iterate_sink is not None:
        # the escalation ladder builds retry seeds from the failed
        # members' LAST iterates: x is already on the host (below); the
        # dual stays a device handle + member->row map, fetched only for
        # the (rare) members that actually climb the ladder
        iterate_sink["y_dev"] = res.y if res is not None else None
        iterate_sink["rows"] = {i: row for row, i in enumerate(dev_idx)}

    # ---- merge device rows and substituted members, member order ----
    xs: list = [None] * n_mem
    objs = [float("nan")] * n_mem
    ok = [False] * n_mem
    statuses = [STATUS_ITER_LIMIT] * n_mem
    iters_m = np.zeros(n_mem, np.int64)
    pr_m = np.zeros(n_mem)
    gap_m = np.zeros(n_mem)
    rst_m = np.zeros(n_mem, np.int64)
    for row, i in enumerate(dev_idx):
        xs[i] = dev_x[row]
        objs[i] = dev_obj[row]
        ok[i] = dev_conv[row]
        statuses[i] = dev_st[row]
        iters_m[i] = dev_it[row]
        pr_m[i] = dev_pr[row]
        gap_m[i] = dev_gap[row]
        rst_m[i] = dev_rst[row]
    for i in range(n_mem):
        if substituted[i]:
            mp = plan_w[i]
            e = mp.entry
            # ship the stored solution verbatim (copies: downstream may
            # mutate) — it re-passed the full convergence criteria in
            # float64 during planning (or the INACCURATE band the cold
            # path already accepts, warning re-issued below), and it
            # will be re-certified like any other accepted solution
            xs[i] = e.x.copy()
            objs[i] = e.obj
            ok[i] = True
            statuses[i] = (STATUS_INACCURATE if mp.inaccurate
                           else STATUS_CONVERGED)
            pr_m[i] = mp.prim
            gap_m[i] = mp.gap
    if y_sink is not None:
        # requested when the certification policy wants the dual side
        # (DERVET_TPU_CERT_DUAL=1); substituted members contribute their
        # stored duals
        ys_all = np.zeros((n_mem, lp0.m))
        for row, i in enumerate(dev_idx):
            if dev_y is not None:
                ys_all[i] = dev_y[row]
        for i in range(n_mem):
            if substituted[i]:
                ys_all[i] = plan_w[i].entry.y
        y_sink["y"] = ys_all

    # ---- feed the memory: accepted device members become seeds ----
    # INACCURATE-accepted exits are stored too (a screening tier's hard
    # budget exits that way by design, and the next tier seeds from
    # exactly those iterates); substitution is still gated by the f64
    # convergence re-check, so a loose entry can only ever SEED.
    if plan_w is not None and dev_y is not None:
        tag = warmstart.opts_tag(solver.opts)
        cold_iters = []
        for row, i in enumerate(dev_idx):
            if dev_st[row] in (STATUS_CONVERGED, STATUS_INACCURATE) \
                    and np.isfinite(dev_obj[row]):
                memory.store(key, lps[i], tag, dev_x[row], dev_y[row],
                             dev_obj[row],
                             exact=plan_w[i].exact_digest,
                             quant=plan_w[i].quant_digest)
                if plan_w[i].hint is not None:
                    # dual-iterate hint table (portfolio outer loop):
                    # index this converged iterate under the member's
                    # (tag, site, window) key so the NEXT dual
                    # iteration — price-shifted data, same member —
                    # reseeds from it instead of falling cold
                    memory.store_hint(plan_w[i].hint, dev_x[row],
                                      dev_y[row], dev_obj[row])
            if plan_w[i].kind == "cold" and \
                    dev_st[row] in (STATUS_CONVERGED, STATUS_INACCURATE):
                # accepted exits only: an iteration-limit exit would
                # feed its full budget into the baseline and inflate
                # the ledger's iters_saved
                cold_iters.append(dev_it[row])
        if cold_iters:
            memory.note_cold_iters(key, cold_iters)
    if plan_w is not None:
        # outside the device-members gate on purpose: a fully
        # substituted group makes NO device call (dev_y is None), but
        # its hint entries must still refresh to the shipped solutions
        # — the next dual iteration's price move has to find them
        for i in range(n_mem):
            if plan_w[i].hint is not None and plan_w[i].substituted:
                e = plan_w[i].entry
                memory.store_hint(plan_w[i].hint, e.x, e.y, e.obj)
    # rolling per-structure iteration baseline
    if cache is not None and key is not None and n_mem and \
            (ledger_meta or {}).get("rung", "initial") in (None, "initial"):
        cache.note_iters(key, float(np.percentile(iters_m, 50)))
    if ledger is not None:
        it = iters_m
        from ..ops.pdhg import kernel_selection, resolved_variant
        kern, kern_why, kern_detail = kernel_selection(solver)
        entry = {**(ledger_meta or {}),
                 "backend": backend, "m": lp0.m, "n": lp0.n,
                 "batch": len(lps),
                 # solver-core observables (ROADMAP item 1): the step
                 # variant this group's jits BAKED IN at build time (a
                 # live env flip only reaches rebuilt solvers), its
                 # adaptive-restart count (== Halpern anchor resets
                 # under 'halpern'), and the realized check cadence
                 "variant": (getattr(solver, "variant", None)
                             or resolved_variant(solver.opts)),
                 # restart criterion the group's programs baked in
                 # ('kkt' | 'fixed_point' — the Halpern-native scheme)
                 "restart_scheme": getattr(solver, "restart_scheme", ""),
                 "restarts": int(rst_m.sum()),
                 "restarts_p50": int(np.percentile(rst_m, 50)),
                 "cadence_final": int(stats.cadence_final),
                 # chosen chunk kernel + fallback reason (a machine-stable
                 # enum, pdhg.KERNEL_FALLBACK_REASONS; free-form context
                 # rides separately as the detail) and this group's
                 # chunk-kernel launches
                 "kernel": kern,
                 "kernel_launches": int(stats.kernel_launches),
                 **({"kernel_fallback": kern_why} if kern_why else {}),
                 **({"kernel_fallback_detail": kern_detail}
                    if kern_detail else {}),
                 # the elastic scheduler's slot, when it placed the group
                 "device": (ledger_meta or {}).get("device",
                                                   str(solver.device)),
                 # single-window groups ride solver.solve even on several
                 # devices — only real batches shard
                 "sharded": bool(multi_dev and len(lps_dev) > 1),
                 "staged": staged is not None,
                 # serving bucket padding: the compiled shape this batch
                 # actually ran at (absent when unpadded)
                 **({"padded_to": pad_to} if pad_to else {}),
                 "solve_s": round(time.perf_counter() - t_wall, 4),
                 "stack_s": round(t_stack, 4),
                 "iters_p50": int(np.percentile(it, 50)),
                 "iters_p99": int(np.percentile(it, 99)),
                 "iters_max": int(it.max()),
                 "_iters": it}
        # seeded-vs-cold accounting: which members rode a warm start,
        # what it cost them in iterations, and the saving against the
        # structure's rolling cold baseline — the observable the
        # warm-start win is MEASURED by (never asserted)
        if plan_w is not None or seeds is not None:
            if plan_w is not None:
                seeded_i = [i for i in range(n_mem)
                            if plan_w[i].entry is not None
                            or plan_w[i].substituted]
                warm = {
                    "source": "memory",
                    "exact": sum(1 for mp in plan_w
                                 if mp.kind == "exact"),
                    "near": sum(1 for mp in plan_w if mp.kind == "near"),
                    # learned-predictor grade (ops/seedpredict.py)
                    "predicted": sum(1 for mp in plan_w
                                     if mp.kind == "predicted"),
                    # portfolio dual-loop hint grade (ops/warmstart.py)
                    "dual_iterate": sum(1 for mp in plan_w
                                        if mp.kind == "dual_iterate"),
                    "substituted": int(sum(substituted)),
                    "stale_seed_faults": sum(1 for mp in plan_w
                                             if mp.stale_fault),
                }
            else:
                seeded_i = list(range(n_mem))
                warm = {"source": "failed_iterate", "exact": 0,
                        "near": n_mem, "predicted": 0, "dual_iterate": 0,
                        "substituted": 0, "stale_seed_faults": 0}
            cold_i = [i for i in range(n_mem) if i not in set(seeded_i)]
            warm["seeded"] = len(seeded_i)
            warm["cold"] = len(cold_i)
            it_seeded = [int(iters_m[i]) for i in seeded_i]
            it_cold = [int(iters_m[i]) for i in cold_i]
            warm["iters_p50_seeded"] = (
                int(np.percentile(it_seeded, 50)) if it_seeded else None)
            warm["iters_p50_cold"] = (
                int(np.percentile(it_cold, 50)) if it_cold else None)
            it_pred = ([int(iters_m[i]) for i in range(n_mem)
                        if plan_w[i].kind == "predicted"]
                       if plan_w is not None else [])
            warm["iters_p50_predicted"] = (
                int(np.percentile(it_pred, 50)) if it_pred else None)
            base = (memory.cold_p50(key) if memory is not None
                    and key is not None else None)
            warm["baseline_cold_p50"] = base
            warm["iters_saved"] = (
                int(sum(max(0, base - v) for v in it_seeded))
                if base is not None and it_seeded else None)
            warm["_iters_seeded"] = it_seeded
            warm["_iters_cold"] = it_cold
            warm["_iters_predicted"] = it_pred
            entry["warm"] = warm
        if staged is not None:
            # staged staging ran on the dispatch thread, OVERLAPPED with
            # an earlier group's solve — out-of-wall, reported separately
            entry["staged_stack_s"] = round(staged.stack_s, 4)
            entry["staged_h2d_s"] = round(staged.h2d_s, 4)
            entry["h2d_bytes"] = staged.h2d_bytes
        d = stats.as_dict()
        entry["h2d_bytes"] = entry.get("h2d_bytes", 0) + d["h2d_bytes"]
        # the driver's fields: chunks, check windows, their CUDA graphs
        # and status reads
        for k in ("dispatches", "compile_events", "h2d_s",
                  "result_fetch_s", "result_bytes", "cpu_rescued",
                  "compact_events", "bucket_occupancy") + DRIVER_FIELDS:
            entry[k] = d[k]
        # the staged device_put bypasses _data's counter — count its
        # arrays here so bytes and transfers stay mutually consistent
        entry["h2d_transfers"] = d["h2d_transfers"] + (
            len(staged.arrays) if staged is not None else 0)
        ledger.append(entry)
    # accept near-converged iteration-limit exits with a warning — the
    # reference accepts CVXPY 'optimal_inaccurate' the same way.  The
    # warning names the window and its actual KKT residuals: with
    # hundreds of batched windows an anonymous message is unactionable.
    prim_res = pr_m
    gaps = gap_m
    factor = (solver_opts or PDHGOptions()).inaccurate_factor
    for i, s in enumerate(statuses):
        if s == STATUS_INACCURATE:
            ok[i] = True
            name = labels[i] if labels is not None else f"#{i}"
            TellUser.warning(
                f"window {name} solved to reduced accuracy (KKT primal "
                f"residual {float(prim_res[i]):.3e}, gap "
                f"{float(gaps[i]):.3e}; within {factor:g}x tolerance at "
                "the iteration limit)")
    # each status code carries its own diagnosis (a mislabeled failure
    # sends the operator down the wrong tuning path); certified
    # infeasibilities get the dual-ray constraint-group ranking.  The
    # dual block only leaves the device when a certificate needs it —
    # an unconditional readback of (B, m) duals would tax every clean
    # batched solve on the hot path.
    if STATUS_PRIMAL_INFEASIBLE in statuses:
        # infeasibility can only come from a DEVICE member (substitution
        # implies an accepted convergence check); map member -> device
        # row.  When the fused fetch already returned y (want_y), reuse
        # the trimmed host copy instead of a second (padded) round trip.
        row_of = {i: row for row, i in enumerate(dev_idx)}
        if dev_y is not None:
            ys = np.asarray(dev_y)
        else:
            ys = to_host(res.y)
        diags = [diagnose_infeasibility(
                     lp0, ys[row_of[i]] if ys.ndim > 1 else ys)
                 if s == STATUS_PRIMAL_INFEASIBLE else status_message(s)
                 for i, s in enumerate(statuses)]
    else:
        diags = [status_message(s) for s in statuses]
    return xs, objs, ok, diags, statuses


# ---------------------------------------------------------------------------
# Resilience layer: input guards, escalation ladder, case isolation
# ---------------------------------------------------------------------------

# health counters are mutated from the dispatch pipeline's worker threads
# (a case's windows may ride two concurrently-solving groups)
_health_lock = threading.Lock()


def _certification_of(s) -> Dict[str, Any]:
    """The scenario's certification counter dict, lazily created — direct
    ``resolve_group`` callers (tests) may pass scenario stand-ins that
    carry only ``health``."""
    c = getattr(s, "certification", None)
    if c is None:
        c = certify.new_certification()
        try:
            s.certification = c
        except Exception:
            pass
    return c


def _certify_and_record(s, label, lp: LP, x, obj, policy,
                        y=None, was_rejected: bool = False):
    """Run the float64 certifier on one accepted solution and record the
    verdict in the case's certification counters.  ``was_rejected`` marks
    a solution recovered by the escalation ladder after an earlier
    certificate rejection — an accepted re-certificate then counts the
    ``rejected_then_recovered`` recovery."""
    t0 = time.perf_counter()
    cert = certify.certify_solution(lp, x, obj, policy, y=y)
    elapsed = time.perf_counter() - t0
    rec = _certification_of(s)
    with _health_lock:
        rec["cert_s"] += elapsed
        if cert.accepted:
            rec[cert.verdict] += 1
            if was_rejected:
                rec["rejected_then_recovered"] += 1
        else:
            rec["rejected"] += 1
            rec["windows"][str(label)] = cert.as_dict()
    return cert


def _shadow_solve(s, label, lp: LP, obj, policy) -> None:
    """One deterministic shadow re-solve: the exact CPU (HiGHS) objective
    vs the batched solver's, recorded as a run-over-run drift statistic
    in ``certification['shadow']``."""
    t0 = time.perf_counter()
    res = cpu_ref.solve_lp_cpu(lp)
    elapsed = time.perf_counter() - t0
    rec = _certification_of(s)
    if res.status != 0 or not np.isfinite(res.obj):
        TellUser.warning(f"shadow solve of window {label} did not reach "
                         f"optimality ({res.message}); drift sample "
                         "skipped")
        with _health_lock:
            rec["shadow"]["shadow_s"] += elapsed
        return
    rel = abs(float(obj) - res.obj) / (1.0 + abs(res.obj))
    with _health_lock:
        certify.record_shadow(rec["shadow"], label, rel)
        rec["shadow"]["shadow_s"] += elapsed
    if rel > policy.shadow_warn:
        TellUser.warning(
            f"shadow solve of window {label}: batched objective drifts "
            f"{rel:.2e} rel from the exact CPU answer "
            f"(threshold {policy.shadow_warn:g})")
    else:
        TellUser.info(f"shadow solve of window {label}: objective within "
                      f"{rel:.2e} rel of the exact CPU answer")

# escalation-ladder rung 1: re-solve failed members with 4x the iteration
# budget and a 10x-relaxed inaccurate acceptance — PDLP-family solvers have
# heavy-tailed iteration counts (PAPERS.md: MPAX), so a straggler that
# misses the shared budget usually lands well within a boosted one
LADDER_ITER_BOOST = 4
LADDER_INACCURATE_RELAX = 10.0


def _new_health() -> Dict[str, Any]:
    """Per-case window accounting for the run-health report: every window
    ends in exactly one bucket (clean / inaccurate-accepted / recovered on
    retry / recovered on the CPU fallback / quarantined / skipped — never
    dispatched because the case quarantined first); ``retry_seconds`` is
    the case's share of ladder wall time, and ``watchdog_timeouts`` counts
    solve attempts abandoned at the deadline (an event counter, NOT a
    disjoint bucket — a timed-out window still lands in retried /
    cpu_fallback / quarantined).  The bucket set is
    ``io.summary.HEALTH_KEYS`` so the loop and the report cannot drift."""
    from ..io.summary import HEALTH_KEYS
    return {**{k: 0 for k in HEALTH_KEYS}, "retry_seconds": 0.0,
            "watchdog_timeouts": 0}


def _var_name_at(lp: LP, j: int) -> str:
    for name, ref in lp.var_refs.items():
        if ref.start <= j < ref.start + ref.size:
            return f"{name}[{j - ref.start}]"
    return f"x[{j}]"


def validate_lp_inputs(lp: LP, label) -> Optional[str]:
    """Pre-dispatch input guard: NaN/Inf in ``c``/``q`` or crossed bounds
    (``l > u``) would make PDHG burn its whole iteration budget on poisoned
    data (NaN propagates through every matvec and no restart recovers).
    Returns a window-labeled diagnostic, or None when the inputs are
    sound.  ``l``/``u`` may legitimately be +-inf (unbounded variables) —
    only NaN and inverted boxes are rejected there."""
    for name, arr in (("c (costs)", lp.c), ("q (constraint rhs)", lp.q)):
        bad = ~np.isfinite(arr)
        if bad.any():
            j = int(np.argmax(bad))
            where = (_var_name_at(lp, j) if name.startswith("c")
                     else f"row {j}")
            return (f"window {label}: {int(bad.sum())} non-finite "
                    f"entr(ies) in {name}, first at {where}")
    for name, arr in (("l", lp.l), ("u", lp.u)):
        bad = np.isnan(arr)
        if bad.any():
            j = int(np.argmax(bad))
            return (f"window {label}: NaN in bound vector {name} at "
                    f"{_var_name_at(lp, j)}")
    crossed = lp.l > lp.u
    if crossed.any():
        j = int(np.argmax(crossed))
        return (f"window {label}: {int(crossed.sum())} crossed bound(s) "
                f"(l > u), first at {_var_name_at(lp, j)} "
                f"[l={lp.l[j]:g}, u={lp.u[j]:g}]")
    return None


def guard_items(items):
    """Input guards at the batched boundary.  ``items`` is a list of
    ``(scenario, ctx, lp)``; members of already-quarantined cases are
    dropped, fault injection may poison a targeted case's inputs here, and
    a member failing validation quarantines its case with the
    window-labeled diagnostic BEFORE any device dispatch.  Returns the
    members safe to solve."""
    out = []
    for s, ctx, lp in items:
        if s.quarantine is not None:
            continue
        # poison_case fault: a targeted case CRASHES its dispatch (an
        # uncaught runtime error, not a guard-absorbed NaN) — the shape
        # the service's poison-request quarantine attributes
        faultinject.maybe_crash_case(s.case.case_id)
        faultinject.maybe_poison(s.case.case_id, lp)
        err = validate_lp_inputs(lp, ctx.label)
        if err is not None:
            with _health_lock:
                s.health["quarantined"] += 1
            s.quarantine_case(f"input guard rejected the window before "
                              f"dispatch: {err}", label=ctx.label)
            continue
        out.append((s, ctx, lp))
    return out


def _count_watchdog_timeout(items, idxs) -> None:
    """One abandoned solve CALL = one ``watchdog_timeouts`` event per
    involved case — the counter is documented as an event count, so an
    8-window batched call that times out must not read as 8 events."""
    involved = {id(items[i][0]): items[i][0] for i in idxs}
    with _health_lock:
        for s in involved.values():
            s.health["watchdog_timeouts"] += 1


def _guarded_solve(watchdog, rung_desc: str, lps, labels, call):
    """Run one ladder solve under the (optional) watchdog deadline.

    Returns ``((xs, objs, ok, diags, statuses), timed_out)``.  On a
    timeout the wedged call is abandoned (daemon thread) and every member
    is synthesized as a non-converged iteration-limit exit whose
    diagnostic leads with ``watchdog:`` — the marker the escalation
    ladder keys on to keep re-solving even on the otherwise-deterministic
    cpu backend (a hung call, unlike a solved-to-infeasible one, may well
    succeed on a retry)."""
    from ..ops.pdhg import STATUS_ITER_LIMIT
    if watchdog is None:
        return call(), False
    result, timed_out = watchdog.call(
        call, f"{rung_desc} solve of window(s) {labels}")
    if not timed_out:
        return result, False
    n = len(lps)
    diag = (f"watchdog: {rung_desc} solve exceeded the "
            f"{watchdog.deadline_s:g}s deadline")
    return ([np.zeros_like(lp.c) for lp in lps], [float("nan")] * n,
            [False] * n, [diag] * n, [STATUS_ITER_LIMIT] * n), True


def resolve_group(items, backend: str, solver_opts, key=None,
                  cache: Optional[SolverCache] = None, watchdog=None,
                  staged: Optional[StagedGroupData] = None, ledger=None,
                  board=None, policy=None, device=None, ledger_tags=None):
    """Solve a window group with the per-window escalation ladder.

    ``items`` is a list of ``(scenario, ctx, lp)`` (structure-identical
    LPs).  The group solves once; members that exit non-converged then
    climb the ladder in ``_escalate`` — boosted-budget retry, exact CPU
    fallback — with ONLY the failed members re-solved.  Returns
    ``(xs, objs, ok, diags)`` for ``apply_subgroup``; members still failed
    after the ladder keep ``ok=False`` and their diagnosis, and the apply
    step quarantines their case.

    ``watchdog`` (a ``supervisor.SolveWatchdog``) bounds every ladder
    solve with the ``DERVET_TPU_SOLVE_DEADLINE_S`` deadline: a hung call
    is abandoned, counted in ``health['watchdog_timeouts']``, and the
    affected members escalate like any other failure instead of stalling
    the sweep.

    Fault injection (utils.faultinject) flips observed convergence here —
    after the real solve, before the ladder — so tests drive every
    recovery rung through the exact production path.

    ``board`` (a ``utils.breaker.BreakerBoard``, service callers only)
    gates the escalation rungs through circuit breakers: certification
    verdicts are recorded under ``certify``, and ``_escalate`` consults/
    records the ``retry_rung`` / ``cpu_rung`` breakers — a rung whose
    recent failure rate tripped its breaker is skipped (the members fall
    through to the next healthy rung) until a half-open probe succeeds."""
    from ..ops.pdhg import STATUS_CONVERGED, STATUS_INACCURATE, \
        STATUS_ITER_LIMIT, PDHGOptions
    lps = [lp for (_, _, lp) in items]
    labels = [ctx.label for (_, ctx, _) in items]
    meta = {"rung": "initial", "T": getattr(items[0][1], "T", None),
            "windows": len(items),
            "cases": len({id(s) for (s, _, _) in items})}
    # caller tags copied onto the group's ledger entries
    if ledger_tags:
        meta.update(ledger_tags)
    # serving layer: which requests' windows rode this group — the
    # observable that PROVES cross-request coalescing, and the key the
    # service slices per-request ledgers by
    _reqs = sorted({str(s.request_id) for (s, _, _) in items
                    if getattr(s, "request_id", None) is not None})
    if _reqs:
        meta["requests"] = _reqs
    # telemetry (telemetry/trace.py): one dispatch_group span per request
    # that rode this group, parented via the request registry (this may
    # run on a pipeline worker thread) — the group's solve-ledger entry
    # becomes the span's attribute payload at the end
    _tspans: list = []
    if _reqs and telemetry_trace.enabled():
        for _rid in _reqs:
            _sp = telemetry_trace.start_span(
                "dispatch_group", rid=_rid,
                attrs={"windows": len(items), "requests": _reqs,
                       **(ledger_tags or {})})
            if _sp:
                _tspans.append(_sp)
    try:
        # explicit policy wins (the dispatch driver captures it once on the
        # dispatching thread, where a thread-local override may be active —
        # pool workers would otherwise read their own, un-overridden env)
        policy = policy if policy is not None else certify.policy_from_env()
        # the dual block leaves the device ONLY when the certification policy
        # asks for dual-side verification (DERVET_TPU_CERT_DUAL=1)
        y_box: Optional[dict] = ({} if (policy.enabled and policy.check_dual
                                        and backend != "cpu") else None)
        # the watchdog may ABANDON a wedged solve on a daemon thread; handing
        # solve_group the shared ledger would let that zombie append a
        # full-wall entry after the deadline cut dispatch_solve_s short (or
        # after the summary already ran) — so solves write to a PRIVATE list
        # merged only on a non-timed-out return
        local_ledger = [] if ledger is not None else None
        # last-iterate sink: the retry rung seeds its re-solve from the
        # failed members' final iterates (x from the returned lists, y
        # fetched lazily off the device handle captured here)
        iterate_sink: dict = {}

        def _call():
            # hang/slow faults sleep INSIDE the guarded closure, exactly
            # where a wedged device call would be observed; device_loss
            # raises from the same spot a real CUDA error would
            faultinject.maybe_device_loss(
                device if device is not None
                else getattr(cache, "device", None))
            faultinject.maybe_sleep(labels, faultinject.RUNG_SOLVE)
            return solve_group(lps[0], lps, backend, solver_opts, key=key,
                               cache=cache, labels=labels, staged=staged,
                               ledger=local_ledger, ledger_meta=meta,
                               y_sink=y_box, iterate_sink=iterate_sink,
                               device=device)

        (xs, objs, ok, diags, statuses), timed_out = _guarded_solve(
            watchdog, "initial", lps, labels, _call)
        if timed_out:
            _count_watchdog_timeout(items, range(len(items)))
        elif ledger is not None:
            ledger.extend(local_ledger)
        plan = faultinject.get_plan()
        if plan is not None:
            for i, (s, ctx, lp) in enumerate(items):
                if ok[i] and plan.force_nonconverge(ctx.label,
                                                    faultinject.RUNG_SOLVE):
                    ok[i] = False
                    statuses[i] = STATUS_ITER_LIMIT
                    diags[i] = ("fault injection: forced non-convergence at "
                                "rung 'solve'")
            # corrupt_solution fires AFTER the solver's verdict: the solve
            # still reports success, only the numbers are wrong — the shape
            # of failure only the independent certifier below can catch
            for i, (s, ctx, lp) in enumerate(items):
                if ok[i]:
                    bad = faultinject.maybe_corrupt(ctx.label, xs[i],
                                                    faultinject.RUNG_SOLVE, plan)
                    if bad is not None:
                        xs[i] = bad
        # ---- independent float64 certification of every accepted solution
        # (ops/certify.py): a certificate rejection drops the member into the
        # escalation ladder exactly like a solver failure — today's ladder
        # only fires on solver STATUS, so a wrong-but-"OPTIMAL" solution
        # would otherwise never be retried
        cert_rejected: set = set()
        _t_cert_wall, _t_cert_mono = time.time(), time.monotonic()
        _n_certified = 0
        if policy.enabled:
            ys = y_box.get("y") if y_box else None
            if ys is not None and np.ndim(ys) == 1:
                ys = ys[None]
            for i, (s, ctx, lp) in enumerate(items):
                if not ok[i] or (lp.integrality is not None
                                 and backend != "cpu"):
                    # binary relaxations on an accelerated backend are
                    # provisional — apply_subgroup certifies their FINAL x
                    continue
                cert = _certify_and_record(
                    s, ctx.label, lp, xs[i], objs[i], policy,
                    y=(ys[i] if ys is not None else None))
                _n_certified += 1
                if board is not None:
                    board.record("certify", cert.accepted)
                if not cert.accepted:
                    ok[i] = False
                    cert_rejected.add(i)
                    diags[i] = f"{certify.REJECT_DIAG_PREFIX} {cert.reason}"
                    # drop any warm-start memory entry for this exact data:
                    # a rejected solution the memory vouched for would be
                    # re-substituted, re-rejected, and re-escalated on every
                    # repeat request otherwise
                    mem = getattr(cache, "memory", None) \
                        if cache is not None else None
                    if mem is not None and key is not None:
                        mem.invalidate(key, lp, np.dtype(
                            (solver_opts or PDHGOptions()).dtype))
                    TellUser.warning(
                        f"window {ctx.label}: solver-accepted solution "
                        f"REJECTED by the float64 certifier ({cert.reason}); "
                        "escalating")
        if _tspans and policy.enabled and _n_certified:
            # retro certify span: the float64 certification pass this group
            # just ran, as a timed child of each request's group span
            _cert_dur = time.monotonic() - _t_cert_mono
            for _sp in _tspans:
                telemetry_trace.start_span(
                    "certify", parent=_sp, t_start=_t_cert_wall,
                    duration_s=_cert_dur,
                    attrs={"checked": _n_certified,
                           "rejected": len(cert_rejected)})
        fail_idx = [i for i in range(len(items)) if not ok[i]]
        with _health_lock:
            for i, (s, ctx, lp) in enumerate(items):
                # binary windows on an accelerated backend are counted in
                # apply_subgroup instead: their relaxation's convergence here
                # is provisional — the binary-feasibility check / exact-MILP
                # rescue there decides the window's final bucket
                if lp.integrality is not None and backend != "cpu":
                    continue
                if ok[i]:
                    s.health["inaccurate" if statuses[i] == STATUS_INACCURATE
                             else "clean"] += 1
        if fail_idx:
            for _sp in _tspans:
                _sp.event("escalate", failed=len(fail_idx),
                          cert_rejected=len(cert_rejected),
                          timed_out=bool(timed_out))
            _escalate(items, fail_idx, xs, objs, ok, diags, statuses,
                      backend, solver_opts, key, cache, watchdog, ledger=ledger,
                      policy=policy, cert_rejected=cert_rejected, board=board,
                      iterate_sink=iterate_sink, device=device,
                      ledger_tags=ledger_tags)
            for _sp in _tspans:
                _sp.event("escalation_done",
                          recovered=sum(1 for i in fail_idx if ok[i]),
                          unrecovered=sum(1 for i in fail_idx if not ok[i]))
        if policy.enabled and cert_rejected:
            # windows whose LAST certificate still rejected after the full
            # ladder: counted here (their case quarantines in apply_subgroup)
            with _health_lock:
                for i in cert_rejected:
                    if not ok[i]:
                        _certification_of(items[i][0])["rejected_final"] += 1
        # deterministic shadow-solve drift sample, AFTER the ladder so a
        # sampled window that was cert-rejected-then-recovered still gets its
        # cross-check (the drill runs are exactly where it matters most).
        # Skipped on the cpu backend (the shadow would re-run the identical
        # solver) and for binary windows (their accepted value here is the
        # LP relaxation — comparing it against the exact MILP would record
        # the integrality gap as phantom solver drift).
        if policy.enabled and backend != "cpu":
            for i, (s, ctx, lp) in enumerate(items):
                if ok[i] and lp.integrality is None and \
                        ctx.label in getattr(s, "_shadow_labels", ()):
                    _shadow_solve(s, ctx.label, lp, objs[i], policy)
        if _tspans:
            # the ledger entry IS the span attribute payload (tentpole's
            # reuse contract) — minus the private per-window arrays; a
            # watchdog-abandoned solve merged no entry, so the span keeps
            # its construction-time attrs and an error status instead
            _entry = (local_ledger[0]
                      if local_ledger and not timed_out else None)
            _attrs = _span_attrs_from_entry(_entry) if _entry else {}
            _err = ("watchdog timeout" if timed_out else None)
            for _sp in _tspans:
                _sp.set_attrs(_attrs)
                _sp.set_attr("ok_windows", int(sum(bool(o) for o in ok)))
                _sp.end(error=_err)
        return xs, objs, ok, diags
    except BaseException as _exc:
        # raising paths propagate out of the batcher round (device
        # loss, AggregatedSolverError, preemption): end the group
        # spans here or the failed request's exported trace loses
        # its dispatch record (and the escalate event already on it)
        for _sp in _tspans:
            _sp.end(error=_exc)
        raise


def _span_attrs_from_entry(entry: Dict) -> Dict:
    """A solve-ledger group entry as span-attribute payload: everything
    JSON-sized, dropping the private per-window iteration arrays."""
    out: Dict = {}
    for k, v in entry.items():
        if k.startswith("_") or isinstance(v, np.ndarray):
            continue
        if k == "warm" and isinstance(v, dict):
            out[k] = {wk: wv for wk, wv in v.items()
                      if not wk.startswith("_")}
        else:
            out[k] = v
    return out


def _escalate(items, fail_idx, xs, objs, ok, diags, statuses, backend,
              solver_opts, key, cache, watchdog=None, ledger=None,
              policy=None, cert_rejected=None, board=None,
              iterate_sink=None, device=None, ledger_tags=None) -> None:
    """Escalation ladder for a group's failed members (mutates the result
    lists in place).

    Rung 1 — boosted-budget retry: members whose exit was NOT a certified
    infeasibility re-solve with ``LADDER_ITER_BOOST``x ``max_iters`` and a
    relaxed ``inaccurate_factor``; only the failed members are in the
    batch, the retry solver clones the cached base solver's
    preconditioning, and the retry is WARM-STARTED from each failed
    member's last iterate (``iterate_sink`` from the initial solve) —
    restarting a straggler from zero threw away everything its first
    budget bought, so the boosted budget continues from where the member
    stopped instead (``DERVET_TPU_WARMSTART=0`` restores the cold
    retry).  Rung 2 — exact CPU fallback: survivors (and
    certified-infeasible members, whose first-order certificate deserves
    an exact second opinion) solve on HiGHS one by one — the
    generalization of the MILP-rescue pattern to all windows.  Members
    failing both rungs keep their diagnosis for the case quarantine in
    ``apply_subgroup``.  Binary (integral) windows on an accelerated
    backend are excluded: their relaxation failures already re-solve on
    the exact CPU MILP in ``apply_subgroup``.  On the cpu backend with no
    fault plan the ladder short-circuits entirely — the exact solver is
    deterministic, so re-solving cannot recover anything.

    Every recovery is RE-CERTIFIED before it is accepted (``policy``):
    a rung's solution that fails the float64 certificate keeps climbing
    — retry to CPU fallback, CPU fallback to quarantine — and members in
    ``cert_rejected`` (rejected by the initial certificate) count a
    ``rejected_then_recovered`` when a later rung's certificate passes."""
    from ..ops.pdhg import STATUS_ITER_LIMIT, STATUS_PRIMAL_INFEASIBLE, \
        PDHGOptions
    import dataclasses
    plan = faultinject.get_plan()
    policy = policy if policy is not None else certify.policy_from_env()
    cert_rejected = cert_rejected if cert_rejected is not None else set()
    t0 = time.perf_counter()
    fail_idx = [i for i in fail_idx
                if backend == "cpu" or items[i][2].integrality is None]
    if not fail_idx:
        return
    if backend == "cpu" and plan is None and \
            not any(str(diags[i]).startswith(
                ("watchdog", certify.REJECT_DIAG_PREFIX))
                for i in fail_idx):
        # the exact CPU path is deterministic: re-solving the identical
        # HiGHS instance (boosted PDHG options never reach it) cannot
        # change the outcome, so a real cpu-backend failure goes straight
        # to quarantine.  A fault plan keeps the rungs reachable — the
        # injected failures it flips ARE recoverable re-solves.  Watchdog
        # timeouts are one exception: a hung call never produced a
        # verdict at all, and a re-solve may complete within the
        # deadline.  Certificate rejections are the other: the threat
        # model is corrupted DATA HANDLING (a staging race, a scrambled
        # readback), which a re-solve can absolutely recover from.
        return
    # ---- rung 1: boosted-budget retry of the failed members only ----
    retry_idx = [i for i in fail_idx
                 if statuses[i] != STATUS_PRIMAL_INFEASIBLE]
    if retry_idx and board is not None and not board.allow("retry_rung"):
        # circuit breaker: the retry rung's recent failure rate tripped
        # it — stop feeding the sick rung, fall straight through to the
        # CPU fallback (the healthy rung) until a half-open probe heals
        TellUser.warning(
            f"escalation: retry-rung breaker OPEN — {len(retry_idx)} "
            "failed window(s) skip the boosted-budget retry and go "
            "straight to the exact CPU fallback")
        retry_idx = []
    if retry_idx:
        base = solver_opts or PDHGOptions()
        boosted = dataclasses.replace(
            base, max_iters=base.max_iters * LADDER_ITER_BOOST,
            inaccurate_factor=base.inaccurate_factor
            * LADDER_INACCURATE_RELAX)
        sub_lps = [items[i][2] for i in retry_idx]
        sub_labels = [items[i][1].label for i in retry_idx]
        rkey = ("retry", key) if key is not None and cache is not None \
            else None
        TellUser.info(
            f"escalation: re-solving {len(retry_idx)} non-converged "
            f"window(s) {sub_labels} with {LADDER_ITER_BOOST}x iteration "
            "budget")

        # warm-start the retry from each failed member's LAST iterate:
        # the failed xs[] are already on the host (zeros after a
        # watchdog timeout — a cold seed, harmless); the duals come off
        # the device handle the initial solve left in ``iterate_sink``.
        # A cold restart would discard everything the first budget
        # bought; the seed lets the boosted budget CONTINUE instead.
        retry_seeds = None
        if backend != "cpu":
            from ..ops import warmstart as _ws
            if _ws.enabled():
                X0 = np.stack([np.asarray(xs[i], np.float64)
                               for i in retry_idx])
                Y0 = np.zeros((len(retry_idx), items[0][2].m))
                sink = iterate_sink or {}
                y_dev = sink.get("y_dev")
                rows = sink.get("rows") or {}
                if y_dev is not None:
                    try:
                        from ..ops.pdhg import to_host
                        y_host = np.atleast_2d(to_host(y_dev))
                        # per member: a retried member missing from the
                        # device-row map (e.g. substituted then
                        # cert-rejected) keeps a zero dual seed without
                        # costing its batchmates theirs
                        for j, i in enumerate(retry_idx):
                            if i in rows and rows[i] < y_host.shape[0]:
                                Y0[j] = y_host[rows[i]]
                    except Exception:
                        pass        # cold dual seed — still sound
                retry_seeds = (X0, Y0)

        # private list for the same zombie-append hazard as the initial
        # rung (see resolve_group)
        retry_ledger = [] if ledger is not None else None
        # dual-side recertification needs the retry's duals too — the
        # rung that REJECTED for a dual/gap violation must not re-accept
        # on a primal-only certificate (the CPU rung has no duals: the
        # HiGHS wrapper does not surface them, so its recovery
        # certificate is primal+objective only)
        retry_y_box: Optional[dict] = (
            {} if (policy.enabled and policy.check_dual
                   and backend != "cpu") else None)

        def _retry_call():
            faultinject.maybe_sleep(sub_labels, faultinject.RUNG_RETRY)
            return solve_group(sub_lps[0], sub_lps, backend, boosted,
                               key=rkey, cache=cache, labels=sub_labels,
                               ledger=retry_ledger,
                               ledger_meta={"rung": "retry",
                                            "windows": len(sub_lps),
                                            **(ledger_tags or {})},
                               y_sink=retry_y_box, seeds=retry_seeds,
                               device=device)

        (rxs, robjs, rok, rdiags, rstatuses), r_timed_out = _guarded_solve(
            watchdog, "retry", sub_lps, sub_labels, _retry_call)
        if r_timed_out:
            _count_watchdog_timeout(items, retry_idx)
        elif ledger is not None:
            ledger.extend(retry_ledger)
        for j, i in enumerate(retry_idx):
            label = items[i][1].label
            if rok[j] and plan is not None and plan.force_nonconverge(
                    label, faultinject.RUNG_RETRY):
                rok[j] = False
                rstatuses[j] = STATUS_ITER_LIMIT
                rdiags[j] = ("fault injection: forced non-convergence at "
                             "rung 'retry'")
            if rok[j] and plan is not None:
                bad = faultinject.maybe_corrupt(label, rxs[j],
                                                faultinject.RUNG_RETRY, plan)
                if bad is not None:
                    rxs[j] = bad
            if rok[j] and policy.enabled:
                # the retry's solution must itself pass the float64
                # certificate before it is accepted
                rys = retry_y_box.get("y") if retry_y_box else None
                if rys is not None and np.ndim(rys) == 1:
                    rys = rys[None]
                cert = _certify_and_record(
                    items[i][0], label, items[i][2], rxs[j], robjs[j],
                    policy, y=(rys[j] if rys is not None else None),
                    was_rejected=(i in cert_rejected))
                if board is not None:
                    board.record("certify", cert.accepted)
                if not cert.accepted:
                    rok[j] = False
                    cert_rejected.add(i)
                    rdiags[j] = (f"{certify.REJECT_DIAG_PREFIX} retry "
                                 f"solution rejected: {cert.reason}")
            if board is not None:
                board.record("retry_rung", bool(rok[j]))
            if rok[j]:
                xs[i], objs[i], ok[i] = rxs[j], robjs[j], True
                diags[i], statuses[i] = rdiags[j], rstatuses[j]
                # health buckets are disjoint final outcomes: a window
                # counts "retried" only when rung 1 is where it landed
                with _health_lock:
                    items[i][0].health["retried"] += 1
                TellUser.info(f"window {label} recovered on the "
                              "boosted-budget retry")
            else:
                # carry the retry's (possibly changed) verdict into rung 2
                diags[i], statuses[i] = rdiags[j], rstatuses[j]
    # ---- rung 2: exact CPU fallback, one member at a time ----
    t_rung2 = time.perf_counter()
    rung2_idx = [i for i in fail_idx if not ok[i]]
    if rung2_idx and board is not None and not board.allow("cpu_rung"):
        # circuit breaker: the HiGHS fallback rung itself is sick
        # (crashing / hanging / cert-rejecting) — quarantining fast
        # beats wedging every round on a dead rung; the half-open
        # probe re-opens it once it recovers
        TellUser.warning(
            f"escalation: CPU-fallback breaker OPEN — {len(rung2_idx)} "
            "window(s) skip the exact CPU rung and quarantine directly")
        rung2_idx = []
    for i in rung2_idx:
        s, ctx, lp = items[i]
        if plan is not None and plan.cpu_should_fail(ctx.label):
            diags[i] = (f"{diags[i]}; fault injection: CPU fallback "
                        "forced to fail")
            if board is not None:
                board.record("cpu_rung", False)
            continue
        if backend == "cpu" and statuses[i] == STATUS_PRIMAL_INFEASIBLE:
            continue      # HiGHS already certified it exactly

        def _cpu_call(lp=lp, label=ctx.label):
            faultinject.maybe_sleep(label, faultinject.RUNG_CPU)
            return cpu_ref.solve_lp_cpu(lp)

        if watchdog is None:
            res = _cpu_call()
        else:
            res, c_timed_out = watchdog.call(
                _cpu_call, f"CPU-fallback solve of window {ctx.label}")
            if c_timed_out:
                with _health_lock:
                    s.health["watchdog_timeouts"] += 1
                diags[i] = (f"{diags[i]}; watchdog: CPU fallback exceeded "
                            f"the {watchdog.deadline_s:g}s deadline")
                if board is not None:
                    board.record("cpu_rung", False)
                continue
        if res.status == 0 and np.isfinite(res.obj):
            xr = np.array(res.x, dtype=float)
            if plan is not None:
                bad = faultinject.maybe_corrupt(ctx.label, xr,
                                                faultinject.RUNG_CPU, plan)
                if bad is not None:
                    xr = bad
            cert = (_certify_and_record(s, ctx.label, lp, xr, res.obj,
                                        policy,
                                        was_rejected=(i in cert_rejected))
                    if policy.enabled else None)
            if cert is not None and board is not None:
                board.record("certify", cert.accepted)
            if cert is not None and not cert.accepted:
                cert_rejected.add(i)
                diags[i] = (f"{certify.REJECT_DIAG_PREFIX} CPU-fallback "
                            f"solution rejected: {cert.reason}")
                if board is not None:
                    board.record("cpu_rung", False)
                continue
            xs[i], objs[i], ok[i] = xr, res.obj, True
            with _health_lock:
                s.health["cpu_fallback"] += 1
            if board is not None:
                board.record("cpu_rung", True)
            TellUser.info(f"window {ctx.label} rescued on the exact CPU "
                          "fallback")
        elif statuses[i] != STATUS_PRIMAL_INFEASIBLE:
            # keep the richer dual-ray diagnosis when PDHG certified
            # infeasibility; otherwise HiGHS's verdict is the better one
            diags[i] = res.message or diags[i]
            if board is not None:
                # a definitive infeasible VERDICT is the exact rung doing
                # its job (window-shaped failure, not rung sickness);
                # only abnormal exits count against the rung's breaker
                board.record("cpu_rung", res.status == 2)
    if ledger is not None and rung2_idx:
        ledger.append({"rung": "cpu_fallback", "backend": "cpu",
                       "batch": len(rung2_idx), **(ledger_tags or {}),
                       "solve_s": round(time.perf_counter() - t_rung2, 4)})
    # ladder wall time is attributed proportionally to each involved
    # case's failed-member count: the per-case values then SUM to the real
    # elapsed time, so the run report's aggregate is not inflated by the
    # number of cases sharing one batched ladder
    elapsed = time.perf_counter() - t0
    shares: Dict[int, list] = {}
    for i in fail_idx:
        s = items[i][0]
        shares.setdefault(id(s), [s, 0])[1] += 1
    with _health_lock:
        for s, n in shares.values():
            s.health["retry_seconds"] += elapsed * n / len(fail_idx)


PIPELINE_ENV = "DERVET_TPU_PIPELINE"


def _pipeline_enabled() -> bool:
    """Overlapped-dispatch kill switch: ``DERVET_TPU_PIPELINE=0`` forces
    the strict serial reference path (assemble -> solve -> scatter, one
    group at a time on one thread).  The pipeline and the serial path
    produce byte-identical results by construction — identical grouping,
    identical batches, only execution overlap differs — and the serial
    mode exists so a test can ASSERT that instead of trusting it."""
    import os
    return os.environ.get(PIPELINE_ENV, "1").strip().lower() \
        not in ("0", "false", "off")


def _pipeline_depth(multi_dev: bool = False) -> int:
    """In-flight group bound for the overlapped dispatch: 0 = serial
    reference mode (``DERVET_TPU_PIPELINE=0``); an explicit integer > 1 in
    the env var pins the depth; 1 when each batch is split over several
    devices (see the pipeline in ``_dispatch_phases``); default 2-3.  A
    worker spends its time blocked in GIL-releasing device waits, so
    while worker A waits on group A's status readback, worker B enqueues
    group B's next chunk."""
    import os
    raw = os.environ.get(PIPELINE_ENV, "1").strip().lower()
    if raw in ("0", "false", "off"):
        return 0
    if multi_dev:
        return 1
    try:
        explicit = int(raw)
    except ValueError:
        explicit = 1
    if explicit > 1:
        return explicit
    return max(2, min(3, os.cpu_count() or 1))


def summarize_solve_ledger(entries, dispatch_solve_s: float,
                           pipeline: bool, max_inflight: int) -> Dict:
    """Aggregate per-group solve-ledger entries into the published
    ``solve_ledger`` observable (VERDICT r5 #1: the 60x per-LP gap must
    decompose into named, reproducible numbers).

    Per device entry, the IN-WALL split is ``stack_s + h2d_s + sync_wait_s
    + result_fetch_s + other_s == solve_s`` (``other_s`` is host Python:
    status mapping, enqueue overhead, GIL waits); staged uploads ran
    overlapped on the dispatch thread and are reported out-of-wall
    (``staged_stack_s``/``staged_h2d_s``).  ``totals.solve_s`` sums the
    entry walls — cumulative across pipeline threads, the same
    convention as ``dispatch_solve_s`` — so ``accounted_fraction``
    states how much of the measured solve phase the ledger explains."""
    from ..ops.pdhg import DRIVER_FIELDS
    groups = []
    # the driver's fields: its seconds with the times, the rest counted
    totals = {k: 0.0 for k in ("solve_s", "stack_s", "h2d_s",
                               "result_fetch_s", "other_s",
                               "staged_stack_s", "staged_h2d_s")
              + tuple(k for k in DRIVER_FIELDS if k.endswith("_s"))}
    counts = {k: 0 for k in ("h2d_bytes", "result_bytes", "dispatches",
                             "compile_events", "h2d_transfers",
                             "cpu_rescued", "compact_events", "windows")
              + tuple(k for k in DRIVER_FIELDS if not k.endswith("_s"))}
    iters_all = []
    warm_seeded_it: list = []
    warm_cold_it: list = []
    warm_pred_it: list = []
    warm_tot = {"seeded": 0, "cold": 0, "substituted": 0, "exact": 0,
                "near": 0, "predicted": 0, "dual_iterate": 0,
                "stale_seed_faults": 0, "iters_saved": 0}
    warm_seen = False
    # solver-core aggregation (ROADMAP item 1): which step variant each
    # group ran, total adaptive restarts (== Halpern anchor resets under
    # 'halpern'), and the realized check cadences
    from collections import Counter as _Counter
    core_variants: "_Counter" = _Counter()
    core_schemes: "_Counter" = _Counter()
    core_restarts = 0
    core_anchor_resets = 0
    core_cadences: list = []
    for e in entries:
        e = dict(e)
        it = e.pop("_iters", None)
        if it is not None:
            iters_all.append(np.asarray(it).ravel())
        w = e.get("warm")
        if w is not None:
            # per-group warm accounting (initial rungs only — the retry
            # rung's failed_iterate seeds re-solve members the initial
            # rung already counted)
            w = e["warm"] = dict(w)
            s_it = w.pop("_iters_seeded", None) or []
            c_it = w.pop("_iters_cold", None) or []
            p_it = w.pop("_iters_predicted", None) or []
            if e.get("rung") in (None, "initial"):
                warm_seen = True
                warm_seeded_it.extend(int(v) for v in s_it)
                warm_cold_it.extend(int(v) for v in c_it)
                warm_pred_it.extend(int(v) for v in p_it)
                for k in warm_tot:
                    warm_tot[k] += int(w.get(k) or 0)
        if e.get("backend") != "cpu":
            known = sum(e.get(k, 0.0) for k in
                        ("stack_s", "h2d_s", "sync_wait_s",
                         "result_fetch_s"))
            e["other_s"] = round(max(0.0, e.get("solve_s", 0.0) - known), 4)
        if e.get("variant"):
            core_variants[e["variant"]] += 1
            if e.get("restart_scheme"):
                core_schemes[e["restart_scheme"]] += 1
            core_restarts += int(e.get("restarts") or 0)
            if e["variant"] == "halpern":
                core_anchor_resets += int(e.get("restarts") or 0)
            if e.get("cadence_final"):
                core_cadences.append(int(e["cadence_final"]))
        for k in totals:
            totals[k] += float(e.get(k, 0.0))
        for k in counts:
            if k == "windows":
                # DISTINCT windows: retry/cpu_fallback rungs re-solve
                # members the initial rung already counted — including
                # them would flatter any per-LP rate derived from totals
                if e.get("rung") in (None, "initial"):
                    counts[k] += int(e.get("batch", 0))
            else:
                counts[k] += int(e.get(k, 0))
        groups.append(e)
    out = {
        "groups": groups,
        "totals": {**{k: round(v, 3) for k, v in totals.items()}, **counts},
        "dispatch_solve_s": round(dispatch_solve_s, 3),
        "accounted_fraction": round(
            totals["solve_s"] / dispatch_solve_s, 4)
        if dispatch_solve_s > 0 else None,
        "pipeline": bool(pipeline),
        "max_inflight": int(max_inflight),
    }
    if iters_all:
        it = np.concatenate(iters_all)
        out["iters"] = {"p50": int(np.percentile(it, 50)),
                        "p99": int(np.percentile(it, 99)),
                        "max": int(it.max())}
    # kernel-selection observable: how many groups rode each chunk kernel
    # (or the plain chunk, with its fallback reasons aggregated) and the
    # kernel launches those groups made
    kernels = [e.get("kernel") for e in groups if e.get("kernel")]
    if kernels:
        from collections import Counter
        from ..ops.fused_chunk import KERNELS
        from ..ops.pdhg import KERNEL_PLAIN
        reasons = Counter(e["kernel_fallback"] for e in groups
                          if e.get("kernel_fallback"))
        launches = Counter()
        for e in groups:
            if e.get("kernel") in KERNELS:
                launches[e["kernel"]] += int(e.get("kernel_launches", 0))
        out["kernel"] = {
            **{k: sum(1 for g in kernels if g == k)
               for k in KERNELS + (KERNEL_PLAIN,)},
            "launches": {k: int(launches[k]) for k in KERNELS},
            "fallback_reasons": dict(reasons),
        }
    if core_variants:
        # solver-core observable (surfaces in service.metrics() too):
        # the variant mix actually running, restart/anchor-reset volume,
        # and the realized adaptive check cadence across groups
        out["solver_core"] = {
            "variants": dict(core_variants),
            # restart-criterion mix (the Halpern-native fixed_point
            # scheme vs the retained PDLP kkt schedule)
            "restart_schemes": dict(core_schemes),
            "restarts": int(core_restarts),
            "anchor_resets": int(core_anchor_resets),
            "cadence_final_max": (max(core_cadences)
                                  if core_cadences else None),
            "cadence_final_min": (min(core_cadences)
                                  if core_cadences else None),
        }
    if warm_seen:
        # dispatch-level seeded-vs-cold split (initial rungs): the
        # published warm-start observable the smoke/bench gates read
        n_windows = warm_tot["seeded"] + warm_tot["cold"]
        out["warm_start"] = {
            **warm_tot,
            "seeded_fraction": round(
                warm_tot["seeded"] / n_windows, 4) if n_windows else 0.0,
            "iters_p50_seeded": (int(np.percentile(warm_seeded_it, 50))
                                 if warm_seeded_it else None),
            "iters_p50_cold": (int(np.percentile(warm_cold_it, 50))
                               if warm_cold_it else None),
            "iters_p50_predicted": (int(np.percentile(warm_pred_it, 50))
                                    if warm_pred_it else None),
        }
    return out


def run_dispatch(scenarios, backend: str = "torch", solver_opts=None,
                 checkpoint_dir=None, supervisor=None,
                 on_case_solved=None, solver_cache=None,
                 breaker_board=None, device=None, elastic=None) -> None:
    """Dispatch driver over one or many cases (VERDICT r2 #3/#7).

    Replaces the reference's serial sensitivity for-loop
    (dervet/DERVET.py:75-83): windows with byte-identical constraint
    structure are batched ACROSS cases into single device calls, and
    degradation-coupled cases — sequential in time — still batch window
    step t across all cases, carrying each case's own SOH state.

    ``supervisor`` (a ``utils.supervisor.RunSupervisor``) makes the sweep
    preemption-safe: its stop flag (set by SIGTERM/SIGINT) is checked at
    every window-batch boundary, and a requested stop flushes all case
    checkpoints plus the sweep-level ``run_manifest.json`` before raising
    ``PreemptedError``.  With ``checkpoint_dir`` set, a prior manifest is
    consulted first and fully-``done`` cases (fingerprint-verified) are
    reloaded instead of re-dispatched.  The supervisor's watchdog (env
    ``DERVET_TPU_SOLVE_DEADLINE_S``) bounds each ladder solve.

    ``on_case_solved(scenario)`` fires ON THE DISPATCH THREAD the moment
    a case's LAST window solves (phase-1 cases only; degradation-coupled
    and quarantined cases never fire) — the hook that lets the caller
    overlap per-case post-processing with the remaining in-flight solves.
    At fire time the case's solution is complete and scattered state is
    NOT yet built; dispatch-global ``solve_metadata`` totals land later,
    in ``finish_dispatch``.

    ``solver_cache`` (a :class:`SolverCache`) lets a LONG-LIVED caller —
    the scenario service — carry compiled solvers and their
    preconditioning across run_dispatch calls: a hot service's steady
    state pays zero builds for structures it has seen.  This is also the entry point for externally pre-grouped window
    batches: callers coalescing cases from many requests simply pass all
    their scenarios here and the structure-key grouping batches them
    across request boundaries exactly like sensitivity cases.  Default
    (None) keeps today's per-dispatch cache.

    ``breaker_board`` (a ``utils.breaker.BreakerBoard``, service callers
    only) gates the escalation ladder's rungs through circuit breakers —
    see ``resolve_group``.  None (solo runs) means no breakers.

    ``device`` is where the 'torch' backend solves (``None`` -> the
    GPU, raising when none is visible; ``"cpu"`` runs the kernels' plain
    versions).

    ``elastic`` is the dispatch's device-placement axis: None (default)
    follows the ``DERVET_TPU_ELASTIC`` env policy — with several visible
    devices, structure groups are placed across them and solved
    concurrently (``parallel/elastic.py``); ``False`` forces the plain
    pipeline, which splits each batch over the devices
    (``parallel/mesh.py``).  Callers whose round is ONE wide structure
    group — the design screen's candidate population — pass False:
    splitting that single batch over every device beats placing it on
    one, and the elastic scheduler has nothing to schedule across."""
    from ..utils.errors import PreemptedError
    from ..utils import supervisor as _sup
    if backend not in ("torch", "cpu"):
        raise ValueError(f"backend must be 'torch' or 'cpu', got "
                         f"{backend!r}")
    watchdog = (supervisor.watchdog if supervisor is not None
                else _sup.SolveWatchdog.from_env())
    if backend != "cpu":
        from ..device import resolve_device
        from ..parallel import elastic as _elastic
        device = resolve_device(device)
        if watchdog is not None and \
                len(_elastic.visible_devices(device)) > 1:
            # abandoning a solve split over several devices leaves its
            # shard threads running on them, and the retry would start a
            # SECOND split solve on the same devices under it.  A
            # disabled watchdog degrades to the unguarded path; the
            # checkpoint/manifest flush it protects still runs.
            TellUser.warning(
                f"{_sup.DEADLINE_ENV} ignored with several visible "
                "devices: abandoning an in-flight sharded solve is unsafe "
                "there — solve watchdog disabled")
            watchdog = None
    manifest = _sup.load_manifest(checkpoint_dir) if checkpoint_dir else None
    for s in scenarios:
        entry = (manifest or {}).get("cases", {}).get(str(s.case.case_id))
        if entry is not None and entry.get("status") == "done" and \
                entry.get("fingerprint") == s._checkpoint_fingerprint() and \
                s.prepare_resume(backend, solver_opts, checkpoint_dir,
                                 device):
            continue
        s.prepare_dispatch(backend, solver_opts, checkpoint_dir, device)

    # -- preemption machinery: one counter of applied window batches;
    # every boundary first gives the fault injector its chance to deliver
    # a SIGTERM, then honors the supervisor's stop flag
    _batches_done = [0]

    def _batch_boundary():
        _batches_done[0] += 1
        faultinject.maybe_preempt(_batches_done[0])
        if supervisor is not None and supervisor.stop_requested():
            raise PreemptedError(
                f"stop requested (signal {supervisor.stop_signal}) — "
                f"dispatch halted after {_batches_done[0]} window "
                "batch(es)")

    try:
        _dispatch_phases(scenarios, backend, solver_opts, watchdog,
                         _batch_boundary, on_case_solved,
                         solver_cache=solver_cache,
                         breaker_board=breaker_board, device=device,
                         elastic=elastic)
    except PreemptedError as e:
        # graceful shutdown: any batched-up checkpoint state is flushed
        # (only the degradation path batches writes, in strides of 8 —
        # group solves already persist after every apply, so most cases
        # need no write here and the shutdown window stays short ahead of
        # a scheduler's SIGKILL follow-up) and the sweep-level manifest
        # records done/partial/quarantined per case, so the NEXT run with
        # this checkpoint_dir resumes instead of restarting.  All writes
        # are atomic — a second, impatient SIGTERM mid-flush leaves the
        # previous complete files.
        if checkpoint_dir:
            for s in scenarios:
                if s.opt_engine and s.quarantine is None:
                    s._flush_checkpoint()
            _sup.write_manifest(checkpoint_dir, scenarios, backend)
            TellUser.warning(
                f"preempted: checkpoints + run manifest flushed to "
                f"{checkpoint_dir}; re-run with the same checkpoint_dir "
                "to resume")
        else:
            TellUser.warning(
                "preempted with no checkpoint_dir: nothing could be "
                "persisted — re-run starts from scratch")
        raise e
    _finish_dispatch_bookkeeping(scenarios, backend, checkpoint_dir)


def _dispatch_phases(scenarios, backend, solver_opts, watchdog,
                     _batch_boundary, on_case_solved=None,
                     solver_cache=None, breaker_board=None,
                     device=None, elastic=None) -> None:
    """Phases 1 (structure-grouped) and 2 (degradation-stepped) of the
    batched dispatch; split out of ``run_dispatch`` so the preemption
    handler wraps exactly the interruptible region."""

    # phase 1: all non-degradation windows of all cases, pre-grouped by a
    # CHEAP structural fingerprint (no LP assembly), then — once a group's
    # LPs are built for solving — VERIFIED and split by the exact
    # byte-level structure key.  Each LP is built exactly once (the old
    # fingerprint pass built every LP a second time just to hash it —
    # ~40% of a 128-case sweep's wall clock, profiled r4); peak memory is
    # still one cheap-group's LPs.
    cache = solver_cache if solver_cache is not None else SolverCache()
    if cache.device is None:
        cache.device = device
    groups: Dict[tuple, list] = {}
    for s in scenarios:
        for key, ctx in s.pending_window_groups():
            groups.setdefault(key, []).append((s, ctx))

    # deterministic shadow-solve sample: the K pending windows (across
    # phases and cases) with the smallest cryptographic shadow ranks
    # re-solve on exact CPU HiGHS for an objective drift statistic —
    # identical selection run over run, so the drift is comparable
    cert_policy = certify.policy_from_env()
    shadow_expected = 0
    if cert_policy.enabled and cert_policy.shadow_k > 0 and backend != "cpu":
        shadow_pairs = []
        for s in scenarios:
            # binary cases are excluded at PICK time: their accepted
            # value on an accelerated backend is the LP relaxation, and
            # a deterministic rank landing on one would silently zero
            # the shadow coverage every run for that input set
            if s.quarantine is not None or not s.opt_engine \
                    or s.incl_binary:
                continue
            for ctx in getattr(s, "_pending", ()):
                if ctx.label not in s._solved:
                    shadow_pairs.append((s, ctx.label))
        chosen = set(certify.pick_shadow_sample(
            [(s.case.case_id, lbl) for s, lbl in shadow_pairs],
            cert_policy.shadow_k))
        shadow_expected = len(chosen)
        for s, lbl in shadow_pairs:
            if (s.case.case_id, lbl) in chosen:
                s._shadow_labels.add(lbl)
    if len(scenarios) > 1 and any(len(g) > 1 for g in groups.values()):
        TellUser.info(
            f"cross-case batching: {sum(len(g) for g in groups.values())} "
            f"windows from {len(scenarios)} case(s) in {len(groups)} "
            "pre-group(s)")
    # per-case membership count AND the dispatch-wide group count are the
    # observables that prove cross-case sharing (4 cases x 12 windows in
    # 3 groups, not 12 per-case groups); they are recorded from the
    # VERIFIED byte-level subgroups below, not the cheap pre-groups — if
    # a swept parameter starts entering K, the fan-out shows up here
    exact_keys_all: set = set()
    exact_keys_by_case: Dict[int, set] = {}
    # wall-clock phase observables (VERDICT r5 #1): host LP assembly vs
    # solve (device solve + readback for 'torch'; HiGHS for 'cpu'),
    # plus the per-group solve LEDGER that decomposes the solve phase
    # into named device-traffic line items.  Cumulative across pipeline
    # threads — overlap means they may sum past the dispatch wall time.
    phase_acc = {"assembly_s": 0.0, "solve_s": 0.0, "stage_s": 0.0}
    ledger_entries: list = []
    import threading
    phase_lock = threading.Lock()    # solve_only runs in pool workers
    pipeline_on = backend != "cpu" and _pipeline_enabled()
    # cases whose LAST window just solved, announced to the caller so
    # per-case post-processing overlaps the remaining in-flight solves
    _case_solved_fired: set = set()

    def _maybe_case_solved(s) -> None:
        if on_case_solved is None or id(s) in _case_solved_fired:
            return
        if s.quarantine is not None or not s.opt_engine or s._degrading:
            return
        if all(ctx.label in s._solved for ctx in s.windows):
            _case_solved_fired.add(id(s))
            on_case_solved(s)

    def solve_only(key, items, staged=None):
        t0 = time.perf_counter()
        out = items, resolve_group(items, backend, solver_opts,
                                   key=key, cache=cache, watchdog=watchdog,
                                   staged=staged, ledger=ledger_entries,
                                   board=breaker_board, policy=cert_policy)
        dt_ = time.perf_counter() - t0
        with phase_lock:
            phase_acc["solve_s"] += dt_
        return out

    def scatter(items, result):
        xs, objs, ok, diags = result
        per_case: Dict[int, list] = {}
        order: Dict[int, MicrogridScenario] = {}
        for (s, ctx, lp), x, o, k, dg in zip(items, xs, objs, ok, diags):
            per_case.setdefault(id(s), []).append(((ctx, lp), x, o, k, dg))
            order[id(s)] = s
        for sid, entries in per_case.items():
            order[sid].apply_subgroup(
                [e[0] for e in entries], [e[1] for e in entries],
                [e[2] for e in entries], [e[3] for e in entries],
                [e[4] for e in entries], backend)
            _maybe_case_solved(order[sid])

    def split_exact(members):
        """Build a cheap group's LPs and split by the exact byte-level
        structure key — co-batching is only sound for byte-identical K +
        eq/ineq split, so the cheap pre-grouping is VERIFIED here (DR
        event windows, rte sweeps, EV plug sessions split off cleanly).

        The first case to build a given window label becomes the label's
        TEMPLATE; sibling cases then assemble data-only against its K
        (digest-verified inside build_window_lp — a swept parameter that
        enters K falls back to a full build and splits off below)."""
        t0 = time.perf_counter()
        templates: Dict[object, LP] = {}
        items = []
        for s, ctx in members:
            if s.quarantine is not None:    # case failed in an earlier group
                continue
            lp = s.build_window_lp(ctx, s._annuity_scalar, s._requirements,
                                   template=templates.get(ctx.label))
            if ctx.label not in templates:
                templates[ctx.label] = lp
            items.append((s, ctx, lp))
        phase_acc["assembly_s"] += time.perf_counter() - t0
        # pre-dispatch input guards: poisoned members quarantine their
        # case here, with a window-labeled diagnostic, instead of burning
        # a device budget on NaN data
        items = guard_items(items)
        subgroups: Dict[tuple, list] = {}
        for item in items:
            k = MicrogridScenario._structure_key(item[2])
            subgroups.setdefault(k, []).append(item)
            exact_keys_all.add(k)
            exact_keys_by_case.setdefault(id(item[0]), set()).add(k)
        return subgroups

    max_inflight = 0
    elastic_stats = None
    elastic_devs = None
    multi_dev = False
    if backend != "cpu":
        from ..parallel import elastic as _elastic
        multi_dev = len(_elastic.visible_devices(cache.device)) > 1
        if pipeline_on and elastic is not False:
            elastic_devs = _elastic.elastic_devices(backend, cache.device)
    if backend == "cpu" or not pipeline_on:
        # the exact-CPU path, and the strict serial reference mode
        # (DERVET_TPU_PIPELINE=0): assemble, solve, scatter one subgroup
        # at a time on this thread — no staging, no overlap.  Grouping
        # and batch contents are IDENTICAL to the pipeline's, so results
        # are byte-identical; tests assert the pipeline against this path.
        while groups:
            _, members = groups.popitem()
            for k, its in split_exact(members).items():
                scatter(its, solve_only(k, its)[1])
                _batch_boundary()
    elif elastic_devs is not None:
        # ELASTIC multi-device dispatch (parallel/elastic.py): structure
        # groups are PLACED across the devices (estimated cost + solver
        # affinity) and each device runs its own in-flight pipeline — a
        # worker thread on a CUDA stream of its own, a solver-cache
        # shard, staged uploads, work stealing for stragglers.  Each
        # group solves as one batched solve on its device — the SAME
        # solve whatever the device count, so results are byte-identical
        # across elastic schedules, placements and steals.  Scatter and
        # preemption boundaries stay on THIS thread, like the pipeline.
        max_inflight = len(elastic_devs)
        sched = _elastic.ElasticScheduler(elastic_devs)

        def _elastic_solve(dev, dev_idx, task):
            faultinject.maybe_straggle(dev_idx)
            shard = cache.shard_for(dev, dev_idx)
            tags = {"device": dev_idx}
            if task.stolen:
                tags["stolen"] = True
            t0 = time.perf_counter()
            out = resolve_group(task.items, backend, solver_opts,
                                key=task.key, cache=shard,
                                watchdog=watchdog, staged=task.staged,
                                ledger=ledger_entries, board=breaker_board,
                                policy=cert_policy, device=dev,
                                ledger_tags=tags)
            dt_ = time.perf_counter() - t0
            with phase_lock:
                phase_acc["solve_s"] += dt_
            return out

        def _elastic_stage(dev, task):
            # on the worker's thread, so on its stream: the upload is
            # ordered before the solve that reads it
            t0 = time.perf_counter()
            staged = stage_group_data(
                task.items, solver_opts, dev,
                pad_to=_batch_pad_to(cache, len(task.items)))
            with phase_lock:
                phase_acc["stage_s"] += time.perf_counter() - t0
            return staged

        # the straggler drill queues the round's groups before the
        # workers start: placement then sees every group at once, so
        # whether the straggler is left queued groups to steal does not
        # hang on the host's LP assembly racing the device's solves
        plan = faultinject.get_plan()
        hold = plan is not None and plan.straggler
        if not hold:
            sched.start(_elastic_solve, _elastic_stage)
        try:
            while groups:
                _, members = groups.popitem()
                for k, its in split_exact(members).items():
                    sched.submit(
                        k, its,
                        _elastic.estimate_group_cost(k, its, cache),
                        affinity=cache.device_index_for(k))
            sched.close_submissions()
            if hold:
                sched.start(_elastic_solve, _elastic_stage)
            # scatter in SUBMISSION order, not completion order: apply
            # order drives the results surface's row order, and
            # completion order varies with device timing run to run.
            # Out-of-order completions buffer until their turn — the
            # plain path's exact scatter sequence, reproduced.  A
            # worker's error (a CUDA fault included) raises here.
            done_buf: Dict[int, tuple] = {}
            next_seq = 0
            for task, result, err in sched.completions():
                if err is not None:
                    raise err
                done_buf[task.seq] = (task, result)
                while next_seq in done_buf:
                    t, r = done_buf.pop(next_seq)
                    next_seq += 1
                    scatter(t.items, r)
                    _batch_boundary()
        finally:
            # preemption/error: stop the workers (in-flight solves
            # finish, queued groups are abandoned for the resume path)
            sched.shutdown()
        elastic_stats = sched.stats()
    else:
        # 2-stage pipeline: host LP assembly of group i overlaps the
        # device solve of groups < i.  Stacking + the host->device upload
        # are STAGED on this thread at submit time (pinned, non_blocking),
        # the workers hold only the solve and its status readbacks, and
        # results scatter on THIS thread (apply_subgroup mutates per-case
        # state).  In-flight work is bounded so peak LP memory stays a
        # few subgroups, not the whole sweep.  With several devices each
        # batch is split over all of them (solve_group), and ONE worker
        # runs those split solves: two at once would run two shard
        # threads on every device and interleave their chunks for no
        # gain; host assembly still overlaps the in-flight solve.
        import collections
        import concurrent.futures as cf
        max_inflight = _pipeline_depth(multi_dev)
        with cf.ThreadPoolExecutor(max_workers=max_inflight) as pool:
            futs = collections.deque()
            while groups:
                _, members = groups.popitem()
                for k, its in split_exact(members).items():
                    t0 = time.perf_counter()
                    staged = stage_group_data(
                        its, solver_opts, cache.device,
                        pad_to=_batch_pad_to(cache, len(its), multi_dev))
                    phase_acc["stage_s"] += time.perf_counter() - t0
                    futs.append(pool.submit(solve_only, k, its, staged))
                    while len(futs) > max_inflight:
                        items, result = futs.popleft().result()
                        scatter(items, result)
                        _batch_boundary()
            while futs:
                items, result = futs.popleft().result()
                scatter(items, result)
                _batch_boundary()

    # phase 2: degradation-coupled cases, stepped window-by-window with
    # the case axis batched at every step
    deg = [s for s in scenarios if s.opt_engine and s._degrading]
    while deg:
        ready = []
        for s in deg:
            item = s.next_degradation_item()
            if item is not None:
                ready.append((s,) + item)
        if not ready:
            break
        step_groups: Dict[tuple, list] = {}
        for s, key, ctx, lp in ready:
            step_groups.setdefault(key, []).append((s, ctx, lp))
        for key, items in step_groups.items():
            items = guard_items(items)
            if not items:
                continue
            t0 = time.perf_counter()
            xs, objs, ok, diags = resolve_group(items, backend, solver_opts,
                                                key=key, cache=cache,
                                                watchdog=watchdog,
                                                ledger=ledger_entries,
                                                board=breaker_board,
                                                policy=cert_policy)
            phase_acc["solve_s"] += time.perf_counter() - t0
            for (s, ctx, lp), x, o, k, dg in zip(items, xs, objs, ok, diags):
                s.apply_subgroup([(ctx, lp)], [x], [o], [k], [dg], backend)
                if s.quarantine is not None:
                    continue      # ladder exhausted: stop stepping the case
                s._replay_degradation(ctx)
                s._deg_pos += 1
            _batch_boundary()
        deg = [s for s in deg
               if s.quarantine is None and s._deg_pos < len(s._pending)]

    ledger = summarize_solve_ledger(ledger_entries, phase_acc["solve_s"],
                                    pipeline_on, max_inflight)
    if elastic_stats is not None:
        # per-device ledger slices: each device's group-entry walls must
        # account for its busy wall the same way the global entries
        # account for dispatch_solve_s (the accounted_fraction gate,
        # extended per device)
        for dstr, rec in elastic_stats["devices"].items():
            ent = [e for e in ledger["groups"]
                   if str(e.get("device")) == dstr]
            rec["solve_s"] = round(sum(float(e.get("solve_s", 0.0))
                                       for e in ent), 4)
            rec["accounted_fraction"] = (
                round(rec["solve_s"] / rec["busy_s"], 4)
                if rec["busy_s"] else None)
        ledger["elastic"] = elastic_stats
    # numerical-trust line items ride the ledger too: per-run certificate
    # counts + certification/shadow wall time next to the device-traffic
    # decomposition they taxed
    ledger["certification"] = certify.aggregate_certification(
        {i: getattr(s, "certification", None)
         for i, s in enumerate(scenarios)})
    if breaker_board is not None:
        # service resilience: the ladder breakers' post-dispatch states
        # ride the ledger so a tripped rung is visible next to the rung
        # entries it suppressed
        ledger["breakers"] = breaker_board.snapshot()
    shadow_got = ledger["certification"]["shadow"]["n"]
    if shadow_got < shadow_expected:
        # a sampled window ended quarantined (or its shadow re-solve
        # failed): say so rather than silently shipping a run with less
        # drift coverage than the policy promises
        TellUser.warning(
            f"shadow-solve coverage {shadow_got}/{shadow_expected}: "
            "sampled window(s) were lost to quarantine or shadow-solve "
            "failure this run")
    for s in scenarios:
        # observable for the solver cache: a degradation year must show
        # builds == distinct structures (typically 3 month lengths), not
        # builds == window steps
        # dispatch_ prefix: these are DISPATCH-GLOBAL totals recorded on
        # every case of a sweep, not per-case counts (ADVICE r4)
        s.solve_metadata["dispatch_solver_builds"] = cache.builds
        s.solve_metadata["dispatch_solver_hits"] = cache.hits
        s.solve_metadata["dispatch_assembly_s"] = round(
            phase_acc["assembly_s"], 3)
        s.solve_metadata["dispatch_solve_s"] = round(phase_acc["solve_s"], 3)
        s.solve_metadata["dispatch_stage_s"] = round(phase_acc["stage_s"], 3)
        s.solve_metadata["structure_groups_total"] = len(
            exact_keys_by_case.get(id(s), ()))
        s.solve_metadata["dispatch_groups_total"] = len(exact_keys_all)
        s.solve_metadata["solve_ledger"] = ledger
        s.finish_dispatch()


def _finish_dispatch_bookkeeping(scenarios, backend, checkpoint_dir) -> None:
    """Post-dispatch sweep bookkeeping: persist the resume manifest, then
    apply the case-isolation abort policy."""
    if checkpoint_dir:
        # the completed sweep's manifest marks every surviving case
        # ``done`` — the NEXT run with this checkpoint_dir reloads them
        # without re-dispatching — and keeps quarantined diagnoses
        from ..utils import supervisor as _sup
        _sup.write_manifest(checkpoint_dir, scenarios, backend)

    # case-level failure isolation: quarantined cases were dropped from
    # the sweep as they failed; the run as a whole aborts ONLY when no
    # case survived, with every case's diagnosis aggregated.  The gate
    # counts scenarios, not dict keys: caller-supplied case ids may
    # collide, and a collision must not suppress the abort or drop a
    # diagnosis from the aggregate.
    n_quarantined = sum(1 for s in scenarios if s.quarantine is not None)
    failures: Dict[Any, str] = {}
    for i, s in enumerate(scenarios):
        if s.quarantine is None:
            continue
        cid = s.case.case_id
        failures[cid if cid not in failures else f"{cid}#{i}"] = \
            s.quarantine["reason"]
    if n_quarantined and n_quarantined == len(scenarios):
        # total failure aborts before the caller's post-run reporting —
        # log the health report here so the audit trail still exists
        from ..io.summary import log_health_report, run_health_report
        log_health_report(run_health_report(
            {i: s.health for i, s in enumerate(scenarios)},
            {i: s.quarantine for i, s in enumerate(scenarios)}))
        raise AggregatedSolverError(failures)
    if n_quarantined:
        TellUser.warning(
            f"{n_quarantined} of {len(scenarios)} case(s) quarantined "
            f"(case ids {sorted(str(k) for k in failures)}); the "
            "remaining cases completed — see the run-health report")
