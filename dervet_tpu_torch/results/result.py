"""Results registry and per-case result collection.

Re-designs dervet/MicrogridResult.py + the storagevet Result surface
(SURVEY.md §2.7/§2.8): classmethod registry keyed by sensitivity case,
per-case collection of timeseries/technology-summary/sizing frames, CSV
output set with the reference's file names and column names (the golden
tests compare by column name).  The financial frames (pro_forma, npv,
payback, cost_benefit) are attached by the CBA layer.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from ..telemetry import trace as telemetry_trace
from ..utils.errors import TellUser


class Result:
    """Registry of per-case results for one DERVET run."""

    @classmethod
    def initialize(cls, cases) -> "Result":
        first = cases[min(cases.keys())]
        return cls(first.results, sensitivity_df=first.sensitivity_df)

    def __init__(self, results_keys: Dict, sensitivity_df=None):
        self.dir_abs_path = Path(results_keys.get("dir_absolute_path", "Results") or "Results")
        self.csv_label = str(results_keys.get("label", "") or "")
        if self.csv_label == "nan":
            self.csv_label = ""
        self.sensitivity_df = (sensitivity_df if sensitivity_df is not None
                               else pd.DataFrame())
        self.instances: Dict[int, CaseResult] = {}
        # run-health report (resilience layer), attached by api.solve:
        # per-window ladder counts + quarantined-case diagnoses
        self.run_health: Optional[Dict] = None
        # per-group solve ledger (perf observability), attached by
        # api.solve from the dispatch driver's solve_metadata
        self.solve_ledger: Optional[Dict] = None
        # serving layer: the request these results belong to — namespaces
        # the run artifacts (run_health.<rid>.json, solve_ledger.<rid>.json)
        # so concurrent requests sharing one process/output dir cannot
        # clobber each other; None (the single-run CLI path) keeps
        # today's filenames
        self.request_id: Optional[str] = None
        # serving layer: request wall-clock latency (submit -> result),
        # recorded by the service batcher
        self.request_latency_s: Optional[float] = None
        # serving layer: answer fidelity — "certified" is the normal
        # tier; "degraded" marks a load-shed screening answer (loose
        # tolerance, short budget, NO float64 certificate) that clients
        # should treat as an estimate and resubmit for a certified
        # answer (see resubmit_hint)
        self.fidelity: str = "certified"
        self.resubmit_hint: Optional[str] = None
        # per-phase seconds and the recorded spans of the solve() call
        # that built these results (telemetry.trace phases)
        self.phase_seconds: Dict[str, float] = {}
        self.trace: List[Dict] = []

    def build_instance(self, scenario, parent=None) -> "CaseResult":
        """Build (but do not register) one case's result frames — the
        pandas-heavy half of ``add_instance``, split out so the api layer
        can fan it out over a worker pool overlapped with the remaining
        dispatch solves (cases are independent; registration stays on the
        caller's thread, in case order).  ``parent`` is the phase the
        case's ``post_case`` phase records under (default: the calling
        thread's)."""
        with telemetry_trace.phase("post_case", "post_work_s", parent=parent,
                                   case=scenario.case.case_id):
            inst = CaseResult(scenario, self.csv_label)
            inst.collect_results()
            inst.calculate_cba()
        return inst

    def add_instance(self, key: int, scenario) -> "CaseResult":
        inst = self.build_instance(scenario)
        self.instances[key] = inst
        return inst

    def sensitivity_summary(self) -> Optional[pd.DataFrame]:
        if self.sensitivity_df.empty:
            return None
        df = self.sensitivity_df.copy()
        for key, inst in self.instances.items():
            if inst.npv_df is not None and "Lifetime Present Value" in inst.npv_df:
                df.loc[key, "Lifetime Net Present Value"] = \
                    inst.npv_df["Lifetime Present Value"].iloc[0]
        self.sensitivity_summary_df = df
        return df

    def save_as_csv(self, out_dir=None) -> None:
        from ..io.summary import run_artifact_name
        from ..utils.supervisor import atomic_output, atomic_write
        out = Path(out_dir or self.dir_abs_path)
        if self.run_health is not None:
            # persisted next to the output set so a large sweep's solver
            # degradations (retries, CPU fallbacks, quarantined cases) are
            # auditable after the run, not just scrollback; namespaced by
            # request id when these results came through the service
            import json
            atomic_write(out / run_artifact_name("run_health.json",
                                                 self.request_id),
                         json.dumps(self.run_health, indent=2))
        if self.request_id is not None and self.solve_ledger is not None:
            # service requests persist their solve-ledger slice too (the
            # single-run path publishes the ledger via bench/api instead,
            # keeping today's file set unchanged)
            import json
            atomic_write(out / run_artifact_name("solve_ledger.json",
                                                 self.request_id),
                         json.dumps(self.solve_ledger, indent=2))
        for key, inst in self.instances.items():
            label = f"{self.csv_label}{key}" if len(self.instances) > 1 else self.csv_label
            inst.save_as_csv(out, label)
        if len(self.instances) > 1:
            # one summary row per sensitivity case (reference:
            # storagevet.Result.sensitivity_summary written from
            # dervet/DERVET.py:85)
            df = getattr(self, "sensitivity_summary_df", None)
            if df is None:
                df = self.sensitivity_summary()
            if df is not None:
                with atomic_output(out / "sensitivity_summary.csv") as tmp:
                    df.to_csv(tmp, index_label="Case")


class CaseResult:
    """Per-case result frames (reference: MicrogridResult instance)."""

    def __init__(self, scenario, csv_label: str = ""):
        self.scenario = scenario
        self.csv_label = csv_label
        self.time_series_data: Optional[pd.DataFrame] = None
        self.technology_summary: Optional[pd.DataFrame] = None
        self.sizing_df: Optional[pd.DataFrame] = None
        self.monthly_data: Optional[pd.DataFrame] = None
        self.objective_values: Optional[pd.DataFrame] = None
        self.proforma_df: Optional[pd.DataFrame] = None
        self.npv_df: Optional[pd.DataFrame] = None
        self.payback_df: Optional[pd.DataFrame] = None
        self.cost_benefit_df: Optional[pd.DataFrame] = None
        self.drill_down_dict: Dict[str, pd.DataFrame] = {}
        # physical-invariant audit verdict (ops/certify.audit_case),
        # filled by collect_results and aggregated into run_health
        self.invariant_audit: Optional[Dict] = None

    # ------------------------------------------------------------------
    def collect_results(self) -> None:
        s = self.scenario
        self.time_series_data = s.timeseries_results()
        self.technology_summary = pd.DataFrame(
            [{"Type": d.technology_type, "Name": d.name} for d in s.ders])
        self.sizing_df = s.poi.sizing_summary()
        self.monthly_data = s.service_agg.monthly_report()
        if s.objective_values:
            # canonical window order, not round-insertion order: a
            # window dict entry lands when its structure GROUP finishes,
            # and a case whose remainder window rides a different-width
            # group than its main windows sees that order shift with
            # round composition (what else the serving layer co-batched
            # this round) — sorting keeps the CSV surface byte-stable
            # across single-run, coalesced, and fleet-failover serving
            self.objective_values = pd.DataFrame(
                s.objective_values).T.sort_index(kind="stable")
        self.drill_down_dict.update(
            s.service_agg.drill_down_dfs(self.time_series_data, s.dt))
        rel = s.streams.get("Reliability")
        if rel is not None:
            self.drill_down_dict.update(
                rel.drill_down_reports(s.ders, self.time_series_data))
        for der in s.ders:
            report = getattr(der, "degradation_report", lambda: None)()
            if report is not None:
                self.drill_down_dict[f"degradation_data_{der.name}"] = report
        self._dispatch_drill_downs()
        # physical-invariant audit over the assembled results (numerical
        # trust layer): a scrambled scatter or overlapped-post race shows
        # up here even when every per-window certificate passed.  Never
        # lets an audit bug break result collection — an audit failure is
        # a REPORT, the results themselves still ship.
        from ..ops import certify
        try:
            self.invariant_audit = certify.audit_case(
                s, self.time_series_data)
        except Exception as e:
            TellUser.warning(f"invariant audit errored: {e}")
            self.invariant_audit = {"ok": False, "error": str(e)}

    def _dispatch_drill_downs(self) -> None:
        """Hour x day pivots + peak-day summary (reference output set:
        peak_day_load / <name>_dispatch_map / energyp_map, SURVEY §2.7)."""
        ts = self.time_series_data
        if ts is None or not len(ts):
            return
        idx = ts.index

        def pivot(series: pd.Series) -> pd.DataFrame:
            # hour x day mean pivot via one bincount pass — pivot_table
            # cost ~12 ms per map, ~2 maps per case, the largest single
            # post-processing item of a 128-case sweep (VERDICT r5 #1)
            codes, uniq = pd.factorize(idx.normalize())
            hours = np.asarray(idx.hour)
            nd = len(uniq)
            key = hours * nd + codes
            vals_in = series.to_numpy(dtype=np.float64)
            valid = ~np.isnan(vals_in)       # pivot_table mean skips NaN
            tot = np.bincount(key[valid], weights=vals_in[valid],
                              minlength=24 * nd)
            cnt = np.bincount(key[valid], minlength=24 * nd)
            with np.errstate(invalid="ignore"):
                vals = (tot / np.where(cnt, cnt, np.nan)).reshape(24, nd)
            # pivot_table drops index AND column labels with no valid
            # values: mask all-NaN hours (rows) and all-NaN days (columns)
            counts = cnt.reshape(24, nd)
            present = counts.sum(axis=1) > 0
            day_present = counts.sum(axis=0) > 0
            return pd.DataFrame(
                vals[np.ix_(present, day_present)],
                index=pd.Index(np.arange(1, 25)[present], name="hour"),
                columns=pd.Index([d.date() for d in uniq[day_present]],
                                 name="day"))

        if "Total Load (kW)" in ts.columns:
            load = ts["Total Load (kW)"]
            peak_day = load.groupby(idx.date).max().idxmax()
            mask = np.asarray(idx.date == peak_day)
            self.drill_down_dict["peak_day_load"] = pd.DataFrame({
                "Timestep Beginning": np.arange(int(mask.sum()), dtype=float),
                "Date": [peak_day] * int(mask.sum()),
                "Load (kW)": load[mask].to_numpy(),
                "Net Load (kW)": ts.loc[mask, "Net Load (kW)"].to_numpy(),
            })
        s = self.scenario
        for der in s.ders:
            if der.technology_type == "Energy Storage System" and \
                    der.variables_df is not None:
                # golden es_dispatch_map convention: charging negative
                self.drill_down_dict[f"{der.name}_dispatch_map"] = \
                    pivot(der.variables_df["dis"] - der.variables_df["ch"])
        for col, name in (("Tariff Energy Price ($/kWh)", "energyp_map"),
                          ("DA Price ($/kWh)", "energyp_map")):
            if col in ts.columns and name not in self.drill_down_dict:
                self.drill_down_dict[name] = pivot(ts[col])

    def calculate_cba(self) -> None:
        from ..financial.cba import CostBenefitAnalysis
        s = self.scenario
        try:
            # "Evaluation" re-pricing: the CBA may value the SAME dispatch
            # with different financial inputs than the optimization used
            ders, streams, finance = s.evaluation_clones()
            cba = CostBenefitAnalysis(finance, s.start_year, s.end_year,
                                      s.opt_years, dt=s.dt,
                                      yearly=s.case.datasets.yearly)
        except Exception as e:  # financial inputs optional in early slices
            TellUser.warning(f"CBA skipped: {e}")
            return
        cba.calculate(ders, streams, self.time_series_data, s.opt_years,
                      poi=s.poi)
        self.proforma_df = cba.proforma
        self.npv_df = cba.npv
        self.payback_df = cba.payback
        self.cost_benefit_df = cba.cost_benefit
        self.equipment_lifetimes_df = cba.equipment_lifetime_report(s.ders)
        self.tax_breakdown_df = cba.tax_breakdown
        ecc = getattr(cba, "ecc_breakdown", None)
        self.ecc_breakdown_df = pd.DataFrame(ecc) if ecc else None

    # ------------------------------------------------------------------
    def save_as_csv(self, path: Path, label: str = "") -> None:
        from ..utils.supervisor import atomic_output
        path.mkdir(parents=True, exist_ok=True)

        def put(name, df, index=True, core=False):
            # the reference's output file SET is fixed: a core file with no
            # content is still written, as an empty CSV (e.g. the frozen
            # reliability-only results carry empty objective_values/
            # monthly_data/payback files)
            if df is None and core:
                df = pd.DataFrame()
            if df is not None:
                # tmp + fsync + replace: a kill mid-write leaves the
                # previous complete file, never a truncated CSV
                with atomic_output(path / f"{name}{label}.csv") as tmp:
                    df.to_csv(tmp, index=index)
        put("timeseries_results", self.time_series_data, core=True)
        put("technology_summary", self.technology_summary, index=False,
            core=True)
        put("size", self.sizing_df, core=True)
        put("monthly_data", self.monthly_data, core=True)
        put("objective_values", self.objective_values, core=True)
        put("pro_forma", self.proforma_df, core=True)
        put("npv", self.npv_df, index=False, core=True)
        put("payback", self.payback_df, index=False, core=True)
        put("cost_benefit", self.cost_benefit_df, core=True)
        put("equipment_lifetimes",
            getattr(self, "equipment_lifetimes_df", None), core=True)
        put("tax_breakdown", getattr(self, "tax_breakdown_df", None))
        put("ecc_breakdown", getattr(self, "ecc_breakdown_df", None))
        for name, df in self.drill_down_dict.items():
            put(name, df)
        TellUser.info(f"results saved to {path}")
