"""Point of interconnection: power balance, import/export limits, reports.

Re-designs dervet/MicrogridPOI.py (reference :149-258 aggregates per-DER
CVXPY expressions and posts interconnection constraints; :266-323 merges
per-DER reports into Total columns).  Here the POI contributes constraint
*rows over the union of DER variable blocks* — net power at the POI is a
linear expression over every DER's power variables plus fixed loads, never
a separate decision variable.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from ..models.der.base import DER
from ..models.streams.base import SystemRequirement
from ..ops.lp import LPBuilder
from ..utils.errors import ParameterError, TellUser
from .window import WindowContext


class POI:
    """Owns the DER list; assembles POI-level rows per window."""

    def __init__(self, scenario_keys: Dict, der_list: List[DER]):
        self.scenario = scenario_keys
        self.der_list = der_list
        self.active_ders: List[DER] = list(der_list)
        self.apply_poi_constraints = bool(
            scenario_keys.get("apply_interconnection_constraints", False))
        self.max_export = float(scenario_keys.get("max_export", 0) or 0)
        self.max_import = float(scenario_keys.get("max_import", 0) or 0)
        self.incl_site_load = bool(scenario_keys.get("incl_site_load", False))
        self.use_slack = bool(scenario_keys.get("slack", False))
        if self.apply_poi_constraints and self.max_import > 0:
            raise ParameterError(
                f"max_import must be <= 0 (import is negative net export), "
                f"got {self.max_import}")
        self.is_sizing_optimization = any(d.being_sized() for d in der_list)

    # ------------------------------------------------------------------
    def grab_active_ders(self, year: int) -> None:
        self.active_ders = [d for d in self.der_list if d.operational(year)]

    def _owns_site_load(self) -> bool:
        """A ControllableLoad DER owns the 'Site Load (kW)' column; when one
        is active the POI must not add the column again (reference: the Load
        technology IS the site load, LoadControllable.py:253-260)."""
        return any(d.technology_type == "Load" for d in self.active_ders)

    def site_load(self, ctx: WindowContext) -> np.ndarray:
        """Total constant load in the window: site load + DER fixed loads."""
        load = np.zeros(ctx.T)
        if self.incl_site_load and not self._owns_site_load():
            site = ctx.col("Site Load (kW)")
            if site is not None:
                load += site
        for der in self.active_ders:
            fixed = der.fixed_load(ctx)
            if fixed is not None:
                load += fixed
        return load

    def net_export_terms(self, b: LPBuilder):
        terms = []
        for der in self.active_ders:
            terms.extend(der.power_terms(b))
        return terms

    # ------------------------------------------------------------------
    def build(self, b: LPBuilder, ctx: WindowContext,
              requirements: List[SystemRequirement]) -> None:
        terms = self.net_export_terms(b)
        load = self.site_load(ctx)

        if self.apply_poi_constraints and terms:
            coef_terms = [(ref, np.full(ctx.T, sign)) for ref, sign in terms]
            # net_export = sum(sign*var) - load;  max_import <= net <= max_export
            b.add_rows("poi_export", coef_terms, "le", self.max_export + load)
            b.add_rows("poi_import", coef_terms, "ge", self.max_import + load)

        self._grid_charge_rows(b, ctx)
        self._thermal_rows(b, ctx)
        self._requirement_rows(b, ctx, requirements)
        self._market_rows(b, ctx)

    def _thermal_rows(self, b: LPBuilder, ctx: WindowContext) -> None:
        """Steam / hot-water balance: recovered heat must cover the site
        thermal loads (reference MicrogridPOI.py:215-258; load columns per
        DERVETParams.py:597-633, a missing component defaults to zero)."""
        if not self.scenario.get("incl_thermal_load", False):
            return
        chps = [d for d in self.active_ders if hasattr(d, "steam_term")]
        if not chps:
            if any(hasattr(d, "steam_term") for d in self.der_list):
                TellUser.warning(
                    "incl_thermal_load is set but no heat-producing DER is "
                    "active this window — the site thermal load is unserved")
            return
        steam_load = ctx.col("Site Steam Thermal Load (BTU/hr)")
        hotwater_load = ctx.col("Site Hot Water Thermal Load (BTU/hr)")
        if steam_load is None and hotwater_load is None:
            raise ParameterError(
                "CHP with incl_thermal_load requires 'Site Steam Thermal "
                "Load (BTU/hr)' and/or 'Site Hot Water Thermal Load "
                "(BTU/hr)' in the time series")
        if steam_load is not None:
            b.add_rows("thermal_steam",
                       [(d.steam_term(b), 1.0) for d in chps], "ge",
                       steam_load)
        if hotwater_load is not None:
            b.add_rows("thermal_hotwater",
                       [(d.hotwater_term(b), 1.0) for d in chps], "ge",
                       hotwater_load)

    def _market_rows(self, b: LPBuilder, ctx: WindowContext) -> None:
        """Joint market-service rows: all services share DER headroom, and
        storage reserves ``duration`` hours of SOE per awarded kW
        (reference: co-optimized up/down schedules + qualifying energy,
        SURVEY.md §2.8 ValueStreams / EnergyStorage schedules)."""
        bids = ctx.market_bids
        if not bids:
            return

        def expand(terms):
            """Scalar coefs on size-1 blocks become (T, 1) columns so they
            broadcast across the row block (size variables in sizing runs)."""
            out = []
            for ref, coef in terms:
                if ref.size == 1 and np.isscalar(coef):
                    coef = np.full((ctx.T, 1), float(coef))
                out.append((ref, coef))
            return out

        for direction, bid_list in bids.items():
            terms = [(ref, 1.0) for ref, _ in bid_list]
            const = 0.0
            for d in self.active_ders:
                der_terms, c = d.market_headroom(b, direction)
                terms.extend((r, -coef) for r, coef in der_terms)
                const += c
            b.add_rows(f"market_headroom_{direction}", expand(terms), "le",
                       const)
        ess = [d for d in self.active_ders
               if d.technology_type == "Energy Storage System"]
        if ess:
            soe_terms = [(d.soe_term(b), 1.0) for d in ess]
            e_min = e_max = 0.0
            min_extra, max_extra = [], []
            for d in ess:
                if getattr(d, "sizing_ene", False) and \
                        b.has(d.vname("size_ene")):
                    ref = b[d.vname("size_ene")]
                    min_extra.append((ref, -d.llsoc * d.soh))
                    max_extra.append((ref, -d.ulsoc * d.soh))
                else:
                    e_min += d.operational_min_energy()
                    e_max += d.operational_max_energy()
            up = [(ref, -dur) for ref, dur in bids.get("up", []) if dur]
            if up:
                b.add_rows("market_soe_up",
                           expand(soe_terms + min_extra + up), "ge", e_min)
            down = [(ref, dur) for ref, dur in bids.get("down", []) if dur]
            if down:
                b.add_rows("market_soe_down",
                           expand(soe_terms + max_extra + down), "le", e_max)

    def _grid_charge_rows(self, b: LPBuilder, ctx: WindowContext) -> None:
        """PV grid_charge=0: storage may only charge from PV output —
        sum(ESS charge) <= sum(PV generation) per timestep (reference:
        storagevet PV grid-charge constraint surface)."""
        no_grid_pv = [d for d in self.active_ders
                      if getattr(d, "grid_charge", True) is False]
        if not no_grid_pv:
            return
        ess_ch = [b[d.vname("ch")] for d in self.active_ders
                  if d.technology_type == "Energy Storage System"]
        if not ess_ch:
            return
        pv_gen = [b[d.vname("gen")] for d in no_grid_pv]
        terms = [(r, 1.0) for r in ess_ch] + [(r, -1.0) for r in pv_gen]
        b.add_rows("grid_charge", terms, "le", 0.0)

    def _requirement_rows(self, b: LPBuilder, ctx: WindowContext,
                          requirements: List[SystemRequirement]) -> None:
        """Aggregate energy/charge/discharge min/max profiles (reference:
        system requirements from storagevet.SystemRequirement applied in the
        scenario's optimization assembly)."""
        # merge same (kind, sense) requirements: max of mins, min of maxes
        merged: Dict[tuple, np.ndarray] = {}
        for req in requirements:
            arr = req.window_array(ctx.index)
            key = (req.kind, req.sense)
            if key in merged:
                merged[key] = (np.maximum(merged[key], arr) if req.sense == "min"
                               else np.minimum(merged[key], arr))
            else:
                merged[key] = arr
        for (kind, sense), arr in merged.items():
            if not np.isfinite(arr).any():
                continue
            # non-finite gaps become non-binding: a 'min' gap is 0 for
            # nonneg quantities but -inf for signed net export
            lo_fill = -1e30 if kind == "poi export" else 0.0
            arr = np.where(np.isfinite(arr), arr, lo_fill if sense == "min" else 1e30)
            if kind == "energy":
                refs = [d.soe_term(b) for d in self.active_ders]
                terms = [(r, 1.0) for r in refs if r is not None]
            elif kind in ("charge", "discharge"):
                terms = []
                for d in self.active_ders:
                    for ref, sign in d.power_terms(b):
                        want = -1.0 if kind == "charge" else 1.0
                        if sign == want:
                            terms.append((ref, 1.0))
            elif kind == "poi export":
                # net export = sum(sign*var) - fixed load:
                # min arr -> sum(sign*var) >= arr + load (ge), max -> le
                load = ctx.fixed_load if ctx.fixed_load is not None else 0.0
                terms = [(ref, np.full(ctx.T, sign))
                         for d in self.active_ders
                         for ref, sign in d.power_terms(b)]
                arr = arr + np.asarray(load)
            else:
                continue
            if not terms:
                TellUser.warning(f"system requirement {kind}/{sense} has no "
                                 "contributing DERs — skipped")
                continue
            # Scenario.slack=1 turns the energy/charge/discharge system
            # requirements into SOFT constraints: a nonnegative violation
            # variable enters the row and the objective at the kappa_*
            # penalty (reference: the storagevet Scenario slack surface —
            # kappa_ene/ch/dis_max/min keys, SURVEY §2.2 key list)
            kappa_key = {"energy": "ene", "charge": "ch",
                         "discharge": "dis"}.get(kind)
            if self.use_slack and kappa_key is not None:
                raw = self.scenario.get(f"kappa_{kappa_key}_{sense}")
                # template default 100000; an explicit 0 means free slack
                kappa = 1e5 if raw is None else float(raw)
                sv = b.var(f"poi/slack_{kind}_{sense}", ctx.T,
                           lb=0.0, ub=np.inf)
                terms = terms + [(sv, 1.0 if sense == "min" else -1.0)]
                b.add_cost(sv, kappa * ctx.annuity_scalar, label="Slack")
            b.add_rows(f"sysreq_{kind}_{sense}", terms,
                       "ge" if sense == "min" else "le", arr)

    # ------------------------------------------------------------------
    def merge_reports(self, index: pd.DatetimeIndex,
                      ts_data: Optional[pd.DataFrame]) -> pd.DataFrame:
        """Totals frame (reference: MicrogridPOI.merge_reports columns)."""
        out = pd.DataFrame(index=index)
        gen = np.zeros(len(index))
        load = np.zeros(len(index))
        storage = np.zeros(len(index))
        original = np.zeros(len(index))
        owns = any(d.technology_type == "Load" for d in self.der_list)
        if self.incl_site_load and not owns and ts_data is not None:
            from .window import grab_column
            site = grab_column(ts_data.loc[index], "Site Load (kW)")
            if site is not None:
                load += site
                original += site
        for der in self.der_list:
            v = der.variables_df
            if der.technology_type == "Energy Storage System" and v is not None:
                storage += (v["dis"] - v["ch"]).to_numpy()
            g = der.generation_series()
            if g is not None:
                gen += np.asarray(g)
            l = der.load_series()
            if l is not None:
                load += np.asarray(l)
            orig = getattr(der, "original_load", None)
            if orig is not None:
                original += np.asarray(orig)
        out["Total Generation (kW)"] = gen
        out["Total Load (kW)"] = load
        out["Total Original Load (kW)"] = original
        out["Total Storage Power (kW)"] = storage
        out["Net Load (kW)"] = load - gen - storage
        agg_soe = np.zeros(len(index))
        any_soe = False
        for der in self.der_list:
            v = der.variables_df
            if v is not None and "ene" in v:
                agg_soe += v["ene"].to_numpy()
                any_soe = True
        if any_soe:
            out["Aggregated State of Energy (kWh)"] = agg_soe
        return out

    def sizing_summary(self) -> pd.DataFrame:
        rows = [d.sizing_summary() for d in self.der_list]
        rows = [r for r in rows if r]
        df = pd.DataFrame(rows)
        if "DER" in df.columns:
            df = df.set_index("DER")
        return df
