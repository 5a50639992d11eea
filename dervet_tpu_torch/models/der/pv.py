"""PV / intermittent renewable resource.

Re-implements dervet/MicrogridDER/IntermittentResourceSizing.py:70-91 +
the storagevet PVSystem surface (SURVEY.md §2.4/§2.8): generation is a
per-rated-kW profile times rated capacity; with ``curtail`` the dispatched
output is a variable bounded above by that profile, otherwise it is a
fixed injection.  Reliability credit factors ``nu``/``gamma`` and PPA
pricing ride along for the reliability/financial layers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from ...ops.lp import LPBuilder, VarRef
from ...scenario.window import WindowContext
from ...utils.errors import TimeseriesDataError
from .base import DER

GEN_COL = "PV Gen (kW/rated kW)"


class PV(DER):

    technology_type = "Intermittent Resource"

    def __init__(self, keys: Dict, scenario: Dict, der_id: str = "",
                 datasets=None):
        super().__init__("PV", der_id, keys, scenario)
        g = lambda k, d=0.0: float(keys.get(k, d) or 0.0)
        self.rated_capacity = g("rated_capacity")
        self.curtail = bool(keys.get("curtail", False))
        self.grid_charge = bool(keys.get("grid_charge", True))
        self.inv_max = g("inv_max", 1e9)
        self.nu = g("nu") / 100.0          # % of PV credited in power balance
        self.gamma = g("gamma") / 100.0    # % of PV credited in energy
        self.cost_per_kw = g("ccost_kW")
        self.fixed_om_per_kw = g("fixed_om_cost")
        self.ppa = bool(keys.get("PPA", False))
        self.ppa_cost = g("PPA_cost")      # $/kWh production payment
        self.ppa_inflation = g("PPA_inflation_rate") / 100.0
        self.growth = g("growth") / 100.0
        if datasets is None or datasets.time_series is None:
            raise TimeseriesDataError("PV requires a time series with "
                                      f"{GEN_COL!r}")
        from ...scenario.window import grab_column
        if grab_column(datasets.time_series, GEN_COL, self.id) is None:
            raise TimeseriesDataError(f"PV: missing column {GEN_COL!r}")
        self.datasets = datasets

    def max_generation(self, ctx: WindowContext) -> np.ndarray:
        profile = ctx.col(GEN_COL, self.id)
        return profile * self.rated_capacity

    def maximum_generation_series(self, index: pd.DatetimeIndex) -> np.ndarray:
        """Full-horizon nameplate generation (reference: PVSystem
        ``maximum_generation()``, used by the reliability walk)."""
        from ...scenario.window import grab_column
        profile = grab_column(self.datasets.time_series.loc[index],
                              GEN_COL, self.id)
        return profile * self.rated_capacity

    _size_frozen = False

    def being_sized(self) -> bool:
        return self.rated_capacity == 0 and not self._size_frozen

    def set_size(self, sizes) -> None:
        if "size" in sizes:
            from .base import integer_size
            self.size_continuous = {"size": float(sizes["size"])}
            hi = float(self.keys.get("max_rated_capacity", 0) or 0.0)
            self.rated_capacity = integer_size(float(sizes["size"]), hi)
            self._size_frozen = True

    def build(self, b: LPBuilder, ctx: WindowContext) -> None:
        if self.being_sized():
            # rated capacity as a scalar LP variable: gen tied to
            # profile * size (reference: IntermittentResourceSizing.py:70-91,
            # continuous relaxation of the integer capacity)
            g = lambda k, d=0.0: float(self.keys.get(k, d) or 0.0)
            lo, hi = g("min_rated_capacity"), g("max_rated_capacity")
            size = b.var(self.vname("size"), 1, lb=max(lo, 0.0),
                         ub=hi if hi > 0 else np.inf)
            gen = b.var(self.vname("gen"), ctx.T, lb=0.0)
            profile = np.asarray(ctx.col(GEN_COL, self.id))[:, None]
            sense = "le" if self.curtail else "eq"
            b.add_rows(self.vname("gen_cap"),
                       [(gen, 1.0), (size, -profile)], sense, 0.0)
            b.add_cost(size, self.cost_per_kw, label=f"{self.name}capex")
            # no fixed-O&M on the sized rating (reference artifact — see
            # the equivalent note in ess.py)
            return
        gen_max = np.minimum(self.max_generation(ctx), self.inv_max)
        if self.curtail:
            b.var(self.vname("gen"), ctx.T, lb=0.0, ub=gen_max)
        else:
            b.var(self.vname("gen"), ctx.T, lb=gen_max, ub=gen_max)
        # PPA payments are on MAXIMUM (available) production, so they are
        # sunk w.r.t. dispatch and appear only in the proforma
        # (reference IntermittentResourceSizing.proforma_report:262-293)
        if self.fixed_om_per_kw:
            b.add_const_cost(self.fixed_om_per_kw * self.rated_capacity
                             * ctx.annuity_scalar * (ctx.T * ctx.dt) / 8760.0,
                             label=f"{self.name} fixed_om")

    def power_terms(self, b: LPBuilder) -> List[Tuple[VarRef, float]]:
        return [(b[self.vname("gen")], +1.0)]

    def generation_series(self):
        v = self.variables_df
        return v["gen"].to_numpy() if v is not None and "gen" in v else None

    def timeseries_report(self) -> pd.DataFrame:
        v = self.variables_df
        out = pd.DataFrame(index=v.index)
        out[self.col("Electric Generation (kW)")] = v["gen"]
        return out

    def get_capex(self) -> float:
        return self.cost_per_kw * self.rated_capacity

    def owns_asset(self) -> bool:
        """Under a PPA the host does not own the panels: no MACRS, no
        replacement, no decommissioning, no salvage (reference
        IntermittentResourceSizing.py:295-316 returns empties)."""
        return not self.ppa

    def proforma_growth_rates(self) -> Dict[str, float]:
        if self.ppa:
            return {f"{self.unique_tech_id} PPA": self.ppa_inflation}
        return {}

    def proforma_report(self, opt_years, apply_inflation_rate_func=None,
                        fill_forward_func=None):
        """PPA: pay for each year's MAXIMUM (available) production at the
        PPA price, escalated at the PPA inflation rate from the first
        analysis year; otherwise the usual fixed O&M (reference
        IntermittentResourceSizing.proforma_report:262-293)."""
        uid = self.unique_tech_id
        if not self.ppa:
            if not self.fixed_om_per_kw:
                return None
            fixed = -self.fixed_om_per_kw * self.rated_capacity
            return pd.DataFrame(
                {f"{uid} Fixed O&M Cost": {pd.Period(yr, freq="Y"): fixed
                                           for yr in opt_years}})
        base = min(opt_years)
        rows = {}
        for yr in opt_years:
            idx = self.datasets.time_series.index
            year_idx = idx[idx.year == yr]
            annual = float(self.maximum_generation_series(year_idx).sum()) \
                * self.dt
            rows[pd.Period(yr, freq="Y")] = \
                -annual * self.ppa_cost * (1 + self.ppa_inflation) ** (yr - base)
        return pd.DataFrame({f"{uid} PPA": rows})

    def replacement_cost(self) -> float:
        g = lambda k: float(self.keys.get(k, 0) or 0)
        return g("rcost") + g("rcost_kW") * self.rated_capacity

    def sizing_summary(self) -> Dict:
        return {
            "DER": self.name,
            "Power Capacity (kW)": self.rated_capacity,
            "Capital Cost ($/kW)": self.cost_per_kw,
        }
