"""Dispatchable rotating generators: ICE, DieselGenset, CT, CHP.

Re-implements the behavior of dervet/MicrogridDER/
RotatingGeneratorSizing.py + ICE.py + DieselGenset.py +
CombustionTurbine.py + CombinedHeatPower.py (SURVEY.md §2.4) on the
storagevet RotatingGenerator surface: electric output ``elec`` per
timestep bounded by ``n * rated_capacity``; fuel + variable O&M costs in
the objective.  With scenario ``binary=1`` the on/off + min-power
formulation is exact: a per-step binary indicator (solved on the CPU
MILP backend) enforces ``elec ∈ {0} ∪ [min_power, rated]``; without it
min_power relaxes to 0 with a warning (the reference itself forbids
binary+sizing, MicrogridPOI.py:132-147).

CHP adds recovered-heat variables (steam / hot water) tied to electric
output; the POI consumes them in the thermal balance.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from ...ops.lp import LPBuilder, VarRef
from ...scenario.window import WindowContext
from ...utils.errors import TellUser
from .base import DER

GAS_PRICE_COL = "Natural Gas Price ($/MillionBTU)"


class RotatingGenerator(DER):
    """Base dispatchable generator (storagevet RotatingGenerator surface)."""

    technology_type = "Generator"

    def __init__(self, tag: str, keys: Dict, scenario: Dict, der_id: str = ""):
        super().__init__(tag, der_id, keys, scenario)
        g = lambda k, d=0.0: float(keys.get(k, d) or 0.0)
        self.rated_power = g("rated_capacity")
        self.n_units = max(int(keys.get("n", 1) or 1), 1)
        self.min_power = g("min_power")
        self.variable_om = g("variable_om_cost")      # $/kWh
        self.fixed_om_per_kw = g("fixed_om_cost")     # $/kW-yr
        self.ccost = g("ccost")
        self.ccost_kw = g("ccost_kW")
        self.incl_binary = bool(scenario.get("binary", False))
        if self.min_power and not self.incl_binary:
            TellUser.warning(f"{self.name}: min_power needs the binary "
                             "formulation; relaxed to 0 in the LP")

    @property
    def max_power_out(self) -> float:
        return self.n_units * self.rated_power

    # fuel $/kWh for one window (constant or monthly-priced)
    def fuel_cost_per_kwh(self, ctx: WindowContext) -> float:
        return 0.0

    _size_frozen = False

    def being_sized(self) -> bool:
        return self.rated_power == 0 and not self._size_frozen

    def set_size(self, sizes) -> None:
        if "size" in sizes:
            from .base import integer_size
            self.size_continuous = {"size": float(sizes["size"])}
            hi = float(self.keys.get("max_rated_capacity", 0) or 0.0)
            self.rated_power = integer_size(float(sizes["size"]), hi)
            self._size_frozen = True

    def build(self, b: LPBuilder, ctx: WindowContext) -> None:
        cost = (self.variable_om + self.fuel_cost_per_kwh(ctx)) * ctx.dt
        if self.being_sized():
            # rated power as a scalar LP variable, n units fixed (reference:
            # RotatingGeneratorSizing.py:60-66,110-136, LP relaxation)
            g = lambda k, d=0.0: float(self.keys.get(k, d) or 0.0)
            lo, hi = g("min_rated_capacity"), g("max_rated_capacity")
            size = b.var(self.vname("size"), 1, lb=max(lo, 0.0),
                         ub=hi if hi > 0 else np.inf)
            elec = b.var(self.vname("elec"), ctx.T, lb=0.0)
            b.add_rows(self.vname("elec_cap"),
                       [(elec, 1.0),
                        (size, -self.n_units * np.ones((ctx.T, 1)))],
                       "le", 0.0)
            b.add_cost(size, self.ccost_kw * self.n_units,
                       label=f"{self.name}capex")
            if self.ccost:
                b.add_const_cost(self.ccost, label=f"{self.name}capex")
            # no fixed-O&M on the sized rating (reference artifact — see
            # the equivalent note in ess.py)
            if cost:
                b.add_cost(elec, cost * ctx.annuity_scalar,
                           label=f"{self.name} fuel_and_om")
            return
        elec = b.var(self.vname("elec"), ctx.T, lb=0.0, ub=self.max_power_out)
        if self.incl_binary and self.min_power:
            # unit-commitment formulation (reference RotatingGenerator
            # on/off variables behind CVXPY+GLPK_MI): an INTEGER count of
            # committed units per step bounds the fleet output to
            # [min_power, rated_capacity] PER COMMITTED UNIT, so the
            # feasible aggregate is {0} ∪ [min, rated] ∪ [2min, 2rated]…;
            # the LP IR marks the block integral and the scenario routes
            # such windows to the exact CPU MILP backend
            n_on = b.var(self.vname("on"), ctx.T, lb=0.0,
                         ub=float(self.n_units), integer=True)
            b.add_rows(self.vname("bin_cap"),
                       [(n_on, self.rated_power), (elec, -1.0)], "ge", 0.0)
            b.add_rows(self.vname("bin_min"),
                       [(elec, 1.0), (n_on, -self.min_power)], "ge", 0.0)
        if cost:
            b.add_cost(elec, cost * ctx.annuity_scalar,
                       label=f"{self.name} fuel_and_om")
        if self.fixed_om_per_kw:
            b.add_const_cost(self.fixed_om_per_kw * self.max_power_out
                             * ctx.annuity_scalar * (ctx.T * ctx.dt) / 8760.0,
                             label=f"{self.name} fixed_om")

    def power_terms(self, b: LPBuilder) -> List[Tuple[VarRef, float]]:
        return [(b[self.vname("elec")], +1.0)]

    market_participation = True

    def market_headroom(self, b: LPBuilder, direction: str):
        """Up: raise output to nameplate; down: cut output to zero (LP
        relaxation of min_power; reference: RotatingGeneratorSizing.py
        schedules).  DieselGenset overrides participation off.  While the
        rating is being sized, its size variable supplies the nameplate."""
        if not self.market_participation:
            return [], 0.0
        elec = b[self.vname("elec")]
        if direction == "up":
            terms, const = [(elec, -1.0)], self.max_power_out
            if self.being_sized() and b.has(self.vname("size")):
                terms.append((b[self.vname("size")], float(self.n_units)))
                const = 0.0
            return terms, const
        return [(elec, 1.0)], 0.0

    def generation_series(self):
        v = self.variables_df
        return v["elec"].to_numpy() if v is not None and "elec" in v else None

    def timeseries_report(self) -> pd.DataFrame:
        v = self.variables_df
        out = pd.DataFrame(index=v.index)
        out[self.col("Electric Generation (kW)")] = v["elec"]
        return out

    def get_capex(self) -> float:
        return self.ccost + self.ccost_kw * self.max_power_out

    def replacement_cost(self) -> float:
        g = lambda k: float(self.keys.get(k, 0) or 0)
        return g("rcost") + g("rcost_kW") * self.max_power_out

    #: proforma fuel column suffix (reference test assertions fix
    #: 'ICE: <name> Diesel Fuel Costs'; generic generators use 'Fuel Costs')
    fuel_col = "Fuel Costs"

    def proforma_report(self, opt_years, apply_inflation_rate_func=None,
                        fill_forward_func=None):
        """Fixed O&M + variable O&M + fuel cost rows (reference:
        CombustionTurbine.py:122-152 fuel rows; storagevet generator O&M;
        column names per test_cba.py assertions)."""
        uid = self.unique_tech_id
        rows = {}
        v = self.variables_df
        for yr in opt_years:
            per = pd.Period(yr, freq="Y")
            row = {f"{uid} Fixed O&M Cost":
                   -self.fixed_om_per_kw * self.max_power_out}
            gen_kwh = 0.0
            if v is not None and "elec" in v:
                mask = v.index.year == yr
                gen_kwh = self.dt * float(v.loc[mask, "elec"].sum())
            row[f"{uid} Variable O&M Costs"] = -self.variable_om * gen_kwh
            fuel = self._yearly_fuel_cost(yr, gen_kwh)
            if fuel is not None:
                row[f"{uid} {self.fuel_col}"] = fuel
            rows[per] = row
        return pd.DataFrame(rows).T

    def _yearly_fuel_cost(self, year: int, gen_kwh: float):
        return None

    def sizing_summary(self) -> Dict:
        # Power Capacity is PER UNIT (golden size CSV: ice gen 750 kW x
        # Quantity 2)
        return {
            "DER": self.name,
            "Power Capacity (kW)": self.rated_power,
            "Capital Cost ($)": self.ccost,
            "Capital Cost ($/kW)": self.ccost_kw,
            "Quantity": self.n_units,
        }


class ICE(RotatingGenerator):
    """Internal-combustion engine: liquid fuel priced per gallon
    (reference: MicrogridDER/ICE.py:84-95; efficiency in gal/kWh)."""

    fuel_col = "Diesel Fuel Costs"

    def __init__(self, keys: Dict, scenario: Dict, der_id: str = "",
                 datasets=None):
        super().__init__(keys.get("__tag__", "ICE"), keys, scenario, der_id)
        self.efficiency = float(keys.get("efficiency", 0) or 0)   # gal/kWh
        self.fuel_cost = float(keys.get("fuel_cost", 0) or 0)     # $/gal

    def fuel_cost_per_kwh(self, ctx: WindowContext) -> float:
        return self.efficiency * self.fuel_cost

    def _yearly_fuel_cost(self, year: int, gen_kwh: float):
        return -self.efficiency * self.fuel_cost * gen_kwh


class DieselGenset(ICE):
    """ICE barred from market participation (reference:
    MicrogridDER/DieselGenset.py:54-92 zeroes its up/down schedules)."""

    def __init__(self, keys: Dict, scenario: Dict, der_id: str = "",
                 datasets=None):
        keys = dict(keys)
        keys["__tag__"] = "DieselGenset"
        super().__init__(keys, scenario, der_id, datasets)

    market_participation = False


class CT(RotatingGenerator):
    """Combustion turbine: natural-gas fuel via heat rate x monthly gas
    price (reference: MicrogridDER/CombustionTurbine.py:79-88)."""

    def __init__(self, keys: Dict, scenario: Dict, der_id: str = "",
                 datasets=None, tag: str = "CT"):
        super().__init__(tag, keys, scenario, der_id)
        self.heat_rate = float(keys.get("heat_rate", 0) or 0)  # BTU/kWh
        self.datasets = datasets

    def fuel_cost_per_kwh(self, ctx: WindowContext) -> float:
        price = ctx.monthly_value(GAS_PRICE_COL, default=0.0) or 0.0
        return self.heat_rate / 1e6 * price   # BTU/kWh * $/MMBTU

    def _yearly_fuel_cost(self, year: int, gen_kwh: float):
        v = self.variables_df
        monthly = getattr(self.datasets, "monthly", None) if self.datasets else None
        if v is None or "elec" not in v or monthly is None:
            return None
        total = 0.0
        mask_year = v.index.year == year
        for month in range(1, 13):
            mask = mask_year & (v.index.month == month)
            if not mask.any():
                continue
            kwh = self.dt * float(v.loc[mask, "elec"].sum())
            try:
                price = float(monthly.loc[(year, month), GAS_PRICE_COL])
            except KeyError:
                price = 0.0
            total += self.heat_rate / 1e6 * price * kwh
        return -total


class CHP(CT):
    """Combined heat & power: recovered steam / hot-water tied to electric
    output (reference: MicrogridDER/CombinedHeatPower.py:77-107 —
    nonneg steam & hotwater, steam <= max_steam_ratio*hotwater,
    (steam+hotwater)*electric_heat_ratio == elec)."""

    def __init__(self, keys: Dict, scenario: Dict, der_id: str = "",
                 datasets=None):
        super().__init__(keys, scenario, der_id, datasets, tag="CHP")
        self.electric_heat_ratio = float(keys.get("electric_heat_ratio", 0) or 0)
        self.max_steam_ratio = float(keys.get("max_steam_ratio", 0) or 0)

    def build(self, b: LPBuilder, ctx: WindowContext) -> None:
        super().build(b, ctx)
        elec = b[self.vname("elec")]
        steam = b.var(self.vname("steam"), ctx.T, lb=0.0)
        hotwater = b.var(self.vname("hotwater"), ctx.T, lb=0.0)
        if self.max_steam_ratio:
            b.add_rows(self.vname("steam_ratio"),
                       [(steam, 1.0), (hotwater, -self.max_steam_ratio)],
                       "le", 0.0)
        if self.electric_heat_ratio:
            b.add_rows(self.vname("heat_recovery"),
                       [(steam, self.electric_heat_ratio),
                        (hotwater, self.electric_heat_ratio),
                        (elec, -1.0)], "eq", 0.0)

    # recovered heat for the POI thermal balance (BTU/hr scale handled there)
    def steam_term(self, b: LPBuilder) -> VarRef:
        return b[self.vname("steam")]

    def hotwater_term(self, b: LPBuilder) -> VarRef:
        return b[self.vname("hotwater")]

    def timeseries_report(self) -> pd.DataFrame:
        out = super().timeseries_report()
        v = self.variables_df
        if "steam" in v:
            out[self.col("Steam Heat Recovered (BTU/hr)")] = v["steam"]
            out[self.col("Hot Water Heat Recovered (BTU/hr)")] = v["hotwater"]
        return out
