"""Electric-vehicle DERs.

Re-implements dervet/MicrogridDER/ElectricVehicles.py (SURVEY.md §2.4):

* ``ElectricVehicle1`` — single-EV charging: hour-of-day plug window,
  charge only while plugged, daily charge energy must reach ``ene_target``
  by plug-out (reference :194-297 forces SOE=0 at plug-in and SOE=target
  at plug-out; cumulative-charge rows express the same reachable set
  without an SOE variable).
* ``ElectricVehicle2`` — fleet baseline-load control: charging bounded
  between ``(1-max_load_ctrl)*baseline`` and ``baseline`` with lost-load
  cost on the shed energy (reference :495-544).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import scipy.sparse as sp

from ...ops.lp import LPBuilder, VarRef
from ...scenario.window import WindowContext
from ...utils.errors import TimeseriesDataError
from .base import DER


class ElectricVehicle1(DER):
    """Single-EV controlled charging."""

    technology_type = "Electric Vehicle"

    def __init__(self, keys: Dict, scenario: Dict, der_id: str = "",
                 datasets=None):
        super().__init__("ElectricVehicle1", der_id, keys, scenario)
        g = lambda k, d=0.0: float(keys.get(k, d) or 0.0)
        self.ch_max_rated = g("ch_max_rated")
        self.ch_min_rated = g("ch_min_rated")
        self.ene_target = g("ene_target")
        self.plugin_time = int(g("plugin_time"))
        self.plugout_time = int(g("plugout_time"))
        self.ccost = g("ccost")
        self.fixed_om = g("fixed_om")

    def _plugged_mask(self, index: pd.DatetimeIndex) -> np.ndarray:
        hours = index.hour.to_numpy()
        if self.plugin_time <= self.plugout_time:
            return (hours >= self.plugin_time) & (hours < self.plugout_time)
        return (hours >= self.plugin_time) | (hours < self.plugout_time)

    def build(self, b: LPBuilder, ctx: WindowContext) -> None:
        T, dt = ctx.T, ctx.dt
        plugged = self._plugged_mask(ctx.index)
        ub = np.where(plugged, self.ch_max_rated, 0.0)
        ch = b.var(self.vname("ch"), T, lb=0.0, ub=ub)
        # one charge-session row per plug-out boundary: energy delivered in
        # each plugged session == ene_target
        session = np.zeros(T, dtype=np.int64)
        sid = 0
        prev = False
        for t, p in enumerate(plugged):
            if p and not prev:
                sid += 1
            session[t] = sid if p else 0
            prev = p
        n_sessions = sid
        complete = []
        for s in range(1, n_sessions + 1):
            idx = np.nonzero(session == s)[0]
            # only enforce the target for sessions fully inside the window:
            # a session truncated by either window boundary (started before
            # the window or still plugged at its end) must not carry the
            # full-energy equality — it would over-constrain or go infeasible
            starts_at_boundary = idx[0] == 0 and plugged[0]
            ends_at_boundary = idx[-1] == T - 1 and plugged[-1]
            if not starts_at_boundary and not ends_at_boundary:
                complete.append(idx)
        if complete:
            rows_i = np.concatenate([np.full(len(ix), i)
                                     for i, ix in enumerate(complete)])
            cols_i = np.concatenate(complete)
            mat = sp.coo_matrix((np.full(len(cols_i), dt), (rows_i, cols_i)),
                                shape=(len(complete), T)).tocsr()
            b.add_rows(self.vname("session_energy"), [(ch, mat)], "eq",
                       np.full(len(complete), self.ene_target))

    def power_terms(self, b: LPBuilder) -> List[Tuple[VarRef, float]]:
        return [(b[self.vname("ch")], -1.0)]

    def market_headroom(self, b: LPBuilder, direction: str):
        """Up: cut charging down to ch_min; down: raise charging to rated
        (reference ElectricVehicles.py:151-176
        get_charge_up/down_schedule)."""
        ch = b[self.vname("ch")]
        if direction == "up":
            return [(ch, 1.0)], -self.ch_min_rated
        return [(ch, -1.0)], self.ch_max_rated

    def get_capex(self) -> float:
        return self.ccost

    def proforma_report(self, opt_years, apply_inflation_rate_func=None,
                        fill_forward_func=None):
        """Fixed O&M per analysis year (reference
        ElectricVehicles.py:321-348)."""
        uid = self.unique_tech_id
        return pd.DataFrame(
            {f"{uid} Fixed O&M Cost": {pd.Period(yr, freq="Y"): -self.fixed_om
                                       for yr in opt_years}})

    def load_series(self):
        v = self.variables_df
        return v["ch"].to_numpy() if v is not None and "ch" in v else None

    def timeseries_report(self) -> pd.DataFrame:
        """Charge/Power plus the implied SOE, BEGIN-of-step like the
        reference's ``ene`` variable (ElectricVehicles.py constraints:
        ene==0 at the plug-in step, ene[t] = ene[t-1] + dt*ch[t-1],
        ene==ene_target at the plug-out step; unplugged steps hold the
        last value)."""
        v = self.variables_df
        out = pd.DataFrame(index=v.index)
        ch = v["ch"].to_numpy()
        out[self.col("Charge (kW)")] = ch
        out[self.col("Power (kW)")] = -ch
        plugged = self._plugged_mask(v.index)
        soe = np.zeros(len(ch))
        acc = 0.0
        prev = False
        for t, p in enumerate(plugged):
            if p and not prev:
                acc = 0.0          # pinned to zero AT the plug-in step
            soe[t] = acc
            if p:
                acc += ch[t] * self.dt
            prev = p
        out[self.col("State of Energy (kWh)")] = soe
        out[self.col("Energy Option (kWh)")] = 0.0
        out[self.col("Charge Option (kW)")] = 0.0
        return out


class ElectricVehicle2(DER):
    """Fleet-EV baseline-load control."""

    technology_type = "Electric Vehicle"
    BASELINE_COL = "EV fleet"

    def __init__(self, keys: Dict, scenario: Dict, der_id: str = "",
                 datasets=None):
        super().__init__("ElectricVehicle2", der_id, keys, scenario)
        g = lambda k, d=0.0: float(keys.get(k, d) or 0.0)
        self.max_load_ctrl = g("max_load_ctrl") / 100.0
        self.lost_load_cost = g("lost_load_cost")
        self.ccost = g("ccost")
        self.fixed_om = g("fixed_om")
        # current window's baseline, stashed by build() for the POI's
        # market-headroom rows (built right after the DERs each window)
        self._cur_base: Optional[np.ndarray] = None
        self.datasets = datasets
        if datasets is None or datasets.time_series is None:
            raise TimeseriesDataError("ElectricVehicle2 requires a time series "
                                      "with an 'EV fleet' baseline column")

    def baseline(self, ctx: WindowContext) -> np.ndarray:
        arr = ctx.col(self.BASELINE_COL, self.id or "1")
        if arr is None:
            raise TimeseriesDataError("missing 'EV fleet' baseline column")
        return arr

    def build(self, b: LPBuilder, ctx: WindowContext) -> None:
        base = self.baseline(ctx)
        self._cur_base = base
        lb = (1.0 - self.max_load_ctrl) * base
        ch = b.var(self.vname("ch"), ctx.T, lb=lb, ub=base)
        # lost-load cost on shed baseline power: cost * sum(base - ch) —
        # the reference sums POWER, without a dt factor
        # (ElectricVehicles.py:495-513 objective_function); the constant
        # part goes to c0 for faithful objective reporting
        if self.lost_load_cost:
            b.add_cost(ch, -self.lost_load_cost,
                       label=f"{self.name} lost_load")
            b.add_const_cost(float(np.sum(base)) * self.lost_load_cost,
                             label=f"{self.name} lost_load")
        if self.fixed_om:
            # the reference's objective carries the fixed O&M constant per
            # window (ElectricVehicles.py:510)
            b.add_const_cost(self.fixed_om * ctx.annuity_scalar,
                             label=f"{self.name} fixed_om")

    def power_terms(self, b: LPBuilder) -> List[Tuple[VarRef, float]]:
        return [(b[self.vname("ch")], -1.0)]

    def market_headroom(self, b: LPBuilder, direction: str):
        """Up: shed down to (1-max_load_ctrl)*baseline; down: restore up
        to the baseline (reference ElectricVehicles.py:467-493)."""
        ch = b[self.vname("ch")]
        base = self._cur_base if self._cur_base is not None else 0.0
        if direction == "up":
            return [(ch, 1.0)], -(1.0 - self.max_load_ctrl) * base
        return [(ch, -1.0)], base

    def get_capex(self) -> float:
        return self.ccost

    def proforma_report(self, opt_years, apply_inflation_rate_func=None,
                        fill_forward_func=None):
        """Fixed O&M per analysis year (reference
        ElectricVehicles.py:562-589)."""
        uid = self.unique_tech_id
        return pd.DataFrame(
            {f"{uid} Fixed O&M Cost": {pd.Period(yr, freq="Y"): -self.fixed_om
                                       for yr in opt_years}})

    def load_series(self):
        v = self.variables_df
        return v["ch"].to_numpy() if v is not None and "ch" in v else None

    def timeseries_report(self) -> pd.DataFrame:
        v = self.variables_df
        out = pd.DataFrame(index=v.index)
        out[self.col("Charge (kW)")] = v["ch"]
        out[self.col("Power (kW)")] = -v["ch"]
        return out
