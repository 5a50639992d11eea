"""Day-ahead energy time-shift value stream.

Re-implements the behavior of storagevet ``ValueStreams.DAEnergyTimeShift``
(SURVEY.md §2.8; wired at dervet/MicrogridScenario.py:89): the system pays
the day-ahead price for net power drawn from the grid and earns it for net
injection.  As LP blocks this is a pure cost vector: for every DER power
variable, ``-sign * price * dt`` (import costs, export earns), plus a
constant term for fixed loads.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import pandas as pd

from ...ops.lp import LPBuilder
from ...scenario.window import WindowContext, grab_column
from ...utils.errors import TimeseriesDataError
from .base import ValueStream

PRICE_COL = "DA Price ($/kWh)"


class DAEnergyTimeShift(ValueStream):

    def __init__(self, keys, scenario, datasets):
        super().__init__("DA", keys, scenario, datasets)
        self.growth = float(keys.get("growth", 0) or 0) / 100.0
        if datasets.time_series is None or \
                grab_column(datasets.time_series, PRICE_COL) is None:
            raise TimeseriesDataError(
                f"DA energy time shift requires a {PRICE_COL!r} column")

    def build(self, b: LPBuilder, ctx: WindowContext, ders) -> None:
        price = ctx.col(PRICE_COL)
        scale = ctx.dt * ctx.annuity_scalar
        for der in ders:
            for ref, sign in der.power_terms(b):
                b.add_cost(ref, -sign * price * scale, label="DA ETS")
        # constant loads priced exactly once, via the POI-computed total
        # (site load + DER fixed loads; see WindowContext.fixed_load)
        if ctx.fixed_load is not None:
            b.add_const_cost(float(np.sum(price * ctx.fixed_load)) * scale,
                             label="DA ETS")

    # ---------- results -------------------------------------------------
    def timeseries_report(self, index) -> pd.DataFrame:
        out = pd.DataFrame(index=index)
        ts = self.datasets.time_series
        price = grab_column(ts.loc[index], PRICE_COL)
        out[PRICE_COL] = price
        return out

    def proforma_report(self, opt_years, poi, results) -> Optional[pd.DataFrame]:
        """DA ETS value per year = sum(price * net power injected * dt)."""
        rows = {}
        price = results[PRICE_COL]
        net = -results["Net Load (kW)"]
        dt = float(self.scenario.get("dt", 1))
        for yr in opt_years:
            mask = results.index.year == yr
            rows[pd.Period(yr, freq="Y")] = float(
                np.sum(price[mask] * net[mask]) * dt)
        return pd.DataFrame({"DA ETS": rows})
