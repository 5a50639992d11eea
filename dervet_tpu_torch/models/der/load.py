"""Controllable (shiftable) site load.

Re-implements dervet/MicrogridDER/LoadControllable.py:97-260 (SURVEY.md
§2.4) on the storagevet Load surface: the DER owns the site load profile
and may shift up to ``power_rating`` kW of it within each day, holding the
day's total energy constant (intra-day SOE evolution with a
``power_rating * duration`` reservoir).
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

LOAD_COL = "Site Load (kW)"


class ControllableLoad(DER):

    technology_type = "Load"

    def __init__(self, keys: Dict, scenario: Dict, der_id: str = "",
                 datasets=None):
        super().__init__("Load", der_id, keys, scenario)
        g = lambda k, d=0.0: float(keys.get(k, d) or 0.0)
        self.power_rating = g("power_rating")
        self.duration = g("duration")
        self.datasets = datasets
        self.original_load: Optional[np.ndarray] = None
        if datasets is None or datasets.time_series is None:
            raise TimeseriesDataError("ControllableLoad requires a time series "
                                      f"with {LOAD_COL!r}")

    def controllable(self) -> bool:
        return self.power_rating > 0 and self.duration > 0

    def build(self, b: LPBuilder, ctx: WindowContext) -> None:
        if not self.controllable():
            return
        T, dt = ctx.T, ctx.dt
        cap = self.power_rating * self.duration
        # power: shift applied to the site load (positive = extra load now)
        power = b.var(self.vname("power"), T,
                      lb=-self.power_rating, ub=self.power_rating)
        ene = b.var(self.vname("ene_load"), T, lb=0.0, ub=cap)
        # reservoir evolution: ene[t] - ene[t-1] - power[t]*dt == 0,
        # ene[-1] := cap/2 at each day boundary and day totals neutral
        diag = sp.diags([np.ones(T), -np.ones(T - 1)], [0, -1], format="csr")
        rhs = np.zeros(T)
        rhs[0] = cap / 2.0
        b.add_rows(self.vname("shift_soe"), [(ene, diag), (power, -dt)],
                   "eq", rhs)
        # end each day back at the midpoint => energy-neutral days
        days = ctx.index.normalize()
        uniq = days.unique()
        day_end_rows = []
        for d in uniq:
            idx = np.nonzero(np.asarray(days == d))[0]
            day_end_rows.append(idx[-1])
        sel = sp.coo_matrix(
            (np.ones(len(day_end_rows)),
             (np.arange(len(day_end_rows)), np.array(day_end_rows))),
            shape=(len(day_end_rows), T)).tocsr()
        b.add_rows(self.vname("day_neutral"), [(ene, sel)], "eq",
                   np.full(len(day_end_rows), cap / 2.0))

    def power_terms(self, b: LPBuilder) -> List[Tuple[VarRef, float]]:
        if self.controllable() and b.has(self.vname("power")):
            return [(b[self.vname("power")], -1.0)]
        return []

    def fixed_load(self, ctx: WindowContext) -> Optional[np.ndarray]:
        load = ctx.col(LOAD_COL, self.id)
        if load is None:
            raise TimeseriesDataError(f"missing {LOAD_COL!r} for {self.name}")
        return load

    def effective_load(self) -> Optional[pd.Series]:
        if self.variables_df is None or self.original_load is None:
            return None
        shift = self.variables_df.get("power", 0.0)
        return pd.Series(self.original_load, index=self.variables_df.index) + shift

    def store_dispatch(self, index, values):
        from ...scenario.window import grab_column
        if not values:
            values = {}
        super().store_dispatch(index, values)
        if self.datasets is not None and self.datasets.time_series is not None:
            arr = grab_column(self.datasets.time_series.loc[index], LOAD_COL,
                              self.id)
            self.original_load = arr

    def load_series(self):
        if self.original_load is None:
            return None
        v = self.variables_df
        if v is not None and "power" in v:
            return self.original_load + v["power"].to_numpy()
        return np.asarray(self.original_load)

    def timeseries_report(self) -> pd.DataFrame:
        v = self.variables_df
        out = pd.DataFrame(index=v.index)
        if self.original_load is not None:
            out[self.col("Original Load (kW)")] = self.original_load
            if "power" in v:
                out[self.col("Load (kW)")] = self.original_load + v["power"].to_numpy()
        return out
