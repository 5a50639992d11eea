"""Retail tariff engine: billing-period masks, energy prices, demand charges.

Re-implements the behavior of the reference's customer-tariff machinery (the
storagevet ``Financial`` billing helpers, SURVEY.md §2.8; tariff format per
the reference's ``data/tariff.csv`` and the frozen billing outputs of its
``test/test_validation_report_sept1`` case):

* a tariff is a table of billing periods — ``Start Month``/``End Month``
  (inclusive), ``Start Time``/``End Time`` in hour-ENDING units (inclusive),
  optional ``Excluding Start Time``/``Excluding End Time``, ``Weekday?``
  (0 weekend / 1 weekday / 2 both), ``Value`` and ``Charge``
  ('energy' $/kWh or 'demand' $/kW, case-insensitive)
* the retail energy price of a timestep is the SUM of every applicable
  energy period's value (stacking adders)
* demand charges apply per calendar month: value x the month's maximum net
  load (kW) over the period's masked timesteps, floored at zero
* billing reports: ``adv_monthly_bill`` (per month x billing period) and
  ``simple_monthly_bill`` (per month totals) with Original columns computed
  on the pre-DER load, matching the reference's output columns.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from ..utils.errors import TariffError


def _num(row, key, default=None):
    val = row.get(key, default)
    if val is None or (isinstance(val, float) and np.isnan(val)):
        return default
    try:
        return float(val)
    except (TypeError, ValueError):
        return default


class TariffEngine:
    """Vectorised billing-period masks over a datetime index."""

    def __init__(self, tariff: pd.DataFrame):
        if tariff is None or not len(tariff):
            raise TariffError("a customer tariff with at least one billing "
                              "period is required")
        self.tariff = tariff
        low = {str(c).strip().lower(): c for c in tariff.columns}
        need = ["start month", "end month", "start time", "end time",
                "weekday?", "value", "charge"]
        missing = [c for c in need if c not in low]
        if missing:
            raise TariffError(f"tariff is missing columns {missing}")
        self._col = low

    def _c(self, name: str) -> str:
        return self._col[name]

    # ------------------------------------------------------------------
    def period_mask(self, period_id, index: pd.DatetimeIndex) -> np.ndarray:
        """Boolean mask of timesteps (hour-beginning index) the billing
        period applies to."""
        row = self.tariff.loc[period_id]
        he = np.asarray(index.hour) + 1          # hour-ending label, 1..24
        month = np.asarray(index.month)
        weekday = np.asarray(index.weekday) < 5
        m0, m1 = _num(row, self._c("start month")), _num(row, self._c("end month"))
        t0, t1 = _num(row, self._c("start time")), _num(row, self._c("end time"))
        if None in (m0, m1, t0, t1):
            raise TariffError(
                f"billing period {period_id!r} has a blank/non-numeric "
                "Start/End Month or Start/End Time")
        mask = (month >= m0) & (month <= m1) & (he >= t0) & (he <= t1)
        x0 = _num(row, self._c("excluding start time")) \
            if "excluding start time" in self._col else None
        x1 = _num(row, self._c("excluding end time")) \
            if "excluding end time" in self._col else None
        if x0 is not None and x1 is not None:
            mask &= ~((he >= x0) & (he <= x1))
        wd = _num(row, self._c("weekday?"), 2)
        if wd == 1:
            mask &= weekday
        elif wd == 0:
            mask &= ~weekday
        return mask

    def _rows_of(self, kind: str) -> List:
        col = self._c("charge")
        return [pid for pid in self.tariff.index
                if str(self.tariff.loc[pid, col]).strip().lower() == kind]

    @property
    def energy_periods(self) -> List:
        return self._rows_of("energy")

    @property
    def demand_periods(self) -> List:
        return self._rows_of("demand")

    def value_of(self, period_id) -> float:
        return float(self.tariff.loc[period_id, self._c("value")])

    # ------------------------------------------------------------------
    def energy_price(self, index: pd.DatetimeIndex) -> np.ndarray:
        """Per-timestep retail energy price ($/kWh): sum of applicable
        energy-period values."""
        price = np.zeros(len(index))
        for pid in self.energy_periods:
            price[self.period_mask(pid, index)] += self.value_of(pid)
        return price

    def demand_masks(self, index: pd.DatetimeIndex
                     ) -> List[Tuple[object, float, np.ndarray]]:
        """``(period_id, $/kW value, mask)`` per demand billing period."""
        return [(pid, self.value_of(pid), self.period_mask(pid, index))
                for pid in self.demand_periods]

    def billing_periods_by_step(self, index: pd.DatetimeIndex) -> pd.Series:
        """Per-timestep list of applicable DEMAND billing periods (reference
        output column 'Demand Charge Billing Periods')."""
        masks = self.demand_masks(index)
        out = []
        for i in range(len(index)):
            out.append([pid for pid, _, m in masks if m[i]])
        return pd.Series(out, index=index)

    # ------------------------------------------------------------------
    def monthly_bill(self, net_load: pd.Series,
                     original_load: Optional[pd.Series] = None, dt: float = 1.0
                     ) -> Tuple[pd.DataFrame, pd.DataFrame]:
        """Compute the customer bill per month x billing period.

        ``net_load``/``original_load``: kW drawn from the grid (positive =
        import), indexed by hour-beginning timesteps.  Returns
        ``(adv_monthly_bill, simple_monthly_bill)`` frames matching the
        reference CSV columns.
        """
        index = net_load.index
        if original_load is None:
            original_load = net_load
        month_year = index.to_period("M")
        adv_rows = []
        simple_rows: Dict = {}
        for my in month_year.unique():
            in_month = np.asarray(month_year == my)
            sub_index = index[in_month]
            nl = net_load.to_numpy()[in_month]
            ol = original_load.to_numpy()[in_month]
            e_tot = oe_tot = d_tot = od_tot = 0.0
            applicable = []
            for pid in self.energy_periods:
                mask = self.period_mask(pid, sub_index)
                if not mask.any():
                    continue
                applicable.append(pid)
                val = self.value_of(pid)
                e = float(np.sum(nl[mask]) * val * dt)
                oe = float(np.sum(ol[mask]) * val * dt)
                e_tot += e
                oe_tot += oe
                adv_rows.append({"Month-Year": my, "Billing Period": pid,
                                 "Energy Charge ($)": e,
                                 "Original Energy Charge ($)": oe,
                                 "Demand Charge ($)": np.nan,
                                 "Original Demand Charge ($)": np.nan})
            for pid, val, mask in self.demand_masks(sub_index):
                if not mask.any():
                    continue
                applicable.append(pid)
                d = val * max(0.0, float(np.max(nl[mask])))
                od = val * max(0.0, float(np.max(ol[mask])))
                d_tot += d
                od_tot += od
                adv_rows.append({"Month-Year": my, "Billing Period": pid,
                                 "Energy Charge ($)": np.nan,
                                 "Original Energy Charge ($)": np.nan,
                                 "Demand Charge ($)": d,
                                 "Original Demand Charge ($)": od})
            simple_rows[str(my)] = {
                "Energy Charge ($)": e_tot,
                "Original Energy Charge ($)": oe_tot,
                "Billing Period": str(np.array(sorted(applicable))),
                "Demand Charge ($)": d_tot,
                "Original Demand Charge ($)": od_tot,
            }
        adv = pd.DataFrame(adv_rows)
        if len(adv):
            adv = adv.set_index("Month-Year")
        simple = pd.DataFrame(simple_rows).T
        simple.index.name = "Month-Year"
        return adv, simple

    def demand_charges_table(self) -> pd.DataFrame:
        """The demand rows of the tariff (reference 'demand_charges' CSV)."""
        return self.tariff.loc[self.demand_periods]
