"""Retail value streams: energy time-shift and demand charge management.

Re-implements the behavior of the storagevet ``EnergyTimeShift``
(retailTimeShift tag) and ``DemandChargeReduction`` (DCM tag) value streams
(SURVEY.md §2.8; wired at dervet/MicrogridScenario.py:83-98) on the
LP-block architecture:

* retailTimeShift: the customer pays the tariff energy price for net load
  drawn through the POI each timestep (exports credited at the same retail
  rate — net-metering semantics, matching the reference's symmetric
  ``price * net load`` billing in the frozen ``adv_monthly_bill`` goldens)
* DCM: for every (calendar month x demand billing period) present in an
  optimization window, one scalar peak variable ``d >= net load(t)`` over
  the period's masked timesteps, costed at the period's $/kW value.  The
  reference builds the same per-month maxima via CVXPY ``cvx.max``
  expressions; a scalar epigraph variable is the LP-native equivalent.

Proforma rows are 'Avoided Energy Charge' / 'Avoided Demand Charge':
original bill minus with-DER bill, computed by the shared
:class:`~dervet_tpu_torch.financial.tariff.TariffEngine`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pandas as pd

from ...financial.tariff import TariffEngine
from ...ops.lp import LPBuilder
from ...scenario.window import WindowContext
from ...utils.errors import TariffError
from .base import ValueStream


class _TariffStream(ValueStream):
    """Shared tariff plumbing for retailTimeShift and DCM."""

    def __init__(self, tag: str, keys, scenario, datasets):
        super().__init__(tag, keys, scenario, datasets)
        if datasets.tariff is None:
            raise TariffError(f"{tag} requires a customer_tariff_filename "
                              "under the Finance tag")
        self.engine = TariffEngine(datasets.tariff)
        self.growth = float(keys.get("growth", 0) or 0) / 100.0

    # bill frames for drill-downs; net/original load supplied by results
    def monthly_bills(self, net_load: pd.Series, original_load: pd.Series,
                      dt: float):
        return self.engine.monthly_bill(net_load, original_load, dt)


class EnergyTimeShift(_TariffStream):
    """retailTimeShift: minimize retail energy cost of net load."""

    def __init__(self, keys, scenario, datasets):
        super().__init__("retailTimeShift", keys, scenario, datasets)

    def build(self, b: LPBuilder, ctx: WindowContext, ders) -> None:
        price = self.engine.energy_price(ctx.index)
        scale = ctx.dt * ctx.annuity_scalar
        for der in ders:
            for ref, sign in der.power_terms(b):
                # net load = fixed load - sum(sign*var); import costs money
                b.add_cost(ref, -sign * price * scale, label="retailETS")
        if ctx.fixed_load is not None:
            b.add_const_cost(float(price @ ctx.fixed_load) * scale,
                             label="retailETS")

    def timeseries_report(self, index) -> pd.DataFrame:
        out = pd.DataFrame(index=index)
        out["Tariff Energy Price ($/kWh)"] = self.engine.energy_price(index)
        return out

    def proforma_report(self, opt_years, poi, results) -> Optional[pd.DataFrame]:
        rows = {}
        dt = float(self.scenario.get("dt", 1))
        price = results["Tariff Energy Price ($/kWh)"].to_numpy()
        net = results["Net Load (kW)"].to_numpy()
        orig = results["Total Original Load (kW)"].to_numpy()
        years = results.index.year
        for yr in opt_years:
            mask = years == yr
            avoided = float(np.sum(price[mask] * (orig[mask] - net[mask])) * dt)
            rows[pd.Period(yr, freq="Y")] = avoided
        return pd.DataFrame({"Avoided Energy Charge": rows})

    def drill_down_dfs(self, results: pd.DataFrame, dt: float
                       ) -> Dict[str, pd.DataFrame]:
        net = results["Net Load (kW)"]
        orig = results["Total Original Load (kW)"]
        adv, simple = self.monthly_bills(net, orig, dt)
        return {"adv_monthly_bill": adv, "simple_monthly_bill": simple}


class DemandChargeReduction(_TariffStream):
    """DCM: minimize demand charges via per-period peak epigraph variables."""

    def __init__(self, keys, scenario, datasets):
        super().__init__("DCM", keys, scenario, datasets)
        if not self.engine.demand_periods:
            raise TariffError("DCM is active but the tariff has no demand "
                              "billing periods")

    def build(self, b: LPBuilder, ctx: WindowContext, ders) -> None:
        index = ctx.index
        month_year = index.to_period("M")
        load = ctx.fixed_load if ctx.fixed_load is not None \
            else np.zeros(ctx.T)
        terms = []
        for der in ders:
            terms.extend(der.power_terms(b))
        import scipy.sparse as sp
        for my in month_year.unique():
            in_month = np.asarray(month_year == my)
            sub_index = index[in_month]
            for pid, val, mask_local in self.engine.demand_masks(sub_index):
                if not mask_local.any():
                    continue
                full_mask = np.zeros(ctx.T, dtype=bool)
                full_mask[np.nonzero(in_month)[0][mask_local]] = True
                k = int(full_mask.sum())
                d = b.var(f"DCM/{my}/{pid}", 1, lb=0.0)
                # net_load(t) <= d  =>  sum(sign*var(t)) + d >= load(t)
                row_terms = [(d, np.ones((k, 1)))]
                sel_rows = np.nonzero(full_mask)[0]
                for ref, sign in terms:
                    mat = sp.coo_matrix(
                        (np.full(k, sign), (np.arange(k), sel_rows)),
                        shape=(k, ref.size)).tocsr()
                    row_terms.append((ref, mat))
                b.add_rows(f"dcm_{my}_{pid}", row_terms, "ge", load[full_mask])
                b.add_cost(d, val * ctx.annuity_scalar, label="DCM")

    def timeseries_report(self, index) -> pd.DataFrame:
        out = pd.DataFrame(index=index)
        out["Demand Charge Billing Periods"] = \
            self.engine.billing_periods_by_step(index)
        return out

    def proforma_report(self, opt_years, poi, results) -> Optional[pd.DataFrame]:
        dt = float(self.scenario.get("dt", 1))
        net = results["Net Load (kW)"]
        orig = results["Total Original Load (kW)"]
        rows = {}
        adv, _ = self.monthly_bills(net, orig, dt)
        if not len(adv):
            return None
        dem = adv.dropna(subset=["Demand Charge ($)"])
        for yr in opt_years:
            sel = dem[[my.year == yr for my in dem.index]]
            avoided = float((sel["Original Demand Charge ($)"]
                             - sel["Demand Charge ($)"]).sum())
            rows[pd.Period(yr, freq="Y")] = avoided
        return pd.DataFrame({"Avoided Demand Charge": rows})

    def drill_down_dfs(self, results: pd.DataFrame, dt: float
                       ) -> Dict[str, pd.DataFrame]:
        return {"demand_charges": self.engine.demand_charges_table()}
