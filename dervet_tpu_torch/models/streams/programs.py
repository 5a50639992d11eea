"""Program / contract value streams: User, Backup, Deferral, DR, RA, VoltVar.

Re-implements the behavior of the storagevet value streams
``UserConstraints``, ``Backup``, ``Deferral``, ``DemandResponse``,
``ResourceAdequacy`` and ``VoltVar`` (SURVEY.md §2.8; wired at
dervet/MicrogridScenario.py:83-98) on the LP-block architecture.  These
streams impose profiles/events on the aggregate system (as
:class:`SystemRequirement` objects the POI turns into rows) and book
contract revenue in the proforma; none owns dispatch variables.

Input surface matches the reference datasets:
* time series: 'POI: Max Export (kW)', 'POI: Max Import (kW)',
  'Aggregate Energy Max (kWh)', 'Aggregate Energy Min (kWh)',
  'Deferral Load (kW)', 'RA Active (y/n)', 'VAR Reservation (%)',
  'Site Load (kW)'
* monthly data: 'Backup Price ($/kWh)', 'Backup Energy (kWh)',
  'DR Months (y/n)', 'DR Capacity (kW)', 'DR Capacity Price ($/kW)',
  'DR Energy Price ($/kWh)', 'RA Capacity Price ($/kW)'

Documented divergences from the (absent) storagevet sources: DR/RA event
days are selected deterministically as the top-load days inside the program
window; the reference's exact selection is unrecoverable from the snapshot
and its own tests only assert completion (SURVEY.md §4).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from ...ops.lp import LPBuilder
from ...scenario.window import WindowContext, grab_column
from ...utils.errors import ParameterError, TellUser, TimeseriesDataError
from .base import SystemRequirement, ValueStream


def _monthly_series(monthly: Optional[pd.DataFrame], col: str,
                    index: pd.DatetimeIndex,
                    default: Optional[float] = None) -> Optional[pd.Series]:
    """Broadcast a (Year, Month)-indexed monthly column over timesteps.
    With ``default`` set, a missing column yields a constant series instead
    of None (optional program columns)."""
    if monthly is None or col not in monthly.columns:
        if default is None:
            return None
        return pd.Series(float(default), index=index)
    key = pd.MultiIndex.from_arrays([index.year, index.month])
    vals = monthly[col].reindex(key).to_numpy(dtype=np.float64)
    return pd.Series(vals, index=index)


class UserConstraints(ValueStream):
    """User-defined aggregate limits from time-series columns, paid a fixed
    yearly price (reference: storagevet UserConstraints surface; schema
    User.price)."""

    fill_forward = False      # paid only in optimized years (step2 golden)

    POI_EXPORT = "POI: Max Export (kW)"
    POI_IMPORT = "POI: Max Import (kW)"
    ENE_MAX = "Aggregate Energy Max (kWh)"
    ENE_MIN = "Aggregate Energy Min (kWh)"

    def __init__(self, keys, scenario, datasets):
        super().__init__("User", keys, scenario, datasets)
        self.price = float(keys.get("price", 0) or 0)
        ts = datasets.time_series
        if ts is None:
            raise TimeseriesDataError("User constraints require a time series")
        self.found = [c for c in (self.POI_EXPORT, self.POI_IMPORT,
                                  self.ENE_MAX, self.ENE_MIN)
                      if grab_column(ts, c) is not None]
        if not self.found:
            raise TimeseriesDataError(
                "User constraints active but none of the constraint columns "
                f"({self.POI_EXPORT!r}, {self.POI_IMPORT!r}, {self.ENE_MAX!r}, "
                f"{self.ENE_MIN!r}) are in the time series")

    def system_requirements(self, ders, years, index) -> List[SystemRequirement]:
        ts = self.datasets.time_series.loc[index]
        out = []

        def col(name):
            arr = grab_column(ts, name)
            return None if arr is None else pd.Series(arr, index=index)

        exp = col(self.POI_EXPORT)
        if exp is not None:
            out.append(SystemRequirement("poi export", "max", "User", exp))
        imp = col(self.POI_IMPORT)
        if imp is not None:
            # the reference's import column is negative-valued (import is
            # negative net export); net export >= import limit
            out.append(SystemRequirement("poi export", "min", "User", imp))
        emax = col(self.ENE_MAX)
        if emax is not None:
            out.append(SystemRequirement("energy", "max", "User", emax))
        emin = col(self.ENE_MIN)
        if emin is not None:
            out.append(SystemRequirement("energy", "min", "User", emin))
        return out

    def proforma_report(self, opt_years, poi, results) -> Optional[pd.DataFrame]:
        rows = {pd.Period(yr, freq="Y"): self.price for yr in opt_years}
        return pd.DataFrame({"User Constraints Value": rows})


class Backup(ValueStream):
    """Backup energy reservation: hold a monthly energy floor in storage,
    paid per kWh reserved (reference: storagevet Backup surface; monthly
    'Backup Energy (kWh)' / 'Backup Price ($/kWh)')."""

    def __init__(self, keys, scenario, datasets):
        super().__init__("Backup", keys, scenario, datasets)
        if datasets.monthly is None or \
                "Backup Energy (kWh)" not in datasets.monthly.columns:
            raise TimeseriesDataError(
                "Backup requires monthly 'Backup Energy (kWh)' data")

    def system_requirements(self, ders, years, index) -> List[SystemRequirement]:
        energy = _monthly_series(self.datasets.monthly, "Backup Energy (kWh)",
                                 index)
        return [SystemRequirement("energy", "min", "Backup", energy.fillna(0.0))]

    def monthly_report(self) -> pd.DataFrame:
        m = self.datasets.monthly
        cols = [c for c in ("Backup Energy (kWh)", "Backup Price ($/kWh)")
                if c in m.columns]
        return m[cols].copy()

    def proforma_report(self, opt_years, poi, results) -> Optional[pd.DataFrame]:
        m = self.datasets.monthly
        if "Backup Price ($/kWh)" not in m.columns:
            return None
        rows = {}
        for yr in opt_years:
            sel = m.loc[[i for i in m.index if i[0] == yr]]
            rows[pd.Period(yr, freq="Y")] = float(
                (sel["Backup Energy (kWh)"] * sel["Backup Price ($/kWh)"]).sum())
        return pd.DataFrame({"Backup Plan": rows})


class Deferral(ValueStream):
    """T&D upgrade deferral: keep the substation flow within planned limits
    while serving the deferral load; earn the deferral price for each year
    the upgrade stays deferred (reference: storagevet Deferral surface +
    MicrogridServiceAggregator.py:81-107 min-size hooks)."""

    LOAD_COL = "Deferral Load (kW)"

    def __init__(self, keys, scenario, datasets):
        super().__init__("Deferral", keys, scenario, datasets)
        g = lambda k, d=0.0: float(keys.get(k, d) or 0.0)
        self.price = g("price")                       # $/yr deferred
        self.growth = g("growth") / 100.0             # deferral LOAD growth
        # the contract price is a flat dollar value — the growth key is a
        # load-projection rate, not a price escalator
        self.proforma_growth = 0.0
        self.planned_load_limit = g("planned_load_limit")
        self.reverse_power_flow_limit = g("reverse_power_flow_limit")  # <= 0
        self.min_year_objective = int(g("min_year_objective"))
        ts = datasets.time_series
        if ts is None or grab_column(ts, self.LOAD_COL) is None:
            raise TimeseriesDataError(
                f"Deferral requires a {self.LOAD_COL!r} column")
        self.deferral_df: Optional[pd.DataFrame] = None

    def system_requirements(self, ders, years, index) -> List[SystemRequirement]:
        ts = self.datasets.time_series.loc[index]
        dload = pd.Series(grab_column(ts, self.LOAD_COL), index=index)
        # substation import = deferral load - net export <= planned limit
        #   -> net export >= deferral load - planned limit
        lo = dload - self.planned_load_limit
        # substation reverse flow = net export - deferral load
        #   <= |reverse limit|  -> net export <= deferral load + |limit|
        hi = dload + abs(self.reverse_power_flow_limit)
        return [SystemRequirement("poi export", "min", "Deferral", lo),
                SystemRequirement("poi export", "max", "Deferral", hi)]

    # ---------- yearly deferral feasibility analysis --------------------
    def deferral_analysis(self, ders, opt_years: List[int],
                          end_year: int) -> pd.DataFrame:
        """Per-year power/energy requirement under load growth vs the DER
        fleet's capability (reference: Deferral.deferral_df consumed at
        MicrogridServiceAggregator.py:93-98)."""
        ts = self.datasets.time_series
        # anchor the growth projection on the BASE optimized year only —
        # later (possibly growth-synthesized) years would double-count the
        # fill's growth
        base_mask = ts.index.year == min(opt_years)
        ts = ts[base_mask] if base_mask.any() else ts
        index = ts.index
        dload = np.asarray(grab_column(ts, self.LOAD_COL))
        dt = float(self.scenario.get("dt", 1))
        dis_cap = sum(getattr(d, "discharge_capacity", lambda: 0.0)()
                      for d in ders)
        ene_cap = sum(getattr(d, "energy_capacity", lambda: 0.0)()
                      for d in ders)
        base_year = opt_years[0]
        rows = []
        for yr in range(base_year, end_year + 1):
            scale = (1.0 + self.growth) ** (yr - base_year)
            over = np.maximum(dload * scale - self.planned_load_limit, 0.0)
            p_req = float(over.max()) if len(over) else 0.0
            # max energy over contiguous overload runs
            e_req = 0.0
            run = 0.0
            for v in over:
                run = run + v * dt if v > 0 else 0.0
                e_req = max(e_req, run)
            rows.append({"Year": yr, "Power Requirement (kW)": p_req,
                         "Energy Requirement (kWh)": e_req,
                         "Deferral Possible": bool(p_req <= dis_cap
                                                   and e_req <= ene_cap)})
        self.deferral_df = pd.DataFrame(rows).set_index("Year")
        return self.deferral_df

    @property
    def min_years(self) -> int:
        if self.deferral_df is None:
            return 0
        ok = self.deferral_df["Deferral Possible"]
        n = 0
        for v in ok:
            if not v:
                break
            n += 1
        return n

    def proforma_report(self, opt_years, poi, results) -> Optional[pd.DataFrame]:
        rows = {pd.Period(yr, freq="Y"): self.price for yr in opt_years}
        return pd.DataFrame({"Deferral: Avoided Upgrade": rows})

    def drill_down_dfs(self, results, dt) -> Dict[str, pd.DataFrame]:
        if self.deferral_df is None:
            return {}
        return {"deferral_results": self.deferral_df}


class DemandResponse(ValueStream):
    """DR program: commit capacity on the worst `days` days of each DR
    month inside the program hours (reference: storagevet DemandResponse
    surface; keys days/length/program_start_hour/program_end_hour/weekend/
    day_ahead).

    day_ahead=1: events are known a day ahead — the committed discharge is
    scheduled (aggregate discharge-min requirement on event steps).
    day_ahead=0 (day-of): events may be called any program day — storage
    holds capacity x length of energy through every program-hour step.
    """

    def __init__(self, keys, scenario, datasets):
        super().__init__("DR", keys, scenario, datasets)
        self.growth = float(keys.get("growth", 0) or 0) / 100.0
        self.days = int(float(keys.get("days", 0) or 0))
        self.weekend = bool(keys.get("weekend", False))
        self.day_ahead = bool(keys.get("day_ahead", False))
        start = keys.get("program_start_hour")
        end = keys.get("program_end_hour")
        length = keys.get("length")

        def _num(v):
            try:
                f = float(v)
                return None if np.isnan(f) else f
            except (TypeError, ValueError):
                return None

        start, end, length = _num(start), _num(end), _num(length)
        if start is None:
            raise ParameterError("DR requires program_start_hour")
        # reference semantics: exactly one of length / program_end_hour,
        # the other derived (test inputs 021/022 use nan for the derived one)
        if end is None and length is None:
            raise ParameterError(
                "DR requires either length or program_end_hour")
        if end is None:
            end = start + length - 1
        elif length is None:
            length = end - start + 1
        elif end - start + 1 != length:
            raise ParameterError(
                f"DR length {length} conflicts with program hours "
                f"{start}..{end}")
        self.start_he, self.end_he, self.length = int(start), int(end), float(length)
        if datasets.monthly is None or \
                "DR Capacity (kW)" not in datasets.monthly.columns:
            raise TimeseriesDataError("DR requires monthly 'DR Capacity (kW)'")

    # ---------- event selection ----------------------------------------
    def event_mask(self, index: pd.DatetimeIndex) -> np.ndarray:
        """Boolean mask of committed event steps (top-`days` site-load days
        per active DR month, program hours only)."""
        monthly = self.datasets.monthly
        # a missing 'DR Months (y/n)' column means every month participates
        active = _monthly_series(monthly, "DR Months (y/n)", index, default=1.0)
        he = np.asarray(index.hour) + 1
        hours = (he >= self.start_he) & (he <= self.end_he)
        if not self.weekend:
            hours &= np.asarray(index.weekday) < 5
        in_program = hours & (np.asarray(active.fillna(0.0)) > 0)
        site = grab_column(self.datasets.time_series.loc[index],
                           "Site Load (kW)")
        load = np.asarray(site) if site is not None else np.ones(len(index))
        mask = np.zeros(len(index), dtype=bool)
        my = index.to_period("M")
        for m in my.unique():
            sel = np.asarray(my == m) & in_program
            if not sel.any():
                continue
            days = pd.Series(np.where(sel, load, -np.inf),
                             index=index).groupby(index.date).max()
            top = days.nlargest(min(self.days, int((days > -np.inf).sum())))
            event_days = set(top.index)
            day_arr = np.asarray(index.date)
            mask |= sel & np.isin(day_arr, list(event_days))
        return mask

    def system_requirements(self, ders, years, index) -> List[SystemRequirement]:
        cap = _monthly_series(self.datasets.monthly, "DR Capacity (kW)", index)
        cap = cap.fillna(0.0)
        mask = self.event_mask(index)
        if self.day_ahead:
            series = pd.Series(np.where(mask, cap, 0.0), index=index)
            return [SystemRequirement("discharge", "min", "DR", series)]
        # day-of: hold capacity*length of energy through all program steps
        active = _monthly_series(self.datasets.monthly, "DR Months (y/n)",
                                 index, default=1.0)
        he = np.asarray(index.hour) + 1
        hours = (he >= self.start_he) & (he <= self.end_he)
        if not self.weekend:
            hours &= np.asarray(index.weekday) < 5
        program = hours & (np.asarray(active.fillna(0.0)) > 0)
        series = pd.Series(np.where(program, cap * self.length, 0.0),
                           index=index)
        return [SystemRequirement("energy", "min", "DR", series)]

    def monthly_report(self) -> pd.DataFrame:
        m = self.datasets.monthly
        cols = [c for c in ("DR Months (y/n)", "DR Capacity (kW)",
                            "DR Capacity Price ($/kW)",
                            "DR Energy Price ($/kWh)") if c in m.columns]
        return m[cols].copy()

    def proforma_report(self, opt_years, poi, results) -> Optional[pd.DataFrame]:
        m = self.datasets.monthly
        cap_rows, ene_rows = {}, {}
        dt = float(self.scenario.get("dt", 1))
        mask = self.event_mask(results.index)
        eprice = _monthly_series(m, "DR Energy Price ($/kWh)", results.index,
                                 default=0.0).fillna(0.0)
        for yr in opt_years:
            sel = m.loc[[i for i in m.index if i[0] == yr]]
            active = sel.get("DR Months (y/n)", pd.Series(1, index=sel.index))
            cap = sel.get("DR Capacity (kW)", pd.Series(0.0, index=sel.index))
            cprice = sel.get("DR Capacity Price ($/kW)",
                             pd.Series(0.0, index=sel.index))
            cap_rows[pd.Period(yr, freq="Y")] = float(
                ((active > 0) * cap * cprice).sum())
            # energy payment on delivered event energy
            ymask = (results.index.year == yr) & mask
            delivered = -results.loc[ymask, "Net Load (kW)"].clip(upper=0.0)
            ene_rows[pd.Period(yr, freq="Y")] = float(
                (np.asarray(eprice[ymask]) * np.asarray(delivered)).sum() * dt)
        return pd.DataFrame({"DR Capacity Payment": cap_rows,
                             "DR Energy Payment": ene_rows})


class ResourceAdequacy(ValueStream):
    """RA: qualifying capacity payments for system peaks (reference:
    storagevet ResourceAdequacy surface; keys days/length/idmode/dispmode;
    monthly 'RA Capacity Price ($/kW)')."""

    def __init__(self, keys, scenario, datasets):
        super().__init__("RA", keys, scenario, datasets)
        self.growth = float(keys.get("growth", 0) or 0) / 100.0
        self.days = int(float(keys.get("days", 1) or 1))
        self.length = float(keys.get("length", 4) or 4)
        self.dispmode = bool(keys.get("dispmode", False))
        self.idmode = str(keys.get("idmode", "peak by year")).strip().lower()
        if datasets.monthly is None or \
                "RA Capacity Price ($/kW)" not in datasets.monthly.columns:
            raise TimeseriesDataError(
                "RA requires monthly 'RA Capacity Price ($/kW)'")

    def qualifying_capacity(self, ders) -> float:
        """Sustained-discharge capability: storage limited by energy over
        the event length; generators by nameplate."""
        qc = 0.0
        for d in ders:
            if d.technology_type == "Energy Storage System":
                qc += min(d.discharge_capacity(),
                          d.energy_capacity() / max(self.length, 1e-9))
            elif d.technology_type == "Generator":
                qc += getattr(d, "max_power_out", 0.0)
        return qc

    def event_mask(self, index: pd.DatetimeIndex) -> np.ndarray:
        ts = self.datasets.time_series.loc[index]
        flag = grab_column(ts, "RA Active (y/n)")
        if flag is not None and np.any(np.asarray(flag) > 0):
            return np.asarray(flag) > 0
        site = grab_column(ts, "Site Load (kW)")
        load = pd.Series(np.asarray(site) if site is not None else 0.0,
                         index=index)
        mask = np.zeros(len(index), dtype=bool)
        half = int(round(self.length / 2))
        groups = [index.year] if "year" in self.idmode else \
            [index.year, index.month]
        for _, sub in load.groupby(groups):
            peaks = sub.groupby(sub.index.date).max().nlargest(self.days)
            for day in peaks.index:
                day_mask = np.asarray(index.date) == day
                day_load = np.where(day_mask, load, -np.inf)
                center = int(np.argmax(day_load))
                lo = max(0, center - half + 1)
                hi = min(len(index), lo + int(round(self.length)))
                mask[lo:hi] = True
        return mask

    def system_requirements(self, ders, years, index) -> List[SystemRequirement]:
        if not self.dispmode:
            qc = self.qualifying_capacity(ders)
            mask = self.event_mask(index)
            series = pd.Series(np.where(mask, qc * self.length, 0.0),
                               index=index)
            return [SystemRequirement("energy", "min", "RA", series)]
        qc = self.qualifying_capacity(ders)
        mask = self.event_mask(index)
        series = pd.Series(np.where(mask, qc, 0.0), index=index)
        return [SystemRequirement("discharge", "min", "RA", series)]

    def timeseries_report(self, index) -> pd.DataFrame:
        out = pd.DataFrame(index=index)
        out["RA Event (y/n)"] = self.event_mask(index).astype(float)
        return out

    def proforma_report(self, opt_years, poi, results) -> Optional[pd.DataFrame]:
        m = self.datasets.monthly
        qc = self.qualifying_capacity(poi.der_list if poi else [])
        rows = {}
        for yr in opt_years:
            sel = m.loc[[i for i in m.index if i[0] == yr]]
            price = sel["RA Capacity Price ($/kW)"]
            rows[pd.Period(yr, freq="Y")] = float((price * qc).sum())
        return pd.DataFrame({"RA Capacity Payment": rows})


class VoltVar(ValueStream):
    """Volt/VAR support: reserve a fraction of inverter apparent power for
    reactive duty — per-timestep real-power derate on inverter-based DERs
    (reference: storagevet VoltVar surface; 'VAR Reservation (%)' column)."""

    COL = "VAR Reservation (%)"

    def __init__(self, keys, scenario, datasets):
        super().__init__("Volt", keys, scenario, datasets)
        ts = datasets.time_series
        if ts is None or grab_column(ts, self.COL) is None:
            raise TimeseriesDataError(f"VoltVar requires a {self.COL!r} column")

    def build(self, b: LPBuilder, ctx: WindowContext, ders) -> None:
        reserve = np.clip(np.asarray(ctx.col(self.COL)) / 100.0, 0.0, 1.0)
        # P <= S * sqrt(1 - r^2): linear per-timestep derate factor
        derate = np.sqrt(np.maximum(1.0 - reserve ** 2, 0.0))
        for d in ders:
            if d.technology_type == "Energy Storage System":
                # sized ratings derate against the size variable instead of
                # the (zero) numeric rating
                for q, cap, sizing in (
                        ("dis", d.discharge_capacity(),
                         getattr(d, "sizing_dis", False)),
                        ("ch", d.charge_capacity(),
                         getattr(d, "sizing_ch", False))):
                    size_name = d.vname("size_dis" if sizing and
                                        not b.has(d.vname(f"size_{q}"))
                                        else f"size_{q}")
                    if sizing and b.has(size_name):
                        b.add_rows(f"voltvar_{d.vname(q)}",
                                   [(b[d.vname(q)], 1.0),
                                    (b[size_name], -derate[:, None])],
                                   "le", 0.0)
                    else:
                        b.add_rows(f"voltvar_{d.vname(q)}",
                                   [(b[d.vname(q)], 1.0)], "le",
                                   cap * derate)
            elif d.tag == "PV" and b.has(d.vname("gen")):
                # only curtailable PV can respond to a derate; fixed
                # (lb==ub) generation would make the row infeasible
                inv = getattr(d, "inv_max", np.inf)
                if np.isfinite(inv) and getattr(d, "curtail", False):
                    b.add_rows(f"voltvar_{d.vname('gen')}",
                               [(b[d.vname("gen")], 1.0)], "le",
                               inv * derate)

    def timeseries_report(self, index) -> pd.DataFrame:
        out = pd.DataFrame(index=index)
        arr = grab_column(self.datasets.time_series.loc[index], self.COL)
        out[self.COL] = arr
        return out
