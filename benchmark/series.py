"""The benchmark's inputs, made from a seed: a year of hourly prices, PV
and site load, the extra series a configuration asks for, and the cases
handed to the program.

The formulas are a frozen copy of the port's synthetic generators
(``dervet_tpu_torch/benchlib.py``: ``synthetic_timeseries``,
``synthetic_case``, ``load_shed_curve``, ``synthetic_sensitivity_cases``),
kept here so that a change to the program cannot move the inputs it is
measured on.  This module imports nothing of the program: the case
objects are built by :func:`case_params`, which takes the program's
``CaseParams`` and ``Datasets`` classes as arguments.
"""
from __future__ import annotations

import copy

import numpy as np
import pandas as pd


def timeseries(year: int, dt: float, seed: int) -> pd.DataFrame:
    """One year of DA price ($/kWh), PV per rated kW and site load (kW)."""
    start = pd.Timestamp(year=year, month=1, day=1)
    periods = int(round((pd.Timestamp(year=year + 1, month=1, day=1)
                         - start).total_seconds() / 3600 / dt))
    index = pd.date_range(start, periods=periods, freq=pd.Timedelta(hours=dt))
    rng = np.random.default_rng(seed)
    hours = index.hour.to_numpy() + index.dayofyear.to_numpy() * 24.0
    price = (0.035 + 0.02 * np.sin(2 * np.pi * (index.hour - 16) / 24)
             + 0.005 * np.sin(2 * np.pi * hours / 8760)
             + 0.004 * rng.standard_normal(len(index)))
    price = np.maximum(price, 0.001)
    h = index.hour.to_numpy()
    pv = np.clip(np.cos((h - 12.5) / 6.5 * np.pi / 2), 0.0, 1.0) ** 1.5
    pv = pv * (0.75 + 0.25 * np.sin(2 * np.pi * (index.dayofyear - 80) / 365))
    load = (5000 + 1200 * np.sin(2 * np.pi * (h - 15) / 24)
            + 300 * rng.standard_normal(len(index)))
    return pd.DataFrame({
        "DA Price ($/kWh)": price,
        "PV Gen (kW/rated kW)": pv,
        "Site Load (kW)": np.maximum(load, 500.0),
    }, index=index)


def load_shed_curve(hours: int) -> pd.DataFrame:
    """Percent of the critical load an outage must serve, by outage hour:
    all of it for 4 h, then 10 points less every 4 h down to 50%."""
    h = np.arange(1, hours + 1)
    return pd.DataFrame({"Outage Length (hrs)": h,
                         "Load Shed (%)": np.maximum(
                             100.0 - 10.0 * ((h - 1) // 4), 50.0)})


def case_series(cfg: dict, seed: int) -> pd.DataFrame:
    """The configuration's whole time series for the series seed ``seed``:
    the base year plus the hot-water load and the critical load where the
    configuration has them."""
    ts = timeseries(cfg["year"], cfg["dt"], seed)
    extra = cfg.get("series", {})
    if extra.get("hot_water"):
        # within the CHP's recoverable heat: 800 kW / 0.0015 = 533 kBTU/hr
        rng = np.random.default_rng(seed + 1)
        hours = ts.index.hour.to_numpy()
        ts["Site Hot Water Thermal Load (BTU/hr)"] = 1e5 * (
            2.0 + np.sin(2 * np.pi * (hours - 6) / 24)
            + 0.2 * rng.standard_normal(len(ts)))
    share = extra.get("critical_load_share")
    if share is not None:
        ts["Critical Load (kW)"] = share * ts["Site Load (kW)"]
    return ts


def case_dict(cfg: dict, seed: int) -> dict:
    """The deployment as plain data: scenario, finance, DERs, streams,
    the time series and the load-shed curve.  The reference builds its
    LPs from this; :func:`case_params` hands the same to the program."""
    shed = cfg.get("load_shed_hours")
    ts = case_series(cfg, seed)
    scenario = copy.deepcopy(cfg["scenario"])
    if cfg.get("months"):
        # the first N calendar months only (the CPU tests' size)
        ts = ts.loc[ts.index.month <= cfg["months"]]
        scenario["allow_partial_year"] = True
    return {"scenario": scenario,
            "finance": copy.deepcopy(cfg["finance"]),
            "ders": [[tag, der_id, copy.deepcopy(keys)]
                     for tag, der_id, keys in cfg["ders"]],
            "streams": copy.deepcopy(cfg["streams"]),
            "time_series": ts,
            "load_shed": load_shed_curve(shed) if shed else None}


def sensitivity(case: dict, rule: dict, n_cases: int) -> list:
    """``n_cases`` copies of ``case`` with one DER key swept linearly over
    [lo, hi] x its configured value (a bounds-only fan-out, like DER-VET's
    Sensitivity-Parameters); the series are shared, as in one input file."""
    out = []
    for i in range(n_cases):
        c = dict(case, ders=copy.deepcopy(case["ders"]))
        for tag, _, keys in c["ders"]:
            if tag == rule["tag"]:
                keys[rule["key"]] = keys[rule["key"]] * (
                    rule["lo"] + (rule["hi"] - rule["lo"]) * i
                    / max(n_cases - 1, 1))
        out.append(c)
    return out


def case_params(case: dict, case_id: int, CaseParams, Datasets):
    """The program's case object for ``case`` (its ``io.params`` classes
    passed in, so that this module imports nothing of the program)."""
    data = Datasets(time_series=case["time_series"].copy())
    if case["load_shed"] is not None:
        data.load_shed = case["load_shed"]
    return CaseParams(case_id=case_id, scenario=copy.deepcopy(case["scenario"]),
                      finance=copy.deepcopy(case["finance"]), results={},
                      ders=[(t, i, copy.deepcopy(k)) for t, i, k in case["ders"]],
                      streams=copy.deepcopy(case["streams"]), datasets=data)


def stream_seed(*parts: int) -> int:
    """A 63-bit seed for one stream of draws, from the run's seed and the
    stream's position (pass, group, fan-out, ...)."""
    state = np.random.SeedSequence([int(p) & (2 ** 64 - 1) for p in parts]
                                   ).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])
