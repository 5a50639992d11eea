"""Synthetic Battery+PV+DA scenarios and the solve-ledger schema.

Builds a fully in-memory :class:`~.io.params.CaseParams` (no CSV files)
that runs through the real assembly path — DER constructors, POI, value
streams, window partitioning, LP builder — so tests and ``chip_smoke.py``
exercise exactly the code a user's case runs.  The same builders as the
JAX package's ``benchlib`` (same seeds, same data), plus a
``daily_cycle_limit`` option that adds the battery's per-day cycle rows
(the low-rank wide-row pair of a real monthly window).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import pandas as pd

from .io.params import CaseParams, Datasets


def synthetic_timeseries(year: int = 2017, dt: float = 1.0,
                         seed: int = 0) -> pd.DataFrame:
    """One year of hourly DA price / PV profile / site load."""
    start = pd.Timestamp(year=year, month=1, day=1)
    periods = int(round((pd.Timestamp(year=year + 1, month=1, day=1)
                         - start).total_seconds() / 3600 / dt))
    index = pd.date_range(start, periods=periods, freq=pd.Timedelta(hours=dt))
    rng = np.random.default_rng(seed)
    hours = index.hour.to_numpy() + index.dayofyear.to_numpy() * 24.0
    # $/kWh price: daily + seasonal swing, never negative
    price = (0.035 + 0.02 * np.sin(2 * np.pi * (index.hour - 16) / 24)
             + 0.005 * np.sin(2 * np.pi * hours / 8760)
             + 0.004 * rng.standard_normal(len(index)))
    price = np.maximum(price, 0.001)
    # PV per-rated-kW bell curve over daylight
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


def synthetic_case(year: int = 2017, n="month", dt: float = 1.0,
                   battery_kw: float = 2000.0, battery_kwh: float = 8000.0,
                   pv_kw: float = 3000.0, seed: int = 0,
                   daily_cycle_limit: float = 0.0) -> CaseParams:
    """Battery+PV+DA north-star case; ``daily_cycle_limit`` > 0 caps the
    battery's discharge energy per day at that many full cycles."""
    ts = synthetic_timeseries(year, dt, seed)
    scenario = {"dt": dt, "n": n, "opt_years": [year], "start_year": year,
                "end_year": year, "incl_site_load": True}
    battery = {"name": "bench_ess", "ch_max_rated": battery_kw,
               "dis_max_rated": battery_kw, "ene_max_rated": battery_kwh,
               "rte": 85.0, "llsoc": 5.0, "ulsoc": 100.0, "soc_target": 50.0,
               "OMexpenses": 0.5, "ccost_kwh": 100.0, "ccost_kw": 200.0}
    if daily_cycle_limit:
        battery["daily_cycle_limit"] = float(daily_cycle_limit)
    pv = {"name": "bench_pv", "rated_capacity": pv_kw, "curtail": True,
          "ccost_kW": 1000.0}
    return CaseParams(
        case_id=0, scenario=scenario,
        finance={"npv_discount_rate": 7.0, "inflation_rate": 3.0},
        results={}, ders=[("Battery", "1", battery), ("PV", "1", pv)],
        streams={"DA": {"growth": 0.0}},
        datasets=Datasets(time_series=ts),
    )


def synthetic_sensitivity_cases(n_cases: int, year: int = 2017,
                                n="month", dt: float = 1.0,
                                months: int = 0, seed: int = 0,
                                daily_cycle_limit: float = 0.0
                                ) -> List[CaseParams]:
    """A synthetic sensitivity fan-out: ``n_cases`` copies of the
    Battery+PV+DA case sweeping the battery energy rating (a bounds-only
    sweep, like the reference's Sensitivity-Parameters fan-out).
    ``months`` > 0 trims the horizon to the first N calendar months
    (``allow_partial_year``)."""
    import dataclasses
    out = []
    for i in range(n_cases):
        c = synthetic_case(year=year, n=n, dt=dt, seed=seed,
                           daily_cycle_limit=daily_cycle_limit)
        c = dataclasses.replace(c, case_id=i)
        for tag, _, keys in c.ders:
            if tag == "Battery":
                keys["ene_max_rated"] = 8000.0 * (0.8 + 0.8 * i
                                                  / max(n_cases - 1, 1))
        if months:
            ts = c.datasets.time_series
            c.datasets.time_series = ts.loc[ts.index.month <= months]
            c.scenario["allow_partial_year"] = True
        out.append(c)
    return out


def multi_der_window_lp(seed: int = 0):
    """The first monthly window LP (2233 x 5952) of the JAX package's
    ICE + CHP microgrid case (``synthetic_case(multi_der=True)`` there):
    this package's Battery + PV window plus an ICE (2 x 1 MW, fuel 2.5
    $/MMBtu at heat rate 11, O&M 0.004), a CHP (800 kW, O&M 0.003, 0.0015
    kW electric per BTU/hr of steam or hot water recovered) and the site's
    hot-water load, assembled here with ``LPBuilder`` because the ICE and
    CHP models are not ported yet.  The shape of the largest window the
    chunk kernels take (seven bands)."""
    from .ops.lp import LPBuilder
    from .scenario.scenario import MicrogridScenario
    case = synthetic_case(seed=seed)
    scen = MicrogridScenario(case)
    scen.prepare_dispatch("cpu")
    ctx = scen.windows[0]
    base = scen.build_window_lp(ctx, scen._annuity_scalar,
                                scen._requirements)
    T = ctx.T
    b = LPBuilder()
    refs = {name: b.var(name, r.size, base.l[r.sl], base.u[r.sl])
            for name, r in base.var_refs.items()}
    for name, r in base.var_refs.items():
        b.add_cost(refs[name], base.c[r.sl])
    price = base.c[base.var_refs["Battery-1/ch"].sl]
    ice = b.var("ICE-1/elec", T, 0.0, 2000.0)
    b.add_cost(ice, 2.5 * 11.0 + 0.004 - price)
    chp = b.var("CHP-1/elec", T, 0.0, 800.0)
    b.add_cost(chp, 0.003 - price)
    steam = b.var("CHP-1/steam", T, 0.0, np.inf)
    hot = b.var("CHP-1/hotwater", T, 0.0, np.inf)
    K = base.K.tocsr()
    for name, spans in base.row_groups.items():
        for r0, r1 in spans:
            b.add_rows(name, [(refs[v], K[r0:r1, r.sl])
                              for v, r in base.var_refs.items()],
                       "eq", base.q[r0:r1])
    b.add_rows("CHP-1/heat_recovery", [(chp, -1.0), (steam, 0.0015),
                                       (hot, 0.0015)], "eq", 0.0)
    # the hot-water load of the JAX package's case, year-long, sliced
    ts = case.datasets.time_series
    rng = np.random.default_rng(seed + 1)
    hours = ts.index.hour.to_numpy()
    load = 1e5 * (2.0 + np.sin(2 * np.pi * (hours - 6) / 24)
                  + 0.2 * rng.standard_normal(len(ts)))
    b.add_rows("thermal_hotwater", [(hot, 1.0)], "ge", load[:T])
    return b.build()


def fr_window_lp(seed: int = 0):
    """The first monthly window LP (3752 x 4464, ten bands and 31
    daily-cycle rows) of the Battery + PV case with ``daily_cycle_limit=1``
    bidding frequency regulation beside DA time-shift: FR up and down
    capacity at seeded prices of 10-15 $/MW-h, 0.5 h of energy
    reserved per awarded kW, 0.3 kWh/kW-h of expected throughput.  Its
    market rows make it the shape the chunk kernels take only in their
    shared-state configuration."""
    import dataclasses
    from .scenario.scenario import MicrogridScenario
    case = synthetic_case(seed=seed, daily_cycle_limit=1)
    ts = case.datasets.time_series.copy()
    rng = np.random.default_rng(seed + 3)
    for col in ("Reg Up Price ($/kW)", "Reg Down Price ($/kW)"):
        ts[col] = 0.01 + 0.005 * rng.random(len(ts))
    case = dataclasses.replace(
        case, streams={"DA": {"growth": 0.0},
                       "FR": {"growth": 0.0, "duration": 0.5, "eou": 0.3,
                              "eod": 0.3}},
        datasets=dataclasses.replace(case.datasets, time_series=ts))
    scen = MicrogridScenario(case)
    scen.prepare_dispatch("cpu")
    return scen.build_window_lp(scen.windows[0], scen._annuity_scalar,
                                scen._requirements)


def dense_block_lp(m: int = 200, n: int = 600, seed: int = 0):
    """An LP whose K has no band structure, so the solver keeps it as a
    dense op: n columns in [0, 1] with seeded costs, and m rows
    ``A x <= 0.25 A 1`` with every entry of A non-zero (uniform in
    [0.1, 1.1)).  Its compact forms (m n entries) are too large to stage
    in shared memory, so the dense chunk kernel takes it in its
    shared-state configuration."""
    from .ops.lp import LPBuilder
    rng = np.random.default_rng(seed)
    A = 0.1 + rng.random((m, n))
    b = LPBuilder()
    x = b.var("x", n, 0.0, 1.0)
    b.add_cost(x, -rng.random(n))
    b.add_rows("budget", [(x, A)], "le", 0.25 * A.sum(axis=1))
    return b.build()


# solve-ledger schema: the observable contract the tests and chip_smoke.py assert.
# Every group entry must carry the batch shape + wall clock; device
# entries additionally carry the device-traffic split and the kernel.
LEDGER_TOTALS_KEYS = (
    "solve_s", "stack_s", "h2d_s", "sync_wait_s", "result_fetch_s",
    "other_s", "h2d_bytes", "result_bytes", "dispatches", "chunks",
    "readbacks", "compile_events", "windows")
LEDGER_GROUP_KEYS = ("backend", "batch", "solve_s")
LEDGER_DEVICE_GROUP_KEYS = (
    "m", "n", "sharded", "staged", "stack_s", "iters_p50", "iters_p99",
    "iters_max", "dispatches", "chunks", "compile_events", "h2d_bytes",
    "h2d_s", "readbacks", "sync_wait_s", "result_fetch_s",
    "bucket_occupancy", "other_s",
    # solver-core observables (PR 11/12): step variant, restart
    # criterion, adaptive-restart count, realized check cadence
    "variant", "restart_scheme", "restarts", "cadence_final",
    # the chunk kernel the group rode and its launches
    "kernel", "kernel_launches")


def validate_solve_ledger(ledger: Dict) -> Dict:
    """Schema-check a ``solve_ledger`` dict (raises ``ValueError`` with
    the missing/invalid field named).  Returns the ledger unchanged so
    callers can chain it.  Checked here rather than in a test so the
    published ledger itself fails loudly on a malformed ledger."""
    if not isinstance(ledger, dict):
        raise ValueError(f"solve_ledger must be a dict, got {type(ledger)}")
    for k in ("groups", "totals", "dispatch_solve_s",
              "accounted_fraction", "pipeline", "max_inflight"):
        if k not in ledger:
            raise ValueError(f"solve_ledger missing {k!r}")
    if not isinstance(ledger["groups"], list) or not ledger["groups"]:
        raise ValueError("solve_ledger.groups must be a non-empty list")
    totals = ledger["totals"]
    for k in LEDGER_TOTALS_KEYS:
        if k not in totals:
            raise ValueError(f"solve_ledger.totals missing {k!r}")
        if not isinstance(totals[k], (int, float)):
            raise ValueError(f"solve_ledger.totals[{k!r}] not numeric")
    for i, g in enumerate(ledger["groups"]):
        for k in LEDGER_GROUP_KEYS:
            if k not in g:
                raise ValueError(f"solve_ledger.groups[{i}] missing {k!r}")
        if g.get("backend") != "cpu" and g.get("rung") != "cpu_fallback":
            for k in LEDGER_DEVICE_GROUP_KEYS:
                if k not in g:
                    raise ValueError(
                        f"solve_ledger.groups[{i}] (device) missing {k!r}")
    af = ledger["accounted_fraction"]
    if af is not None and not 0.0 <= af <= 2.0:
        raise ValueError(f"accounted_fraction out of range: {af}")
    # any variant-carrying group must be aggregated into solver_core
    if any(g.get("variant") for g in ledger["groups"]):
        core = ledger.get("solver_core")
        if not isinstance(core, dict):
            raise ValueError("solve_ledger missing 'solver_core' despite "
                             "variant-carrying groups")
        for k in ("variants", "restarts", "anchor_resets"):
            if k not in core:
                raise ValueError(f"solve_ledger.solver_core missing {k!r}")
    return ledger
