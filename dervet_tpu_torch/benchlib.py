"""Synthetic DER scenarios and the solve-ledger schema.

Builds a fully in-memory :class:`~.io.params.CaseParams` (no CSV files)
that runs through the real assembly path — DER constructors, POI, value
streams, window partitioning, LP builder — so tests and ``chip_smoke.py``
exercise exactly the code a user's case runs.  The same builders as the
JAX package's ``benchlib`` (same seeds, same data, the same ICE + CHP
microgrid), plus options that package's builders lack: the battery's
per-day cycle rows (``daily_cycle_limit``, the low-rank wide-row pair of
a real monthly window), a retail time-of-use tariff with demand charges
(``retail``), and the Reliability stream on a critical load with a
load-shed curve (``reliability``).

The north-star price sweep (a year of monthly windows x N lognormal
price scenarios, batched per window-length group) is built from
:func:`build_window_lps` and drawn by :func:`scenario_price_batch` (host)
or :func:`scenario_price_batch_device` (on the cost matrix's own device).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

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


def synthetic_tariff() -> pd.DataFrame:
    """A time-of-use retail tariff in the reference's ``tariff.csv``
    layout (hour-ending times, inclusive): an all-hours energy rate, an
    on-peak energy adder on weekdays 12-20 h, a monthly all-hours demand
    charge and an on-peak demand charge on the same hours."""
    rows = [(1, 24, 2, 0.08, "energy", "all hours"),
            (13, 20, 1, 0.06, "energy", "on-peak adder"),
            (1, 24, 2, 10.0, "demand", "monthly peak"),
            (13, 20, 1, 15.0, "demand", "on-peak peak")]
    return pd.DataFrame({
        "Billing Period": np.arange(1, len(rows) + 1),
        "Start Month": 1, "End Month": 12,
        "Start Time": [r[0] for r in rows], "End Time": [r[1] for r in rows],
        "Excluding Start Time": np.nan, "Excluding End Time": np.nan,
        "Weekday?": [r[2] for r in rows], "Value": [r[3] for r in rows],
        "Charge": [r[4] for r in rows],
        "Name (optional)": [r[5] for r in rows],
    }).set_index("Billing Period")


def load_shed_curve(hours: int = 24) -> pd.DataFrame:
    """Percent of the critical load an outage must serve, by outage hour:
    all of it for 4 h, then 10 points less every 4 h down to 50%."""
    h = np.arange(1, hours + 1)
    return pd.DataFrame({"Outage Length (hrs)": h,
                         "Load Shed (%)": np.maximum(
                             100.0 - 10.0 * ((h - 1) // 4), 50.0)})


def synthetic_case(year: int = 2017, n="month", dt: float = 1.0,
                   battery_kw: float = 2000.0, battery_kwh: float = 8000.0,
                   pv_kw: float = 3000.0, seed: int = 0,
                   daily_cycle_limit: float = 0.0, multi_der: bool = False,
                   retail: bool = False, reliability: bool = False,
                   load_shed: bool = True) -> CaseParams:
    """Battery+PV+DA north-star case.

    * ``daily_cycle_limit`` > 0 caps the battery's discharge energy per
      day at that many full cycles;
    * ``multi_der`` adds the JAX package's ICE (2 x 1 MW) and CHP (800 kW)
      with the site's hot-water load (its ``synthetic_case(multi_der=
      True)``, key for key);
    * ``retail`` bills the site on :func:`synthetic_tariff` with
      retailTimeShift + DCM in place of DA;
    * ``reliability`` adds a critical load (50% of the site load) and the
      Reliability stream: 4 h target, outages walked up to 12 h from a
      full battery, with :func:`load_shed_curve` when ``load_shed``."""
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
    ders = [("Battery", "1", battery), ("PV", "1", pv)]
    if multi_der:
        ders.append(("ICE", "1", {
            "name": "bench_ice", "rated_capacity": 1000.0, "n": 2,
            "efficiency": 11.0, "fuel_cost": 2.5, "variable_om_cost": 0.004,
            "fixed_om_cost": 10.0, "ccost_kW": 600.0}))
        ders.append(("CHP", "1", {
            "name": "bench_chp", "rated_capacity": 800.0, "n": 1,
            # kW electric per BTU/hr of recovered heat (reference unit
            # convention)
            "electric_heat_ratio": 0.0015, "fuel_cost": 2.0,
            "variable_om_cost": 0.003, "ccost_kW": 900.0}))
        scenario["incl_thermal_load"] = True
        rng = np.random.default_rng(seed + 1)
        hours = ts.index.hour.to_numpy()
        # within the CHP's recoverable heat: 800 kW / 0.0015 = 533 kBTU/hr
        ts["Site Hot Water Thermal Load (BTU/hr)"] = 1e5 * (
            2.0 + np.sin(2 * np.pi * (hours - 6) / 24)
            + 0.2 * rng.standard_normal(len(ts)))
    streams = {"DA": {"growth": 0.0}}
    datasets = Datasets(time_series=ts)
    if retail:
        streams = {"retailTimeShift": {"growth": 0.0},
                   "DCM": {"growth": 0.0}}
        datasets.tariff = synthetic_tariff()
    if reliability:
        ts["Critical Load (kW)"] = 0.5 * ts["Site Load (kW)"]
        streams["Reliability"] = {
            "target": 4.0, "max_outage_duration": 12.0,
            "post_facto_only": 0, "post_facto_initial_soc": 100.0,
            "n-2": 0, "load_shed_percentage": int(load_shed)}
        if load_shed:
            datasets.load_shed = load_shed_curve()
    return CaseParams(
        case_id=0, scenario=scenario,
        finance={"npv_discount_rate": 7.0, "inflation_rate": 3.0},
        results={}, ders=ders, streams=streams, datasets=datasets)


def synthetic_sensitivity_cases(n_cases: int, year: int = 2017,
                                n="month", dt: float = 1.0,
                                months: int = 0, seed: int = 0,
                                daily_cycle_limit: float = 0.0,
                                multi_der: bool = False,
                                retail: bool = False,
                                reliability: bool = False
                                ) -> List[CaseParams]:
    """A synthetic sensitivity fan-out: ``n_cases`` copies of
    :func:`synthetic_case` sweeping the battery energy rating (a
    bounds-only sweep, like the reference's Sensitivity-Parameters
    fan-out).  ``months`` > 0 trims the horizon to the first N calendar
    months (``allow_partial_year``)."""
    import dataclasses
    out = []
    for i in range(n_cases):
        c = synthetic_case(year=year, n=n, dt=dt, seed=seed,
                           daily_cycle_limit=daily_cycle_limit,
                           multi_der=multi_der, retail=retail,
                           reliability=reliability)
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


def widen_sensitivity_csv(src, out_path, n_cases: int,
                          lo: float = 0.8, hi: float = 1.6):
    """Rewrite a model-parameters CSV so the Battery's ``ene_max_rated``
    fans out to ``n_cases`` Sensitivity-Parameters values spanning
    [lo, hi] x the stock rating.  Returns ``out_path``."""
    df = pd.read_csv(src)
    sel = (df.Tag == "Battery") & (df.Key == "ene_max_rated")
    # older inputs name the value column 'Value'
    val_col = "Optimization Value" if "Optimization Value" in df.columns \
        else "Value"
    base = float(df.loc[sel, val_col].iloc[0])
    vals = np.linspace(lo, hi, n_cases) * base
    # the column is all-NaN float64 in a stock input; make it object
    # before writing a list string into it
    df["Sensitivity Parameters"] = df["Sensitivity Parameters"].astype(object)
    df.loc[sel, "Sensitivity Parameters"] = \
        "[" + ", ".join(f"{v:.1f}" for v in vals) + "]"
    df.loc[sel, "Sensitivity Analysis"] = "yes"
    df.to_csv(out_path, index=False)
    return out_path


def window_lps(case):
    """Every window LP of ``case``, in order, as a run assembles them
    (the CPU backend's preparation)."""
    from .scenario.scenario import MicrogridScenario
    scen = MicrogridScenario(case)
    scen.prepare_dispatch("cpu")
    return [scen.build_window_lp(ctx, scen._annuity_scalar,
                                 scen._requirements)
            for ctx in scen.windows]


def build_window_lps(case: CaseParams, pad_to_max: bool = False
                     ) -> Tuple["MicrogridScenario", Dict[int, List]]:
    """Every window LP of ``case`` (prepared as :func:`window_lps`
    prepares them), grouped by window length: ``(scenario, {T: [LP,
    ...]})``.

    ``pad_to_max=True`` extends every shorter window with inert steps up
    to the longest window's length, so that all windows share one
    constraint structure and the 28/30/31-day groups collapse into one
    batched solve.  The padding is exact only when padded steps are
    truly inert: no self-discharge (the tail SOE pin needs ene[t+1] ==
    ene[t]), no fixed O&M or house power (constants that scale with the
    window's length), no EV sessions and no calendar-month-keyed streams
    (their structure would differ across the padded boundary).  Those
    raise ``ValueError``."""
    import dataclasses
    from .scenario.scenario import MicrogridScenario

    scen = MicrogridScenario(case)
    windows = scen.windows
    real_T = {ctx.label: ctx.T for ctx in windows}
    if pad_to_max:
        for d in scen.ders:
            bad = [a for a in ("sdr", "hp", "fixed_om_per_kw", "fixed_om")
                   if getattr(d, a, 0)]
            if bad or d.tag.startswith("ElectricVehicle"):
                raise ValueError(
                    f"pad_to_max: {d.name} has {bad or 'EV sessions'} — "
                    "padded steps would not be inert")
        cal_keyed = {"DCM", "retailTimeShift"} & set(scen.streams)
        if cal_keyed:
            raise ValueError(f"pad_to_max: {sorted(cal_keyed)} key their "
                             "structure by calendar month — padding would "
                             "diverge across the boundary")
        T_max = max(ctx.T for ctx in windows)
        freq = pd.Timedelta(hours=scen.dt)

        def pad(ctx):
            extra = T_max - ctx.T
            if extra <= 0:
                return ctx
            ext = pd.date_range(ctx.index[-1] + freq, periods=extra,
                                freq=freq)
            ts = pd.concat([ctx.ts,
                            pd.DataFrame(0.0, index=ext,
                                         columns=ctx.ts.columns)])
            return dataclasses.replace(ctx, index=ts.index, ts=ts)

        windows = [pad(ctx) for ctx in windows]
    scen.prepare_dispatch("cpu")
    groups: Dict[int, List] = {}
    for ctx in windows:
        lp = scen.build_window_lp(ctx, scen._annuity_scalar,
                                  scen._requirements)
        start = real_T[ctx.label]
        if ctx.T > start:
            # padded steps must be inert: every dispatch variable pins to
            # zero there (otherwise the window-exit SOE pin moves past the
            # real month and the battery refills for free at the padded
            # zero price).  SOE stays free: with dispatch zeroed it is
            # constant through the tail
            for name, ref in lp.var_refs.items():
                if ref.size == ctx.T and not name.endswith("/ene"):
                    lp.l[ref.sl][start:] = 0.0
                    lp.u[ref.sl][start:] = 0.0
            # the tail SOE is determined (dispatch zeroed, exit pin at the
            # window target); pinning its bounds removes the cost-free
            # floating block that otherwise stalls PDHG's duals
            for der in scen.ders:
                target = getattr(der, "ene_target", None)
                if target is None:
                    continue
                name = der.vname("ene")
                if name in lp.var_refs:
                    sl = lp.var_refs[name].sl
                    lp.l[sl][start:] = target
                    lp.u[sl][start:] = target
        groups.setdefault(ctx.T, []).append(lp)
    if pad_to_max:
        (lps,) = groups.values()
        keys = {MicrogridScenario._structure_key(lp) for lp in lps}
        if len(keys) != 1:
            raise ValueError("pad_to_max: padded windows did not collapse "
                             "to one constraint structure")
    return scen, groups


# the sweep's lognormal price noise: log-multipliers ~ N(0, PRICE_SIGMA^2)
PRICE_SIGMA = 0.15


def scenario_price_batch(lp, n_scenarios: int, seed: int = 0) -> np.ndarray:
    """(n_scenarios, n) per-scenario cost vectors: every non-zero cost
    coefficient (the hourly price terms on charge, discharge and
    generation) gets its own lognormal noise, so each scenario is a
    different LP with a different optimal dispatch (a single global
    multiplier would leave the argmin unchanged)."""
    rng = np.random.default_rng(seed)
    mult = rng.lognormal(mean=0.0, sigma=PRICE_SIGMA,
                         size=(n_scenarios, lp.n))
    return np.where(lp.c[None, :] != 0.0, mult * lp.c[None, :], 0.0)


def _window_seed(seed: int, window: int) -> int:
    """The 63-bit seed of window ``window``'s stream under ``seed``: each
    window of a group draws from a stream of its own."""
    state = np.random.SeedSequence([int(seed), int(window)]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def scenario_price_batch_device(c_stack, n_scenarios: int, seed: int = 0):
    """The price sweep of :func:`scenario_price_batch`'s distribution for a
    whole window group, drawn on ``c_stack``'s own device: ``c_stack`` is
    an (n_windows, n) tensor of base costs, the result the
    (n_windows * n_scenarios, n) tensor of draws, window-major.  Window
    ``i`` draws from a ``torch.Generator`` of its own, seeded by
    :func:`_window_seed` (seed, i); zero costs stay zero.  The cost matrix
    never visits the host: only the seeds cross."""
    import torch
    w, n = c_stack.shape
    z = torch.empty((w, n_scenarios, n), dtype=c_stack.dtype,
                    device=c_stack.device)
    for i in range(w):
        gen = torch.Generator(device=c_stack.device)
        gen.manual_seed(_window_seed(seed, i))
        z[i].normal_(generator=gen)
    c = c_stack[:, None, :]
    out = torch.where(c != 0.0, torch.exp(PRICE_SIGMA * z) * c,
                      torch.zeros((), dtype=c.dtype, device=c.device))
    return out.reshape(w * n_scenarios, n)


def multi_der_window_lp(seed: int = 0):
    """The first monthly window LP (2233 x 5952) of the ICE + CHP
    microgrid case (``synthetic_case(multi_der=True)``, the JAX package's
    case key for key): the Battery + PV window plus an ICE (2 x 1 MW,
    fuel 2.5 $/MMBtu at heat rate 11, O&M 0.004), a CHP (800 kW, O&M
    0.003, 0.0015 kW electric per BTU/hr of steam or hot water recovered)
    and the site's hot-water load.  The shape of the largest window the
    chunk kernels take in a register configuration (seven bands)."""
    return window_lps(synthetic_case(seed=seed, multi_der=True))[0]


def fr_window_lp(seed: int = 0):
    """The first monthly window LP (3752 x 4464, ten bands and 31
    daily-cycle rows) of the Battery + PV case with ``daily_cycle_limit=1``
    bidding frequency regulation beside DA time-shift: FR up and down
    capacity at seeded prices of 10-15 $/MW-h, 0.5 h of energy
    reserved per awarded kW, 0.3 kWh/kW-h of expected throughput.  Its
    market rows make it the shape the chunk kernels take only in their
    shared-state configuration."""
    import dataclasses
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
    return window_lps(case)[0]


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


def validate_telemetry_section(snap: Dict) -> Dict:
    """Schema-check a telemetry registry snapshot
    (``MetricsRegistry.snapshot()``) before it is published: the fixed
    histogram layout (the cross-replica merge contract), internally
    consistent bucket counts, and numeric counter and gauge values.
    Raises ``ValueError`` naming the violation; returns the snapshot
    unchanged so callers can chain it."""
    from .telemetry import registry as _registry
    if not isinstance(snap, dict):
        raise ValueError(f"telemetry section must be a dict, "
                         f"got {type(snap)}")
    for k in ("counters", "gauges", "histograms", "hist_bounds", "t"):
        if k not in snap:
            raise ValueError(f"telemetry section missing {k!r}")
    if int(snap["hist_bounds"]) != len(_registry.HIST_BOUNDS):
        raise ValueError(
            f"telemetry hist_bounds {snap['hist_bounds']} != the fixed "
            f"layout's {len(_registry.HIST_BOUNDS)} — merges across "
            "replicas would be wrong")
    for name, v in snap["counters"].items():
        if not isinstance(v, (int, float)) or v < 0:
            raise ValueError(f"telemetry counter {name!r} not a "
                             f"non-negative number: {v!r}")
    for name, v in snap["gauges"].items():
        if not isinstance(v, (int, float)):
            raise ValueError(f"telemetry gauge {name!r} not numeric: "
                             f"{v!r}")
    for name, h in snap["histograms"].items():
        for k in ("count", "sum", "buckets", "overflow"):
            if k not in h:
                raise ValueError(f"telemetry histogram {name!r} "
                                 f"missing {k!r}")
        if len(h["buckets"]) != len(_registry.HIST_BOUNDS):
            raise ValueError(
                f"telemetry histogram {name!r} has {len(h['buckets'])} "
                f"buckets, expected {len(_registry.HIST_BOUNDS)}")
        if sum(h["buckets"]) + h["overflow"] != h["count"]:
            raise ValueError(
                f"telemetry histogram {name!r} bucket counts "
                f"({sum(h['buckets'])} + {h['overflow']} overflow) do "
                f"not sum to count {h['count']}")
    return snap
