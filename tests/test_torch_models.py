"""The port's DER and value-stream models against the JAX package's.

Each fixture is one small case (two monthly windows) built once as a
``dervet_tpu_torch`` case and converted field for field into a
``dervet_tpu`` case, so both packages see the same dicts and frames:

* window LPs (``K``, ``c``, ``q``, ``l``, ``u``, ``n_eq``) byte-equal for
  every DER tag and value-stream tag the registries accept;
* the demand-charge window's operator is a ``DenseOp`` (its peak
  variables are dense columns, so the banded split is incomplete);
* ``backend="cpu"`` (exact HiGHS) writes byte-identical CSVs for the
  multi-DER + Reliability and the retail + DCM fan-outs;
* the port's ``backend="torch", device="cpu"`` against the JAX package's
  ``backend="jax"``: every window certified on both sides, per-window
  objectives within the float64 certificate's objective tolerance
  (``eps_obj`` = 2e-4 relative).
"""
import copy
import dataclasses
import filecmp

import numpy as np
import pandas as pd
import pytest
import torch

from dervet_tpu.api import DERVET as JaxDERVET
from dervet_tpu.io import params as jax_params
from dervet_tpu.models.streams import registry as jax_stream_registry
from dervet_tpu.scenario.scenario import MicrogridScenario as JaxScenario
from dervet_tpu.scenario.scenario import _build_tech_map as jax_tech_map
from dervet_tpu_torch import benchlib
from dervet_tpu_torch.api import DERVET
from dervet_tpu_torch.models.streams import registry
from dervet_tpu_torch.ops import pdhg
from dervet_tpu_torch.scenario.scenario import MicrogridScenario
from dervet_tpu_torch.scenario.scenario import _build_tech_map

torch.set_num_threads(2)

MONTHS = 2
EPS_OBJ = 2e-4      # ops/certify.CertPolicy.eps_obj


def _monthly(**cols) -> pd.DataFrame:
    idx = pd.MultiIndex.from_product([[2017], range(1, 13)],
                                     names=["Year", "Month"])
    return pd.DataFrame({k: np.broadcast_to(v, 12).astype(float)
                         for k, v in cols.items()}, index=idx)


def _trim(case, months=MONTHS):
    ts = case.datasets.time_series
    case.datasets.time_series = ts.loc[ts.index.month <= months]
    case.scenario["allow_partial_year"] = True
    return case


def _with(der=None, streams=None, columns=None, monthly=None, **kw):
    """``synthetic_case(**kw)`` with a DER added, streams added, time-series
    columns added (callables of the frame) and a monthly frame."""
    case = benchlib.synthetic_case(**kw)
    ts = case.datasets.time_series
    for name, fn in (columns or {}).items():
        ts[name] = fn(ts)
    if der is not None:
        case.ders.append(der)
    case.streams.update(streams or {})
    if monthly is not None:
        case.datasets.monthly = monthly
    return _trim(case)


def _hourly(a, b):
    return lambda ts: a + b * np.sin(2 * np.pi * ts.index.hour / 24)


FIXTURES = {
    "multi_der_thermal": lambda: _trim(benchlib.synthetic_case(
        multi_der=True)),
    "retail_dcm": lambda: _trim(benchlib.synthetic_case(retail=True)),
    # without the load-shed curve (the fan-outs below carry it)
    "reliability": lambda: _trim(benchlib.synthetic_case(
        multi_der=True, reliability=True, load_shed=False)),
    "diesel_genset": lambda: _with(("DieselGenset", "1", {
        "name": "genset", "rated_capacity": 750.0, "n": 2,
        "efficiency": 0.07, "fuel_cost": 3.0, "variable_om_cost": 0.01,
        "ccost_kW": 500.0})),
    "ct": lambda: _with(("CT", "1", {
        "name": "ct", "rated_capacity": 1500.0, "heat_rate": 9000.0,
        "variable_om_cost": 0.005, "ccost_kW": 700.0}),
        monthly=_monthly(**{"Natural Gas Price ($/MillionBTU)": 3.5})),
    "ev1": lambda: _with(("ElectricVehicle1", "1", {
        "name": "ev1", "ch_max_rated": 60.0, "ch_min_rated": 5.0,
        "ene_target": 150.0, "plugin_time": 18, "plugout_time": 7,
        "ccost": 5000.0, "fixed_om": 100.0})),
    "ev2": lambda: _with(("ElectricVehicle2", "1", {
        "name": "fleet", "max_load_ctrl": 40.0, "lost_load_cost": 0.5,
        "ccost": 1000.0, "fixed_om": 50.0}),
        columns={"EV fleet": _hourly(300.0, 150.0)}),
    "controllable_load": lambda: _with(("Load", "1", {
        "name": "site", "power_rating": 400.0, "duration": 4.0})),
    "caes": lambda: _with(("CAES", "1", {
        "name": "caes", "ch_max_rated": 1500.0, "dis_max_rated": 1500.0,
        "ene_max_rated": 12000.0, "rte": 70.0, "llsoc": 10.0,
        "ulsoc": 100.0, "soc_target": 50.0, "heat_rate_high": 4000.0,
        "OMexpenses": 1.0, "ccost_kwh": 50.0, "ccost_kw": 300.0}),
        monthly=_monthly(**{"Natural Gas Price ($/MillionBTU)": 3.5})),
    "backup": lambda: _with(streams={"Backup": {}}, monthly=_monthly(**{
        "Backup Energy (kWh)": 2000.0, "Backup Price ($/kWh)": 0.02})),
    "deferral": lambda: _with(streams={"Deferral": {
        "price": 50000.0, "growth": 2.0, "planned_load_limit": 6000.0,
        "reverse_power_flow_limit": -3000.0, "min_year_objective": 0}},
        columns={"Deferral Load (kW)": _hourly(5500.0, 800.0)}),
    "dr": lambda: _with(streams={"DR": {
        "days": 3, "length": 4, "program_start_hour": 15,
        "program_end_hour": None, "weekend": 0, "day_ahead": 1,
        "growth": 0.0}}, monthly=_monthly(**{
            "DR Capacity (kW)": 500.0, "DR Capacity Price ($/kW)": 5.0,
            "DR Energy Price ($/kWh)": 0.1, "DR Months (y/n)": 1.0})),
    "ra": lambda: _with(streams={"RA": {
        "days": 2, "length": 4, "idmode": "peak by month", "dispmode": 1,
        "growth": 0.0}}, monthly=_monthly(**{
            "RA Capacity Price ($/kW)": 4.0})),
    "user": lambda: _with(streams={"User": {"price": 1000.0}}, columns={
        "Aggregate Energy Min (kWh)": lambda ts: np.full(len(ts), 1000.0),
        "Aggregate Energy Max (kWh)": lambda ts: np.full(len(ts), 7000.0)}),
    "volt": lambda: _with(streams={"Volt": {}}, columns={
        "VAR Reservation (%)": _hourly(20.0, 10.0)}),
    "markets": lambda: _with(streams={
        "FR": {"growth": 0.0, "duration": 0.5, "eou": 0.3, "eod": 0.3},
        "SR": {"growth": 0.0, "duration": 1.0},
        "NSR": {"growth": 0.0, "duration": 1.0},
        "LF": {"growth": 0.0, "duration": 0.5}}, columns={
            col: _hourly(0.012, 0.004) for col in (
                "Reg Up Price ($/kW)", "Reg Down Price ($/kW)",
                "SR Price ($/kW)", "NSR Price ($/kW)", "LF Up Price ($/kW)",
                "LF Down Price ($/kW)")}),
}


def _jax_case(case):
    """The same case as a ``dervet_tpu`` CaseParams (deep copies: a
    scenario writes into its datasets)."""
    case = copy.deepcopy(case)
    fields = {f.name: getattr(case, f.name)
              for f in dataclasses.fields(case)}
    fields["datasets"] = jax_params.Datasets(**vars(case.datasets))
    return jax_params.CaseParams(**fields)


def _window_lps(scen):
    scen.prepare_dispatch("cpu")
    return [scen.build_window_lp(ctx, scen._annuity_scalar,
                                 scen._requirements)
            for ctx in scen.windows]


def test_registries_cover_the_jax_tags():
    assert sorted(_build_tech_map()) == sorted(jax_tech_map())
    assert sorted(registry()) == sorted(jax_stream_registry())
    tags = {t for f in FIXTURES.values() for c in [f()]
            for t in [d[0] for d in c.ders] + list(c.streams)}
    assert tags == set(_build_tech_map()) | set(registry())


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_window_lps_byte_equal(name):
    case = FIXTURES[name]()
    ref = _window_lps(JaxScenario(_jax_case(case)))
    ours = _window_lps(MicrogridScenario(copy.deepcopy(case)))
    assert len(ours) == len(ref) == MONTHS
    for a, b in zip(ours, ref):
        assert (a.m, a.n, a.n_eq) == (b.m, b.n, b.n_eq)
        for part in ("data", "indices", "indptr"):
            assert getattr(a.K, part).tobytes() == \
                getattr(b.K, part).tobytes(), part
        for v in ("c", "q", "l", "u"):
            assert getattr(a, v).tobytes() == getattr(b, v).tobytes(), v


def test_reliability_bounds_the_state_of_energy():
    """The Reliability fixture's windows carry the min-SOE rows (one a
    step) on top of the multi-DER window."""
    (base,) = _window_lps(MicrogridScenario(FIXTURES["multi_der_thermal"]())
                          )[:1]
    (rel,) = _window_lps(MicrogridScenario(FIXTURES["reliability"]()))[:1]
    T = 744
    assert (rel.m, rel.n) == (base.m + T, base.n)
    assert "sysreq_energy_min" in rel.row_groups


def test_dcm_window_is_a_dense_op():
    """Each month's peak variable touches every masked hour, a dense
    column: ``make_op`` then takes the whole window dense."""
    lp = _window_lps(MicrogridScenario(FIXTURES["retail_dcm"]()))[0]
    col_nnz = np.diff(lp.K.tocsc().indptr)
    assert col_nnz.max() == 744
    op = pdhg.CompiledLPSolver(lp, pdhg.PDHGOptions(), device="cpu").op
    assert isinstance(op, pdhg.DenseOp)
    assert tuple(op.Kh.shape) == (lp.m, lp.n)


FANOUTS = {"microgrid": dict(multi_der=True, reliability=True),
           "retail": dict(retail=True)}


def _fanout(jax_side, kind, months=MONTHS, n="month"):
    cases = benchlib.synthetic_sensitivity_cases(2, months=months, n=n,
                                                 **FANOUTS[kind])
    return [_jax_case(c) for c in cases] if jax_side else cases


@pytest.mark.parametrize("kind", sorted(FANOUTS))
def test_cpu_backend_csvs_byte_identical(kind, tmp_path):
    dirs = []
    for api, jax_side, kw in ((JaxDERVET, True, {}),
                              (DERVET, False, {"device": "cpu"})):
        res = api.from_cases(_fanout(jax_side, kind)).solve(backend="cpu",
                                                            **kw)
        d = tmp_path / ("jax" if jax_side else "torch")
        res.save_as_csv(d)
        dirs.append(d)
    dj, dt = dirs
    names = sorted(p.name for p in dt.iterdir()
                   if not p.name.startswith("run_health"))
    ref = sorted(p.name for p in dj.iterdir()
                 if not p.name.startswith("run_health"))
    assert names == ref and len(names) > 5
    if kind == "microgrid":
        assert any(n.startswith("load_coverage_prob") for n in names)
    else:
        assert any(n.startswith("adv_monthly_bill") for n in names)
    match, mismatch, errors = filecmp.cmpfiles(dj, dt, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


# One month each: the microgrid in its monthly windows; the retail case in
# daily windows, whose demand-charge windows take the same dense operator
# path — its monthly windows need 25-45k iterations, ~100 s on two CPU
# threads.
@pytest.mark.parametrize("kind,n", [("microgrid", "month"), ("retail", 24)])
def test_pdhg_backends_agree(kind, n):
    jres = JaxDERVET.from_cases(_fanout(True, kind, 1, n)).solve(
        backend="jax")
    tres = DERVET.from_cases(_fanout(False, kind, 1, n)).solve(
        backend="torch", device="cpu")
    n_windows = sum(len(i.objective_values) for i in jres.instances.values())
    assert n_windows == (2 if n == "month" else 62)
    for res in (jres, tres):
        cert = res.run_health["certification"]["windows"]
        assert cert["certified"] + cert["certified_loose"] == n_windows, cert
        assert res.run_health["windows"]["cpu_fallback"] == 0
        assert res.run_health["invariant_audit"]["ok"]
    for key, inst in tres.instances.items():
        ours = inst.objective_values["Total Objective"]
        ref = jres.instances[key].objective_values["Total Objective"]
        assert list(ours.index) == list(ref.index)
        rel = (ours - ref).abs() / (1.0 + ref.abs())
        assert rel.max() <= EPS_OBJ, rel
