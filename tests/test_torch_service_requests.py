"""Design and Monte-Carlo requests through the port's scenario service
(``dervet_tpu_torch.design.service``, ``.stochastic.service``) against
the JAX package's service, on the CPU.

Fixtures are the JAX package's own 72-hour ``synthetic_case``
(``tests/test_design_service.py``, ``test_stochastic.py``).

* ``submit_design`` (12 candidates, top 3, one refinement round) on the
  port's service (``backend="torch", device="cpu"``) and the JAX
  service (``backend="jax"``): the same finalists, certified totals
  within the certificate's 2e-4, every finalist certified, the screen
  never certificate-stamped; a warm repeat builds no solver in either
  tier;
* ``submit_montecarlo`` (8 samples, seed 3): the same tiers, screening
  objectives within 1e-3 and certified ones within 2e-4; a warm repeat
  is byte-identical and builds nothing;
* a design request co-batches its finalists with a scenario request in
  the certified round; a shed design request gets the degraded frontier
  and a shed Monte-Carlo request the degraded distribution;
* ``design.json`` and ``montecarlo.json`` spool files serve through
  ``serve --once`` on the CPU device, and their parse errors are the
  JAX package's.
"""
import json

import numpy as np
import pandas as pd
import pytest
import torch

from dervet_tpu import benchlib as jax_benchlib
from dervet_tpu import design as jax_design
from dervet_tpu import stochastic as jax_mc
from dervet_tpu.service import ScenarioService as JaxService
from dervet_tpu_torch import benchlib, design, stochastic
from dervet_tpu_torch.design.frontier import DesignFrontier
from dervet_tpu_torch.design.service import (is_design_payload,
                                             parse_design_request)
from dervet_tpu_torch.service import ScenarioService
from dervet_tpu_torch.service.server import serve_main
from dervet_tpu_torch.stochastic.distribution import MCDistribution
from dervet_tpu_torch.stochastic.service import (is_montecarlo_payload,
                                                 parse_montecarlo_request)
from dervet_tpu_torch.utils.errors import ParameterError

torch.set_num_threads(2)

SCREEN_RTOL = 1e-3
CERT_RTOL = 2e-4
BOUNDS = {"kw": (500.0, 2500.0), "kwh": (1000.0, 9000.0)}


def _case(lib=benchlib, hours=72):
    c = lib.synthetic_case()
    c.scenario["allow_partial_year"] = True
    c.datasets.time_series = c.datasets.time_series.iloc[:hours]
    return c


def _design_spec(pkg=design, **over):
    base = dict(bounds={("Battery", "1"): pkg.DERBounds(**BOUNDS)},
                population=12, top_k=3, refine_rounds=1)
    base.update(over)
    return pkg.DesignSpec(**base)


def _mc_spec(pkg=stochastic, **over):
    base = dict(n_samples=8, seed=3, alpha=0.75, quantiles=(0.5,),
                screen_tier=0)
    base.update(over)
    return pkg.MCSpec(**base)


def _service(**kw):
    return ScenarioService(backend="torch", device="cpu", max_wait_s=0.0,
                           **kw)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


def _builds(svc):
    return (svc.solver_cache.builds,
            svc.design_caches.snapshot()["builds"])


@pytest.fixture(scope="module")
def served():
    """A design request, then a Monte-Carlo request, through each
    package's service; then the port's warm repeats of both."""
    out = {}
    for name, svc, pkgs in (
            ("jax", JaxService(backend="jax", max_wait_s=0.0),
             (jax_benchlib, jax_design, jax_mc)),
            ("torch", _service(), (benchlib, design, stochastic))):
        lib, dpkg, mpkg = pkgs
        fd = svc.submit_design(_case(lib), _design_spec(dpkg),
                               request_id="d1")
        assert svc.run_once() == 1
        fm = svc.submit_montecarlo(_case(lib), _mc_spec(mpkg),
                                   request_id="m1")
        assert svc.run_once() == 1
        out[name] = {"svc": svc, "design": fd.result(0),
                     "mc": fm.result(0)}
    svc = out["torch"]["svc"]
    before = _builds(svc)
    fd = svc.submit_design(_case(), _design_spec(), request_id="d2")
    svc.run_once()
    fm = svc.submit_montecarlo(_case(), _mc_spec(), request_id="m2")
    svc.run_once()
    out["repeat"] = {"design": fd.result(0), "mc": fm.result(0),
                     "builds": (before, _builds(svc))}
    yield out
    for name in ("jax", "torch"):
        out[name]["svc"].close()


def test_design_request_matches_jax(served):
    ours, ref = served["torch"]["design"], served["jax"]["design"]
    assert isinstance(ours, DesignFrontier)
    assert ours.request_id == "d1" and ours.fidelity == "certified"
    fa, fb = ours.frontier, ref.frontier
    assert list(fa["candidate"]) == list(fb["candidate"])
    assert len(fa) == 3
    assert ours.all_finalists_certified and ref.all_finalists_certified
    assert _rel(fa["total"], fb["total"]).max() < CERT_RTOL
    assert ours.screen["certification_stamped"] is False
    assert ours.run_health["certification"]["windows_certified"] == 3
    assert ours.solve_ledger["request_id"] == "d1"
    m = served["torch"]["svc"].metrics()["design"]
    assert m["requests"] == 2 and m["candidates"] == 24


def test_montecarlo_request_matches_jax(served):
    ours, ref = served["torch"]["mc"], served["jax"]["mc"]
    assert isinstance(ours, MCDistribution)
    assert ours.request_id == "m1" and ours.fidelity == "certified"
    a, b = ours.samples, ref.samples
    assert list(a["tier"]) == list(b["tier"])
    assert ours.tier_mix == ref.tier_mix
    screen = (b["tier"] == "screening").to_numpy()
    assert _rel(a["objective"][screen], b["objective"][screen]).max() \
        < SCREEN_RTOL
    assert _rel(a["objective"][~screen], b["objective"][~screen]).max() \
        < CERT_RTOL
    assert ours.pinning_all_certified and ref.pinning_all_certified
    m = served["torch"]["svc"].metrics()["monte_carlo"]
    assert m["requests"] == 2 and m["samples"] == 16


def test_warm_repeats_build_nothing(served):
    rep = served["repeat"]
    before, after = rep["builds"]
    assert after == before
    assert rep["mc"].to_json().replace('"m2"', '"m1"') == \
        served["torch"]["mc"].to_json()
    assert list(rep["design"].frontier["candidate"]) == \
        list(served["torch"]["design"].frontier["candidate"])
    assert rep["design"].all_finalists_certified
    svc = served["torch"]["svc"]
    assert svc.metrics()["monte_carlo"]["last"]["compile_events"] == 0


def test_design_finalists_cobatch_with_a_scenario_request():
    svc = _service()
    fs = svc.submit({0: _case()}, request_id="s1")
    fd = svc.submit_design(_case(), _design_spec(population=6, top_k=2,
                                                 refine_rounds=0),
                           request_id="d1")
    assert svc.run_once() == 2
    assert fd.result(0).all_finalists_certified
    res = fs.result(0)
    assert res.run_health["certification"]["windows_certified"] == 1
    shared = [g for g in svc.last_round_ledger["groups"]
              if set(g.get("requests") or ()) == {"s1", "d1"}]
    assert shared, svc.last_round_ledger["groups"]
    svc.close()


def test_shed_requests_are_degraded(monkeypatch):
    monkeypatch.setenv("DERVET_TPU_MC_DEGRADED_SAMPLES", "4")
    svc = _service(max_queue_depth=4, max_batch_requests=4,
                   shed_threshold_frac=0.5, shed_sustain_rounds=1)
    fd = svc.submit_design(_case(), _design_spec(population=6, top_k=2,
                                                 refine_rounds=0),
                           request_id="d0", priority=0)
    fm = svc.submit_montecarlo(_case(), _mc_spec(), request_id="m0",
                               priority=0)
    fs = svc.submit({0: _case()}, request_id="s1", priority=1)
    assert svc.run_once() == 3
    fr = fd.result(0)
    assert fr.fidelity == "degraded"
    assert not fr.frontier["certified"].any()
    mc = fm.result(0)
    assert mc.fidelity == "degraded" and mc.stats["n"] == 4
    assert not mc.samples["certified"].any()
    assert fs.result(0).fidelity == "certified"
    shed = svc.metrics()["resilience"]["load_shedding"]
    assert shed["degraded_by_kind"] == {"design": 1, "montecarlo": 1}
    svc.close()


def _write_params(d):
    ts = _case().datasets.time_series
    ts.set_axis(ts.index + pd.Timedelta(hours=1)).rename_axis(
        "Datetime (he)").to_csv(d / "ts.csv")
    rows = [
        ("Scenario", "", "dt", "1", "float"),
        ("Scenario", "", "opt_years", "[2017]", "list/int"),
        ("Scenario", "", "n", "month", "string/int"),
        ("Scenario", "", "start_year", "2017", "period"),
        ("Scenario", "", "end_year", "2017", "period"),
        ("Scenario", "", "allow_partial_year", "1", "bool"),
        ("Scenario", "", "incl_site_load", "1", "bool"),
        ("Scenario", "", "time_series_filename", str(d / "ts.csv"),
         "string"),
        ("Finance", "", "npv_discount_rate", "7", "float"),
        ("Finance", "", "inflation_rate", "3", "float"),
        ("Battery", "1", "ch_max_rated", "1000", "float"),
        ("Battery", "1", "dis_max_rated", "1000", "float"),
        ("Battery", "1", "ene_max_rated", "4000", "float"),
        ("Battery", "1", "rte", "85", "float"),
        ("Battery", "1", "llsoc", "5", "float"),
        ("Battery", "1", "ulsoc", "100", "float"),
        ("Battery", "1", "soc_target", "50", "float"),
        ("PV", "1", "rated_capacity", "3000", "float"),
        ("PV", "1", "curtail", "1", "bool"),
        ("DA", "", "growth", "0", "float"),
    ]
    df = pd.DataFrame(rows, columns=["Tag", "ID", "Key", "Value", "Type"])
    df["Active"] = "yes"
    df.to_csv(d / "params.csv", index=False)
    return d / "params.csv"


def test_design_and_montecarlo_json_serve_through_spool(tmp_path):
    params = _write_params(tmp_path)
    incoming = tmp_path / "spool" / "incoming"
    incoming.mkdir(parents=True)
    (incoming / "dz.json").write_text(json.dumps({"design": {
        "parameters": str(params), "kw": [500, 2500], "kwh": [1000, 9000],
        "population": 6, "top_k": 2, "refine_rounds": 0}}))
    (incoming / "mc.json").write_text(json.dumps({"montecarlo": {
        "parameters": str(params), "samples": 8, "seed": 3,
        "alpha": 0.75, "quantiles": [0.5]}}))
    rc = serve_main([str(tmp_path / "spool"), "--once", "--device", "cpu",
                     "--heartbeat-s", "0"])
    assert rc == 0
    out = tmp_path / "spool" / "results"
    assert (out / "dz" / "design_frontier.csv").exists()
    assert (out / "dz" / "run_health.dz.json").exists()
    assert (out / "mc" / "mc_distribution.json").exists()
    metrics = json.loads((tmp_path / "spool" / "service_metrics.json")
                         .read_text())
    assert metrics["requests"]["completed"] == 2
    assert metrics["design"]["requests"] == 1
    assert metrics["monte_carlo"]["requests"] == 1


def test_request_file_parsing_matches_jax(tmp_path):
    from dervet_tpu.design.service import \
        parse_design_request as jax_parse_design
    from dervet_tpu.stochastic.service import \
        parse_montecarlo_request as jax_parse_mc
    params = str(_write_params(tmp_path))
    assert is_design_payload({"design": {}})
    assert not is_design_payload([1, 2])
    assert is_montecarlo_payload({"montecarlo": {}})
    with pytest.raises(ParameterError, match="parameters"):
        parse_design_request({"design": {}})
    with pytest.raises(ParameterError, match="pair"):
        parse_design_request({"design": {"parameters": "x.csv",
                                         "kw": [1, 2, 3]}})
    d = {"design": {"parameters": params, "kw": [500, 2500],
                    "kwh": [1000, 9000], "population": 6, "top_k": 2}}
    (_, ours), (_, ref) = parse_design_request(d), jax_parse_design(d)
    assert ours.normalized() == ref.normalized()
    m = {"montecarlo": {"parameters": params, "samples": 16, "seed": 2}}
    (_, ours), (_, ref) = parse_montecarlo_request(m), jax_parse_mc(m)
    assert ours.normalized() == ref.normalized()
