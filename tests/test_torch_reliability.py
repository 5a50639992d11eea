"""Reliability's outage walks in the port against the JAX package's.

* ``simulate_all_outages`` against ``_simulate_all_outages`` on seeded
  numpy inputs (T = 200 starts, L = 12 steps, with a load-shed curve and
  a non-zero PV variability ``gamma``): coverage equal start for start,
  SOE profiles within rtol 1e-5 / atol 1e-4;
* ``min_soe_required`` against ``_min_soe_required``: ``inf`` (starts
  no state of energy covers) in the same places, finite values within
  1e-5 relative;
* a small Reliability case on both packages' ``backend="cpu"``: the
  reliability-driven sizing within 1e-6 relative, and the load-coverage
  and outage-contribution frames equal;
* the walks run where the dispatch runs, and without a GPU a ``torch``
  run refuses to start instead of walking on the CPU.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dervet_tpu.api import DERVET as JaxDERVET
from dervet_tpu.models.streams.reliability import (_min_soe_required,
                                                  _simulate_all_outages)
from dervet_tpu.scenario.scenario import MicrogridScenario as JaxScenario
from dervet_tpu_torch import benchlib
from dervet_tpu_torch.api import DERVET
from dervet_tpu_torch.models.streams.reliability import (min_soe_required,
                                                         simulate_all_outages)
from dervet_tpu_torch.scenario.scenario import MicrogridScenario
from test_torch_models import _jax_case

torch.set_num_threads(2)

T, L = 200, 12
RTOL, ATOL = 1e-5, 1e-4


def _inputs(seed, dt):
    """(T,) series, the shed curve and the fleet's scalars, seeded."""
    rng = np.random.default_rng(seed)
    crit = rng.uniform(0, 100, T)
    gen = np.full(T, 30.0)
    pv_max = rng.uniform(0, 60, T)
    pv_vari = pv_max * rng.uniform(0.7, 1.0, T)
    shed = np.maximum(1.0 - 0.05 * np.arange(L), 0.5)
    gamma = 0.43
    fleet = dict(ch_max=40.0, dis_max=50.0, e_min=10.0, e_max=200.0,
                 rte=0.85, dt=dt)
    init = rng.uniform(20.0, 200.0, T)
    return (crit, gen, pv_max, pv_vari, gamma, shed), fleet, init


@pytest.mark.parametrize("seed,dt", [(0, 1.0), (1, 1.0), (2, 0.5)])
def test_walk_matches_jax(seed, dt):
    series, fleet, init = _inputs(seed, dt)
    scalars = tuple(fleet.values()) + (L,)
    cov_j, prof_j = _simulate_all_outages(
        *series, jnp.asarray(init, jnp.float32), *scalars)
    cov_t, prof_t = simulate_all_outages(*series, init, *scalars,
                                         device="cpu")
    cov_j, prof_j = np.asarray(cov_j), np.asarray(prof_j)
    assert cov_t.dtype == torch.int64 and prof_t.dtype == torch.float32
    assert prof_t.shape == (T, L)
    # starts that die early, survive partway and survive every step
    assert 0 < (cov_j == L).sum() < T and (cov_j < L).any()
    np.testing.assert_array_equal(cov_t.numpy(), cov_j)
    np.testing.assert_allclose(prof_t.numpy(), prof_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed,dt", [(0, 1.0), (3, 1.0), (4, 0.5)])
def test_min_soe_matches_jax(seed, dt):
    series, fleet, _ = _inputs(seed, dt)
    scalars = tuple(fleet.values()) + (L,)
    ref = np.asarray(_min_soe_required(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a
          for a in series), *scalars))
    got = min_soe_required(*series, *scalars, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (T,)
    got = got.numpy()
    inf = np.isinf(ref)
    assert inf.any() and not inf.all()
    np.testing.assert_array_equal(np.isinf(got), inf)
    np.testing.assert_allclose(got[~inf], ref[~inf], rtol=RTOL, atol=0.0)


def _sizing_case():
    """A two-month microgrid with the battery sized for reliability."""
    case = benchlib.synthetic_case(multi_der=True, reliability=True)
    for tag, _, keys in case.ders:
        if tag == "Battery":
            keys.update(ene_max_rated=0.0, ch_max_rated=0.0,
                        dis_max_rated=0.0)
    ts = case.datasets.time_series
    case.datasets.time_series = ts.loc[ts.index.month <= 2]
    case.scenario["allow_partial_year"] = True
    return case


def test_sizing_module_matches_jax():
    case = _sizing_case()
    ref = JaxScenario(_jax_case(case))
    ours = MicrogridScenario(copy.deepcopy(case))
    assert ours.poi.is_sizing_optimization
    ref.sizing_module()
    ours.place_walks("cpu")
    ours.sizing_module()
    assert not ours.poi.is_sizing_optimization
    for a, b in zip(ours.ders, ref.ders):
        for attr in ("ene_max_rated", "ch_max_rated", "dis_max_rated"):
            if hasattr(b, attr):
                va, vb = getattr(a, attr), getattr(b, attr)
                assert abs(va - vb) <= 1e-6 * max(abs(vb), 1.0), attr
    bat = next(d for d in ours.ders if d.tag == "Battery")
    assert bat.ene_max_rated > 0
    pd.testing.assert_frame_equal(ours.streams["Reliability"].min_soe_df,
                                  ref.streams["Reliability"].min_soe_df)


@pytest.fixture(scope="module")
def solved_pair():
    cases = benchlib.synthetic_sensitivity_cases(1, months=2, multi_der=True,
                                                 reliability=True)
    jres = JaxDERVET.from_cases([_jax_case(c) for c in cases]).solve(
        backend="cpu")
    tres = DERVET.from_cases(cases).solve(backend="cpu", device="cpu")
    return jres, tres


def test_reports_match_jax(solved_pair):
    jres, tres = solved_pair
    (ji,), (ti,) = jres.instances.values(), tres.instances.values()
    rel_j = ji.scenario.streams["Reliability"]
    rel_t = ti.scenario.streams["Reliability"]
    assert rel_t.device == torch.device("cpu")
    for name in ("load_coverage_prob", "lcp_outage_soe_profiles",
                 "outage_energy_contributions"):
        pd.testing.assert_frame_equal(ti.drill_down_dict[name],
                                      ji.drill_down_dict[name])
    ts_j, ts_t = ji.time_series_data, ti.time_series_data
    pd.testing.assert_frame_equal(
        rel_t.load_coverage_probability(ti.scenario.ders, ts_t),
        rel_j.load_coverage_probability(ji.scenario.ders, ts_j))
    pd.testing.assert_frame_equal(
        rel_t.contribution_summary(ti.scenario.ders, ts_t),
        rel_j.contribution_summary(ji.scenario.ders, ts_j))
    lcp = ti.drill_down_dict["load_coverage_prob"]
    assert len(lcp) == 12
    p = lcp["Load Coverage Probability (%)"].to_numpy()
    assert (np.diff(p) <= 1e-12).all() and p[0] > p[-1]


def test_walks_follow_the_dispatch_device():
    case = benchlib.synthetic_case(reliability=True)
    scen = MicrogridScenario(case)
    scen.place_walks("torch", "cpu")
    assert scen.streams["Reliability"].device == torch.device("cpu")
    scen.place_walks("cpu", "cuda:0")
    assert scen.streams["Reliability"].device == torch.device("cpu")
    if torch.cuda.is_available():
        return
    # no GPU: a torch run with the default device refuses to start
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MicrogridScenario(benchlib.synthetic_case(
            reliability=True)).prepare_dispatch("torch")
