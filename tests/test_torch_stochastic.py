"""The port's Monte-Carlo layer (``dervet_tpu_torch.stochastic``) against
the JAX package's, on the CPU.

Fixtures are the JAX package's own (``tests/test_stochastic.py``): a
72-hour ``synthetic_case`` with ``allow_partial_year`` and an MC spec of
8 samples, seed 3, alpha 0.75, the median pinned.

* ``sample_seed`` and ``sample_case``'s time series are byte-equal for the
  same (seed, index); ``cvar``, ``distribution_stats`` and
  ``pinning_positions`` equal exactly;
* ``run_montecarlo`` on the port's PDHG (``backend="torch",
  device="cpu"``) against the JAX package's ``backend="jax"``: per-sample
  screening objectives within 1e-3 relative, the same pinned samples,
  pinned certified objectives within 2e-4;
* the port alone: a rerun and a run in reversed sample order on shared
  caches serialize a byte-identical ``to_json()`` (also with a warm-start
  memory cap of 2), and the published statistics recompute from the
  published samples to 1e-9;
* with ``backend="cpu"`` (exact HiGHS) on both sides, ``mc_samples.csv``
  and ``mc_distribution.json`` are byte-identical (``run_health*.json``,
  which carries wall-clock times, is left out);
* the risk-aware design mode's per-finalist mean and CVaR agree within
  1e-3, and the screening-only (degraded) answer matches the JAX
  package's;
* ``run_montecarlo`` and ``evaluate_finalist_risk`` called with
  ``device=None`` raise where no GPU is visible.
"""
import filecmp

import numpy as np
import pytest
import torch

from dervet_tpu import benchlib as jax_benchlib
from dervet_tpu import design as jax_design
from dervet_tpu import stochastic as jax_mc
from dervet_tpu.stochastic.distribution import \
    pinning_positions as jax_pinning
from dervet_tpu_torch import benchlib, design, stochastic as mc
from dervet_tpu_torch.scenario.scenario import SolverCache
from dervet_tpu_torch.stochastic import engine as port_engine
from dervet_tpu_torch.stochastic.distribution import pinning_positions

torch.set_num_threads(2)

SCREEN_RTOL = 1e-3
CERT_RTOL = 2e-4


def _case(pkg, hours=72, seed=0):
    c = pkg.synthetic_case(seed=seed)
    c.scenario["allow_partial_year"] = True
    c.datasets.time_series = c.datasets.time_series.iloc[:hours]
    return c


def _spec(pkg, **over):
    base = dict(n_samples=8, seed=3, alpha=0.75, quantiles=(0.5,),
                screen_tier=0)
    base.update(over)
    return pkg.MCSpec(**base)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


# ---------------------------------------------------------------------------
# Sampler and distribution math: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,idx", [(0, 0), (3, 5), (7, 1023),
                                      (2 ** 40, 17)])
def test_sample_case_time_series_byte_equal(seed, idx):
    assert mc.sample_seed(seed, idx) == jax_mc.sample_seed(seed, idx)
    ours = mc.sample_case(_case(benchlib), _spec(mc, seed=seed), idx)
    ref = jax_mc.sample_case(_case(jax_benchlib), _spec(jax_mc, seed=seed),
                             idx)
    a, b = ours.datasets.time_series, ref.datasets.time_series
    assert list(a.columns) == list(b.columns)
    assert a.index.equals(b.index)
    assert a.to_numpy().tobytes() == b.to_numpy().tobytes()
    assert ours.case_id == ref.case_id


def test_spec_surface_equal():
    d = {"samples": 64, "seed": 2, "quantiles": [0.1, 0.9], "alpha": 0.9}
    ours = mc.sampler.mc_spec_from_dict(d)
    ref = jax_mc.sampler.mc_spec_from_dict(d)
    assert ours.normalized() == ref.normalized()
    assert mc.MCSpec().normalized() == jax_mc.MCSpec().normalized()


@pytest.mark.parametrize("n,alpha", [(8, 0.75), (1024, 0.95), (33, 0.5)])
def test_distribution_math_equal(n, alpha):
    rng = np.random.default_rng(n)
    v = rng.lognormal(9.0, 0.3, n)
    v[n // 3] = v[n // 2]       # a tie
    q = (0.05, 0.25, 0.5, 0.75, 0.95)
    assert mc.cvar(v, alpha) == jax_mc.cvar(v, alpha)
    assert mc.distribution_stats(v, alpha, q) == \
        jax_mc.distribution_stats(v, alpha, q)
    assert pinning_positions(v, q, alpha) == jax_pinning(v, q, alpha)


# ---------------------------------------------------------------------------
# The engine: port PDHG vs the jax backend
# ---------------------------------------------------------------------------

def test_run_montecarlo_matches_jax():
    ours = mc.run_montecarlo(_case(benchlib), _spec(mc), backend="torch",
                             device="cpu")
    ref = jax_mc.run_montecarlo(_case(jax_benchlib), _spec(jax_mc),
                                backend="jax")
    a, b = ours.samples, ref.samples
    assert list(a["sample"]) == list(b["sample"]) == list(range(8))
    assert list(a["tier"]) == list(b["tier"])
    assert ours.tier_mix == ref.tier_mix
    assert ours.tier_mix["certified"] >= 2
    screen = (b["tier"] == "screening").to_numpy()
    assert _rel(a["objective"][screen], b["objective"][screen]).max() \
        < SCREEN_RTOL
    assert _rel(a["objective"][~screen], b["objective"][~screen]).max() \
        < CERT_RTOL
    assert ours.pinning_all_certified and ref.pinning_all_certified
    assert not ours.engine["certification_stamped_screening"]
    assert [r["tier"] for r in ours.engine["rounds"]] == \
        ["screening", "certified"]


@pytest.mark.parametrize("cap,window", [(None, "month"), ("2", "month"),
                                        ("2", 6)],
                         ids=["default-cap", "cap-2", "cap-2-12-windows"])
def test_replay_byte_identical(cap, window, monkeypatch):
    """Fixed seed: a rerun and a reversed sample order on shared caches
    serialize byte-identical, and the warm repeat builds no solver; with
    a warm-start memory capped at 2 entries the engine raises the cap so
    every window of the batch stays resident — also when a sample has 12
    windows (6-hour windows of the 72 hours; the JAX package's floor of
    2 x samples + 64 evicts there and the replay drifts ~3.5e-4)."""
    if cap is not None:
        monkeypatch.setenv("DERVET_TPU_WARMSTART_CAP", cap)
    case, spec = _case(benchlib), _spec(mc)
    case.scenario["n"] = window
    caches = design.ScreeningCaches(pad_grid=True)
    final = SolverCache(pad_grid=True, memory=caches.memory)

    def run(**kw):
        return mc.run_montecarlo(case, spec, backend="torch", device="cpu",
                                 caches=caches, final_cache=final,
                                 request_id="det", **kw)

    r1 = run()
    r2 = run()
    r3 = run(sample_order=list(reversed(range(spec.n_samples))))
    assert r1.to_json() == r2.to_json() == r3.to_json()
    windows = r1.engine["rounds"][0]["windows"]
    assert windows == spec.n_samples * (12 if window == 6 else 1)
    assert caches.memory.max_entries >= 2 * windows
    assert caches.memory.stats["evictions"] == 0
    assert r2.engine["compile_events"] == 0
    assert r1.pinning_all_certified
    # the rerun's screening windows all ship from the solution memory
    screen = r2.engine["rounds"][0]
    assert screen["tier"] == "screening"
    assert screen["substituted"] == screen["windows"] == windows


def test_stats_recompute_from_published_samples():
    r = mc.run_montecarlo(_case(benchlib), _spec(mc, seed=5),
                          backend="torch", device="cpu")
    v = np.array([row["objective"] for row in r.as_dict()["samples"]])
    assert len(v) == r.stats["n"]
    s = np.sort(v)
    k = int(np.ceil(round(0.25 * len(v), 12)))
    assert r.stats["cvar_alpha"] == pytest.approx(s[-k:].mean(), rel=1e-9)
    assert r.stats["mean"] == pytest.approx(v.mean(), rel=1e-9)
    assert r.stats["quantiles"]["p50"] == pytest.approx(np.median(v),
                                                        rel=1e-9)


def test_cpu_backend_artifacts_byte_identical(tmp_path):
    ours = mc.run_montecarlo(_case(benchlib), _spec(mc), backend="cpu")
    ref = jax_mc.run_montecarlo(_case(jax_benchlib), _spec(jax_mc),
                                backend="cpu")
    ours.save_as_csv(tmp_path / "torch")
    ref.save_as_csv(tmp_path / "jax")
    names = ["mc_samples.csv", "mc_distribution.json"]
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "torch", names, shallow=False)
    assert match == names, (mismatch, errors)
    assert ours.to_json() == ref.to_json()


def test_risk_aware_design_matches_jax():
    bounds = {"kw": (500.0, 2500.0), "kwh": (1000.0, 9000.0)}
    risk = {"samples": 4, "seed": 1, "alpha": 0.75}

    def spec(pkg):
        return pkg.DesignSpec(
            bounds={("Battery", "1"): pkg.DERBounds(**bounds)},
            population=8, top_k=2, refine_rounds=0, risk=risk)

    ours = design.run_design(_case(benchlib), spec(design),
                             backend="torch", device="cpu").frontier
    ref = jax_design.run_design(_case(jax_benchlib), spec(jax_design),
                                backend="jax").frontier
    assert list(ours["candidate"]) == list(ref["candidate"])
    assert list(ours["mc_samples"]) == list(ref["mc_samples"]) == [4, 4]
    for col in ("mc_mean", "mc_cvar"):
        assert _rel(ours[col], ref[col]).max() < SCREEN_RTOL, col
    assert (ours["mc_cvar"] >= ours["mc_mean"]).all()


def test_screening_only_is_degraded_and_never_stamped(monkeypatch):
    """``certify_tier=False`` (the CLI's ``--screening-only``, the
    load-shed tier): a reduced sample count at the screening tier, marked
    degraded, nothing certified — the JAX package's contract."""
    monkeypatch.setenv("DERVET_TPU_MC_DEGRADED_SAMPLES", "4")
    ours = mc.run_montecarlo(_case(benchlib), _spec(mc), device="cpu",
                             certify_tier=False)
    ref = jax_mc.run_montecarlo(_case(jax_benchlib), _spec(jax_mc),
                                backend="jax", certify_tier=False)
    assert ours.fidelity == ref.fidelity == "degraded"
    assert ours.tier_mix == ref.tier_mix == {
        "screening": 4, "certified": 0, "quarantined": 0}
    assert not ours.samples["certified"].any()
    assert [r["tier"] for r in ours.engine["rounds"]] == ["screening"]
    assert not ours.engine["certification_stamped_screening"]
    assert _rel(ours.samples["objective"], ref.samples["objective"]).max() \
        < SCREEN_RTOL


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["run_montecarlo",
                                   "evaluate_finalist_risk"])
def test_device_none_raises_without_gpu(no_gpu, entry, monkeypatch):
    solved = []
    monkeypatch.setattr(port_engine, "run_dispatch",
                        lambda *a, **k: solved.append(a))
    case, spec = _case(benchlib), _spec(mc)
    calls = {
        "run_montecarlo": lambda: mc.run_montecarlo(case, spec),
        "evaluate_finalist_risk": lambda: port_engine.evaluate_finalist_risk(
            case, [], spec),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert not solved
