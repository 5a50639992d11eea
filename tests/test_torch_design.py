"""The port's design layer (``dervet_tpu_torch.design``, ``sizing``)
against the JAX package's, on the CPU.

Fixtures are the JAX package's own (``tests/test_design.py``): a 72-hour
``synthetic_case`` with ``allow_partial_year``, a population of 12 with
``top_k`` 3 and one refinement round.

* ``halton``, ``generate_population``, ``candidate_case`` and the
  screening solver options equal the JAX package's exactly;
* ``screen_candidates`` on the port's PDHG (``backend="torch",
  device="cpu"``, the kernels' plain versions) against the JAX package's
  ``backend="jax"``: the same ``converged`` flags and ``screen_round``,
  operating values within 1e-3 relative, and the same ``screen_rank``
  order between any two candidates whose totals differ by more than 1e-3
  relative;
* ``run_design``: the same finalists, certified totals within 2e-4
  relative, every finalist certified on both sides;
* ``sizing_sweep`` on a 2 x 2 grid with a duplicate pair: the same rows,
  operating values within 2e-4, the same best candidate;
* ``certify=False`` gives the JAX package's degraded frontier, and the
  refinement round seeds from round 0 even with a 2-entry warm-start
  memory;
* with ``backend="cpu"`` (exact HiGHS) on both sides,
  ``design_population.csv`` and ``design_frontier.csv`` are
  byte-identical.  ``design_frontier.json`` (its ``screen`` block holds
  wall-clock seconds and rates) and ``run_health*.json`` (wall-clock
  phase times) are left out;
* every entry point called with ``device=None`` raises where no GPU is
  visible, before it solves anything, and caches take a device by name.
"""
import dataclasses
import filecmp

import numpy as np
import pytest
import torch

from dervet_tpu import benchlib as jax_benchlib
from dervet_tpu import design as jax_design
from dervet_tpu import sizing as jax_sizing
from dervet_tpu.ops.pdhg import PDHGOptions as JaxOptions
from dervet_tpu_torch import benchlib, design, sizing
from dervet_tpu_torch.design import frontier as port_frontier
from dervet_tpu_torch.ops.pdhg import PDHGOptions

torch.set_num_threads(2)

BOUNDS = {"kw": (500.0, 2500.0), "kwh": (1000.0, 9000.0)}
SCREEN_RTOL = 1e-3      # screening tier: eps_rel 1e-2, hard budget
CERT_RTOL = 2e-4        # certified tier (eps_obj of the certificate)
TIE_RTOL = 1e-3         # totals closer than this may swap screen ranks


def _case(pkg, hours=72):
    c = pkg.synthetic_case()
    c.scenario["allow_partial_year"] = True
    c.datasets.time_series = c.datasets.time_series.iloc[:hours]
    return c


def _spec(pkg, **over):
    base = dict(bounds={("Battery", "1"): pkg.DERBounds(**BOUNDS)},
                population=12, top_k=3, refine_rounds=1)
    base.update(over)
    return pkg.DesignSpec(**base)


def _both_cases():
    return _case(benchlib), _case(jax_benchlib)


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


# ---------------------------------------------------------------------------
# Population and options: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,dims,skip", [(256, 3, 20), (12, 2, 20),
                                         (64, 12, 0)])
def test_halton_equal(n, dims, skip):
    assert np.array_equal(design.halton(n, dims, skip),
                          jax_design.halton(n, dims, skip))


@pytest.mark.parametrize("over", [
    {}, {"population": 64, "duration_hours": (1.0, 3.0)},
    {"population": 0, "refine_rounds": 0,
     "grid": [(1000, 4000), (500, 1000), (500, 1000), (1000, 4000)]},
    {"population": 5, "grid": [(700, 2000)]}],
    ids=["halton", "duration", "grid-dedupe", "halton+grid"])
def test_generate_population_equal(over):
    ours = design.generate_population(_spec(design, **over))
    ref = jax_design.generate_population(_spec(jax_design, **over))
    assert [(c.index, c.sizes, c.source) for c in ours] == \
        [(c.index, c.sizes, c.source) for c in ref]


def test_candidate_case_equal():
    port_case, jax_case = _both_cases()
    pop = design.generate_population(_spec(design))
    ref_pop = jax_design.generate_population(_spec(jax_design))
    for cand, ref_cand in zip(pop, ref_pop):
        a = design.candidate_case(port_case, cand, case_id="x")
        b = jax_design.candidate_case(jax_case, ref_cand, case_id="x")
        assert a.ders == b.ders
        assert a.case_id == b.case_id == "x"
        assert (a.scenario, a.finance, a.streams) == \
            (b.scenario, b.finance, b.streams)
        # frames are shared with the base case, holders are not
        assert a.datasets.time_series is port_case.datasets.time_series
        assert a.datasets is not port_case.datasets


def _same_options(ours, ref):
    """Every field of the port's options equals the JAX options' field
    of the same name (``dtype`` by name; the JAX-only fields
    ``pallas_chunk``, ``precision`` and ``chunk_iters`` have no
    counterpart)."""
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if f.name == "dtype":
            b = np.dtype(b).name
        assert a == b, (f.name, a, b)


@pytest.mark.parametrize("max_iters", [4096, 777])
def test_pdhg_screening_options_equal(max_iters):
    _same_options(PDHGOptions.screening(max_iters=max_iters),
                  JaxOptions.screening(max_iters=max_iters))
    base = PDHGOptions(eps_abs=1e-7, variant="halpern")
    ref_base = JaxOptions(eps_abs=1e-7, variant="halpern")
    _same_options(PDHGOptions.screening(base, max_iters=max_iters),
                  JaxOptions.screening(ref_base, max_iters=max_iters))


@pytest.mark.parametrize("tier", [0, 1, 2, 5])
def test_screening_tier_options_equal(tier):
    assert design.SCREEN_TIERS == jax_design.SCREEN_TIERS
    _same_options(design.screening_options(None, tier),
                  jax_design.screening_options(None, tier))
    _same_options(design.screening_options(PDHGOptions(), tier, "vanilla"),
                  jax_design.screening_options(JaxOptions(), tier,
                                               "vanilla"))


# ---------------------------------------------------------------------------
# The screen and the certified frontier: port PDHG vs the jax backend
# ---------------------------------------------------------------------------

def _assert_same_ranking(ours, ref):
    """``screen_rank`` agrees between every pair of candidates whose
    reference totals differ by more than TIE_RTOL relative."""
    r_a = ours.set_index("candidate")["screen_rank"]
    r_b = ref.set_index("candidate")["screen_rank"]
    tot = ref.set_index("candidate")["total"]
    idx = list(tot.index)
    for i in idx:
        for j in idx:
            gap = abs(tot[i] - tot[j]) / max(abs(tot[i]), abs(tot[j]))
            if i < j and gap > TIE_RTOL:
                assert (r_a[i] < r_a[j]) == (r_b[i] < r_b[j]), (i, j)


def test_screen_candidates_matches_jax():
    port_case, jax_case = _both_cases()
    ours = design.screen_candidates(
        port_case, design.generate_population(_spec(design)),
        backend="torch", device="cpu", refine_rounds=1, top_k=3).table()
    ref = jax_design.screen_candidates(
        jax_case, jax_design.generate_population(_spec(jax_design)),
        backend="jax", refine_rounds=1, top_k=3).table()
    assert list(ours["candidate"]) == list(ref["candidate"])
    assert list(ours["converged"]) == list(ref["converged"])
    assert ours["converged"].all()
    assert list(ours["screen_round"]) == list(ref["screen_round"])
    assert (ours["screen_round"] == 1).sum() >= 3
    assert _rel(ours["operating_value"], ref["operating_value"]).max() \
        < SCREEN_RTOL
    assert np.array_equal(ours["capex"], ref["capex"])
    _assert_same_ranking(ours, ref)


@pytest.fixture(scope="module")
def frontiers():
    port_case, jax_case = _both_cases()
    return (design.run_design(port_case, _spec(design), backend="torch",
                              device="cpu"),
            jax_design.run_design(jax_case, _spec(jax_design),
                                  backend="jax"))


def test_run_design_matches_jax(frontiers):
    ours, ref = frontiers
    fa, fb = ours.frontier, ref.frontier
    assert list(fa["candidate"]) == list(fb["candidate"])
    assert len(fa) == 3
    assert ours.all_finalists_certified and ref.all_finalists_certified
    assert _rel(fa["total"], fb["total"]).max() < CERT_RTOL
    assert _rel(fa["operating_value"], fb["operating_value"]).max() \
        < CERT_RTOL
    assert list(fa["dominated"]) == list(fb["dominated"])
    _assert_same_ranking(ours.population, ref.population)


def test_run_design_screen_is_ordinal_only(frontiers):
    ours, _ = frontiers
    assert ours.screen["certification_stamped"] is False
    assert ours.screen["candidates"] == 12
    # each round's candidates ride one batched group: fewer solver
    # dispatches than candidates
    assert [r["candidates"] for r in ours.screen["rounds"]] == [12, 3]
    assert all(r["device_groups"] == 1 and r["windows"] == r["candidates"]
               for r in ours.screen["rounds"])
    assert ours.screen["dispatches"] < 15
    cert = ours.run_health["certification"]
    assert cert["windows"]["rejected_final"] == 0
    assert cert["windows_certified"] == 3
    ledger = ours.solve_ledger
    assert all(g["device"] == "cpu" for g in ledger["groups"]
               if g.get("backend") == "torch")


def test_sizing_sweep_matches_jax():
    port_case, jax_case = _both_cases()
    kw, kwh = [1000, 2000, 1000], [4000, 8000]
    ours = sizing.sizing_sweep(port_case, kw, kwh, device="cpu")
    ref = jax_sizing.sizing_sweep(jax_case, kw, kwh)
    assert list(zip(ours.kW, ours.kWh)) == list(zip(ref.kW, ref.kWh)) == [
        (1000.0, 4000.0), (1000.0, 8000.0), (2000.0, 4000.0),
        (2000.0, 8000.0)]
    assert ours.converged.all() and ref.converged.all()
    assert _rel(ours.operating_value, ref.operating_value).max() \
        < CERT_RTOL
    assert np.array_equal(ours.capex, ref.capex)
    assert ours.total.idxmin() == ref.total.idxmin()


def test_cpu_backend_artifacts_byte_identical(tmp_path):
    port_case, jax_case = _both_cases()
    spec = dict(population=8, top_k=2)
    ours = design.run_design(port_case, _spec(design, **spec),
                             backend="cpu")
    ref = jax_design.run_design(jax_case, _spec(jax_design, **spec),
                                backend="cpu")
    ours.save_as_csv(tmp_path / "torch")
    ref.save_as_csv(tmp_path / "jax")
    names = ["design_population.csv", "design_frontier.csv"]
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "torch", names, shallow=False)
    assert match == names, (mismatch, errors)
    assert ours.all_finalists_certified


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["run_design", "screen_candidates",
                                   "certify_finalists", "sizing_sweep"])
def test_device_none_raises_without_gpu(no_gpu, entry, monkeypatch):
    from dervet_tpu_torch.design import screen as port_screen
    solved = []
    monkeypatch.setattr(port_screen, "run_dispatch",
                        lambda *a, **k: solved.append(a))
    monkeypatch.setattr(port_frontier, "run_dispatch",
                        lambda *a, **k: solved.append(a))
    case = _case(benchlib)
    pop = design.generate_population(_spec(design, population=2))
    calls = {
        "run_design": lambda: design.run_design(
            case, _spec(design, population=2, top_k=1)),
        "screen_candidates": lambda: design.screen_candidates(case, pop),
        "certify_finalists": lambda: design.certify_finalists(case, []),
        "sizing_sweep": lambda: sizing.sizing_sweep(case, [1000], [4000]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert not solved


def test_refinement_round_seeds_with_a_small_memory(monkeypatch):
    """With the warm-start memory capped at 2 entries, the screen raises
    the cap to hold every window of the population, so the refinement
    round seeds each survivor from its round-0 iterate (the JAX package
    keeps the cap, and a full-year 512-candidate screen evicts round 0's
    6,144 windows before round 1 looks them up)."""
    monkeypatch.setenv("DERVET_TPU_WARMSTART_CAP", "2")
    caches = design.ScreeningCaches(pad_grid=True)
    report = design.screen_candidates(
        _case(benchlib), design.generate_population(_spec(design)),
        backend="torch", device="cpu", caches=caches, refine_rounds=1,
        top_k=3)
    r0, r1 = report.rounds
    assert (r0["seeded"], r0["cold"]) == (0, 12)
    assert (r1["seeded"], r1["cold"]) == (3, 0)
    assert caches.memory.stats["evictions"] == 0
    assert caches.memory.max_entries >= 2 * 12


def test_degraded_design_is_the_screen_uncertified():
    """``certify=False`` (the load-shed tier) returns the screening order
    as the frontier, uncertified, as the JAX package's does."""
    port_case, jax_case = _both_cases()
    spec = dict(population=8, top_k=2, refine_rounds=0)
    ours = design.run_design(port_case, _spec(design, **spec),
                             device="cpu", certify=False)
    ref = jax_design.run_design(jax_case, _spec(jax_design, **spec),
                                backend="jax", certify=False)
    assert ours.fidelity == ref.fidelity == "degraded"
    assert ours.resubmit_hint is not None
    assert not ours.frontier["certified"].any()
    assert ours.rank_correlation == 1.0
    assert list(ours.frontier["candidate"]) == \
        list(ref.frontier["candidate"])


def test_caches_take_a_device_name():
    """Caches handed a device by name resolve it: the dispatch pipeline
    stages each group onto ``cache.device`` and needs a torch.device."""
    caches = design.ScreeningCaches(device="cpu")
    assert caches.tier(0).device == torch.device("cpu")
    report = design.screen_candidates(
        _case(benchlib), design.generate_population(
            _spec(design, population=4)),
        device="cpu", caches=caches, refine_rounds=0, top_k=1)
    assert len(report.converged) == 4
