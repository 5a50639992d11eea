"""The port's north-star sweep builders against the JAX package's, on
the same inputs (``bench.py``'s workload: a year of monthly windows x
lognormal price scenarios, one batched solve a window-length group).

* ``build_window_lps`` gives byte-equal groups (keys, c, q, l, u, K's CSR
  arrays, ``var_refs``) for the Battery + PV + DA case and the ICE + CHP
  microgrid, unfused and with ``pad_to_max=True``; its guards raise in
  both packages; the padded February and April windows keep their
  optimum on HiGHS (within 1e-9, the JAX package's own bar);
* ``scenario_price_batch`` gives the same bytes for the same seed;
  ``scenario_price_batch_device`` (on CPU tensors here) lays its draws
  out window-major, keeps zero costs at zero, repeats for a seed, and
  draws log-multipliers of mean 0 and deviation 0.15 within 2e-3, as
  the JAX draw does at the same shapes (a different generator: the bits
  differ, the layout and the law do not);
* the first 31-day window x 8 scenarios solved by both packages'
  ``CompiledLPSolver``: the same statuses, objectives within the float64
  certificate's objective tolerance (2e-4 relative), iterations within
  one check window (128); ``solve_lp`` likewise on a small LP; the ICE +
  CHP case's September window runs past 6,144 iterations in both where
  April's converges, and in its February window both solvers' answers
  are rejected by the float64 certificate on the same instances, each on
  the CHP heat-recovery row;
* ``widen_sensitivity_csv`` writes the same bytes;
  ``validate_telemetry_section`` accepts and refuses the same snapshots.
"""
import copy
import dataclasses

import numpy as np
import pandas as pd
import pytest
import torch

from dervet_tpu import benchlib as jax_benchlib
from dervet_tpu.io import params as jax_params
from dervet_tpu.ops import lp as jax_lp
from dervet_tpu.ops import pdhg as jpdhg
from dervet_tpu.telemetry import registry as jax_registry
from dervet_tpu_torch import benchlib
from dervet_tpu_torch.ops import certify, cpu_ref, pdhg
from dervet_tpu_torch.ops import lp as port_lp
from dervet_tpu_torch.scenario.scenario import MicrogridScenario
from dervet_tpu_torch.telemetry import registry as port_registry

torch.set_num_threads(2)

PACKAGES = {"jax": jax_benchlib, "torch": benchlib}
# |mean| and |std - 0.15| of the log-multipliers (2e-3 is over eight
# standard errors of the mean at these sample counts)
LAW_TOL = 2e-3
# the float64 certificate's objective tolerance (CertPolicy.eps_obj)
OBJ_RTOL = certify.CertPolicy().eps_obj
CHECK_EVERY = pdhg.PDHGOptions().check_every


def _jax_case(case):
    """The same case as a ``dervet_tpu`` CaseParams, field by field."""
    case = copy.deepcopy(case)
    fields = {f.name: getattr(case, f.name)
              for f in dataclasses.fields(case)}
    fields["datasets"] = jax_params.Datasets(**vars(case.datasets))
    return jax_params.CaseParams(**fields)


def _refs(lp):
    return [(name, r.start, r.size) for name, r in lp.var_refs.items()]


@pytest.mark.parametrize("multi_der,pad", [(False, False), (False, True),
                                           (True, False)],
                         ids=["bands", "bands-padded", "multi-der"])
def test_build_window_lps_byte_equal(multi_der, pad):
    _, ours = benchlib.build_window_lps(
        benchlib.synthetic_case(multi_der=multi_der), pad_to_max=pad)
    _, ref = jax_benchlib.build_window_lps(
        jax_benchlib.synthetic_case(multi_der=multi_der), pad_to_max=pad)
    assert list(ours) == list(ref)
    assert sorted(ours) == ([744] if pad else [672, 720, 744])
    for T in ref:
        assert len(ours[T]) == len(ref[T])
        for a, b in zip(ours[T], ref[T]):
            assert (a.m, a.n, a.n_eq) == (b.m, b.n, b.n_eq)
            for part in ("data", "indices", "indptr"):
                assert getattr(a.K, part).tobytes() == \
                    getattr(b.K, part).tobytes(), (T, part)
            for v in ("c", "q", "l", "u"):
                assert getattr(a, v).tobytes() == getattr(b, v).tobytes(), \
                    (T, v)
            assert _refs(a) == _refs(b)


def _sdr_case(pkg):
    case = pkg.synthetic_case()
    for tag, _, keys in case.ders:
        if tag == "Battery":
            keys["sdr"] = 0.5
    return case


GUARD_CASES = {
    "sdr": (lambda: _sdr_case(benchlib),
            lambda: _sdr_case(jax_benchlib), "sdr"),
    "dcm": (lambda: benchlib.synthetic_case(retail=True),
            lambda: _jax_case(benchlib.synthetic_case(retail=True)),
            "calendar month"),
    "fixed-om": (lambda: benchlib.synthetic_case(multi_der=True),
                 lambda: jax_benchlib.synthetic_case(multi_der=True),
                 "fixed_om"),
}


@pytest.mark.parametrize("name", sorted(GUARD_CASES))
def test_pad_to_max_guards_raise_in_both(name):
    ours, ref, match = GUARD_CASES[name]
    with pytest.raises(ValueError, match=match):
        benchlib.build_window_lps(ours(), pad_to_max=True)
    with pytest.raises(ValueError, match=match):
        jax_benchlib.build_window_lps(ref(), pad_to_max=True)


def test_padded_windows_keep_their_optimum():
    """The port's twin of the JAX package's padding test: one structure
    for all twelve months, and February and April (the two padded
    lengths) with the optimum of their plain windows on HiGHS."""
    _, fused = benchlib.build_window_lps(benchlib.synthetic_case(),
                                         pad_to_max=True)
    assert list(fused) == [744] and len(fused[744]) == 12
    keys = {MicrogridScenario._structure_key(lp) for lp in fused[744]}
    assert len(keys) == 1
    plain = benchlib.window_lps(benchlib.synthetic_case())
    for label in (1, 3):
        assert plain[label].n < fused[744][label].n
        a = cpu_ref.solve_lp_cpu(plain[label]).obj
        b = cpu_ref.solve_lp_cpu(fused[744][label]).obj
        assert abs(a - b) / max(1.0, abs(a)) < 1e-9


@pytest.fixture(scope="module")
def groups():
    return benchlib.build_window_lps(benchlib.synthetic_case())[1]


@pytest.mark.parametrize("seed", [0, 23])
def test_scenario_price_batch_byte_equal(groups, seed):
    lp = groups[744][0]
    ours = benchlib.scenario_price_batch(lp, 16, seed)
    ref = jax_benchlib.scenario_price_batch(lp, 16, seed)
    assert ours.shape == (16, lp.n)
    assert ours.tobytes() == ref.tobytes()


def _c_stack(groups, w=3):
    c = np.stack([lp.c for lp in groups[744][:w]]).astype(np.float32)
    c[1, :200] = 0.0        # another zero pattern in window 1
    return torch.as_tensor(c)


def test_price_batch_device_layout(groups):
    c = _c_stack(groups)
    n_scen = 5
    out = benchlib.scenario_price_batch_device(c, n_scen, seed=7)
    assert out.shape == (3 * n_scen, c.shape[1])
    assert out.device == c.device and out.dtype == c.dtype
    for i in range(3):
        block = out[i * n_scen:(i + 1) * n_scen]
        assert torch.equal(block == 0, (c[i] == 0).expand_as(block))
        nz = c[i] != 0
        assert torch.all(torch.sign(block[:, nz]) == torch.sign(c[i, nz]))
    # each window draws from a stream of its own
    first = benchlib.scenario_price_batch_device(c[:1], n_scen, seed=7)
    assert torch.equal(first, out[:n_scen])


def test_price_batch_device_seeded(groups):
    c = _c_stack(groups)
    a = benchlib.scenario_price_batch_device(c, 4, seed=31)
    b = benchlib.scenario_price_batch_device(c, 4, seed=31)
    d = benchlib.scenario_price_batch_device(c, 4, seed=43)
    assert torch.equal(a, b)
    nz = (c != 0).repeat_interleave(4, dim=0)
    assert not torch.equal(a[nz], d[nz])


def _log_mult(out, c, n_scen):
    c = np.repeat(np.asarray(c, np.float64), n_scen, axis=0)
    nz = c != 0
    return np.log(np.asarray(out, np.float64)[nz] / c[nz])


def test_price_batch_device_law_matches_jax(groups):
    import jax.numpy as jnp
    c = _c_stack(groups, w=2)
    n_scen = 128
    ours = _log_mult(benchlib.scenario_price_batch_device(c, n_scen, 5)
                     .numpy(), c.numpy(), n_scen)
    ref = _log_mult(jax_benchlib.scenario_price_batch_device(
        jnp.asarray(c.numpy()), n_scen, 5), c.numpy(), n_scen)
    assert ours.size == ref.size > 100_000
    for z in (ours, ref):
        assert abs(z.mean()) < LAW_TOL
        assert abs(z.std() - benchlib.PRICE_SIGMA) < LAW_TOL
    assert abs(ours.mean() - ref.mean()) < LAW_TOL
    assert abs(ours.std() - ref.std()) < LAW_TOL


def test_first_window_sweep_matches_jax():
    """The first 31-day window x 8 price scenarios (seed 23), as the JAX
    package's sharded Monte-Carlo test builds it, on both solvers."""
    _, ours = benchlib.build_window_lps(benchlib.synthetic_case())
    _, ref = jax_benchlib.build_window_lps(jax_benchlib.synthetic_case())
    plp, jlp = ours[744][0], ref[744][0]
    C = benchlib.scenario_price_batch(plp, 8, seed=23)
    jr = jpdhg.CompiledLPSolver(
        jlp, jpdhg.PDHGOptions(pallas_chunk=False)).solve(c=C)
    pr = pdhg.CompiledLPSolver(plp, pdhg.PDHGOptions(),
                               device="cpu").solve(c=C)
    np.testing.assert_array_equal(np.asarray(jr.status), pr.status.numpy())
    assert np.all(pr.status.numpy() == pdhg.STATUS_CONVERGED)
    jobj, pobj = np.asarray(jr.obj, np.float64), pr.obj.numpy()
    np.testing.assert_allclose(pobj, jobj, rtol=OBJ_RTOL)
    ji, pi = np.asarray(jr.iters), pr.iters.numpy()
    assert np.all(np.abs(ji - pi) <= CHECK_EVERY), (ji, pi)
    for i in range(8):
        cert = certify.certify_solution(
            dataclasses.replace(plp, c=C[i]), pr.x[i].numpy(),
            float(pr.obj[i]), y=pr.y[i].numpy())
        assert cert.accepted, cert.reason


def test_september_microgrid_tail_in_both():
    """The ICE + CHP case's September window (the third 30-day month)
    runs a long iteration tail in both packages' solvers: at 6,144
    iterations neither has converged any of 4 price scenarios, while
    both converge all 4 of April's (about 5,100-5,300 iterations, as
    the microgrid's other windows)."""
    kw = dict(cpu_rescue_after=None, max_iters=6144)
    _, ours = benchlib.build_window_lps(
        benchlib.synthetic_case(multi_der=True))
    _, ref = jax_benchlib.build_window_lps(
        jax_benchlib.synthetic_case(multi_der=True))
    for w, month in ((0, "April"), (2, "September")):
        plp, jlp = ours[720][w], ref[720][w]
        C = benchlib.scenario_price_batch(plp, 4, seed=23)
        jr = jpdhg.CompiledLPSolver(
            jlp, jpdhg.PDHGOptions(pallas_chunk=False, **kw)).solve(c=C)
        pr = pdhg.CompiledLPSolver(plp, pdhg.PDHGOptions(**kw),
                                   device="cpu").solve(c=C)
        conv = pr.converged.numpy()
        np.testing.assert_array_equal(np.asarray(jr.converged), conv)
        assert conv.all() if month == "April" else not conv.any(), \
            (month, pr.iters.numpy())


def test_microgrid_heat_recovery_rejections_in_both():
    """The ICE + CHP case's February window x 8 price scenarios (seed 23)
    at the default options: both solvers converge every instance, and
    the float64 certificate (each package's own, with the duals) accepts
    and rejects the same ones — some rejected, each worst on the CHP
    heat-recovery balance row, so the rejections are the solver's, not
    the port's."""
    from dervet_tpu.ops import certify as jax_certify
    _, ours = benchlib.build_window_lps(
        benchlib.synthetic_case(multi_der=True))
    _, ref = jax_benchlib.build_window_lps(
        jax_benchlib.synthetic_case(multi_der=True))
    plp, jlp = ours[672][0], ref[672][0]
    C = benchlib.scenario_price_batch(plp, 8, seed=23)
    jr = jpdhg.CompiledLPSolver(
        jlp, jpdhg.PDHGOptions(pallas_chunk=False)).solve(c=C)
    pr = pdhg.CompiledLPSolver(plp, pdhg.PDHGOptions(),
                               device="cpu").solve(c=C)
    assert np.asarray(jr.converged).all() and pr.converged.numpy().all()
    verdicts = {}
    for name, mod, res, lp in (("jax", jax_certify, jr, jlp),
                               ("torch", certify, pr, plp)):
        certs = [mod.certify_solution(
            dataclasses.replace(lp, c=C[i]), np.asarray(res.x[i]),
            float(res.obj[i]), y=np.asarray(res.y[i])) for i in range(8)]
        verdicts[name] = [c.accepted for c in certs]
        assert all(c.worst_group == "CHP-1/heat_recovery"
                   for c in certs if not c.accepted), name
    assert verdicts["jax"] == verdicts["torch"]
    assert not all(verdicts["torch"])


def _battery_lp(builder, T=48):
    rng = np.random.default_rng(1)
    price = rng.uniform(10, 80, T) / 1000
    b = builder()
    ch = b.var("ch", T, 0.0, 250.0)
    dis = b.var("dis", T, 0.0, 250.0)
    ene = b.var("ene", T, 0.0, 1000.0)
    D = np.eye(T) - np.eye(T, k=-1)
    rhs = np.zeros(T)
    rhs[0] = 500.0
    b.add_rows("soe", [(ene, D), (ch, -0.85), (dis, 1.0)], "eq", rhs)
    b.add_cost(ch, price)
    b.add_cost(dis, -price)
    return b.build()


def test_solve_lp_matches_jax():
    """One 48-hour battery LP through both packages' ``solve_lp``.  Here
    the two float32 runs decide one adaptive restart differently (the
    port restarts 8 times, the JAX package 7: a restart compares KKT
    norms summed in another order), so the iteration counts are held
    within four check windows (they are 2,016 and 1,504, CPU-measured),
    the statuses and objectives as elsewhere."""
    from dervet_tpu_torch.ops import solve_lp
    jr = jpdhg.solve_lp(_battery_lp(jax_lp.LPBuilder))
    pr = solve_lp(_battery_lp(port_lp.LPBuilder), device="cpu")
    assert pr.x.ndim == 1 and int(pr.status) == int(jr.status) \
        == pdhg.STATUS_CONVERGED
    assert abs(float(pr.obj) - float(jr.obj)) \
        <= OBJ_RTOL * max(1.0, abs(float(jr.obj)))
    assert abs(int(pr.restarts) - int(jr.restarts)) <= 1
    assert abs(int(pr.iters) - int(jr.iters)) <= 4 * CHECK_EVERY
    if not torch.cuda.is_available():
        # device=None means cuda:0, never a silent CPU run
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve_lp(_battery_lp(port_lp.LPBuilder))


def _model_params(value_col):
    return pd.DataFrame({
        "Tag": ["Scenario", "Battery", "Battery", "PV"],
        "ID": [np.nan, 1, 1, 1],
        "Key": ["n", "ene_max_rated", "ch_max_rated", "rated_capacity"],
        value_col: ["month", "8000", "2000", "3000"],
        "Sensitivity Parameters": [np.nan] * 4,
        "Sensitivity Analysis": ["no"] * 4,
    })


@pytest.mark.parametrize("value_col", ["Optimization Value", "Value"])
def test_widen_sensitivity_csv_same_bytes(tmp_path, value_col):
    src = tmp_path / "params.csv"
    _model_params(value_col).to_csv(src, index=False)
    out = {}
    for name, pkg in PACKAGES.items():
        path = tmp_path / f"{name}.csv"
        assert pkg.widen_sensitivity_csv(src, path, 5) == path
        out[name] = path.read_bytes()
    assert out["torch"] == out["jax"]
    df = pd.read_csv(tmp_path / "torch.csv")
    row = df[(df.Tag == "Battery") & (df.Key == "ene_max_rated")].iloc[0]
    assert row["Sensitivity Parameters"] == \
        "[6400.0, 8000.0, 9600.0, 11200.0, 12800.0]"
    assert row["Sensitivity Analysis"] == "yes"


REGISTRIES = {"jax": jax_registry, "torch": port_registry}


def _snapshot(reg_mod):
    reg = reg_mod.MetricsRegistry()
    reg.counter("c").inc()
    reg.gauge("g").set(1)
    reg.histogram("h").observe(0.1)
    return reg.snapshot()


def _bad(field):
    def edit(snap):
        snap = copy.deepcopy(snap)
        if field == "hist_bounds":
            snap["hist_bounds"] = 3
        elif field == "counter":
            snap["counters"]["c"] = -1
        elif field == "gauge":
            snap["gauges"]["g"] = "one"
        elif field == "buckets":
            snap["histograms"]["h"]["count"] += 1
        elif field == "layout":
            snap["histograms"]["h"]["buckets"] = [0, 1]
        else:
            del snap[field]
        return snap
    return edit


BAD_SNAPSHOTS = {"hist_bounds": "hist_bounds", "counter": "counter",
                 "gauge": "gauge", "buckets": "do not sum",
                 "layout": "buckets, expected", "t": "missing 't'"}


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_validate_telemetry_accepts_a_snapshot(pkg):
    snap = _snapshot(REGISTRIES[pkg])
    assert PACKAGES[pkg].validate_telemetry_section(snap) is snap
    assert snap["counters"]["c"] == 1


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("field", sorted(BAD_SNAPSHOTS))
def test_validate_telemetry_refuses(pkg, field):
    snap = _bad(field)(_snapshot(REGISTRIES[pkg]))
    with pytest.raises(ValueError, match=BAD_SNAPSHOTS[field]):
        PACKAGES[pkg].validate_telemetry_section(snap)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_validate_telemetry_of_a_served_round(pkg):
    """A service round's registry (one one-month case on the CPU
    backend) validates in both packages."""
    if pkg == "jax":
        from dervet_tpu.service import ScenarioService
        kw = {}
    else:
        from dervet_tpu_torch.service import ScenarioService
        kw = {"device": "cpu"}
    case = PACKAGES[pkg].synthetic_sensitivity_cases(1, months=1)[0]
    svc = ScenarioService(backend="cpu", max_wait_s=0.0, **kw)
    try:
        fut = svc.submit({0: case}, request_id=f"tel-{pkg}")
        svc.run_once()
        fut.result(timeout=0)
    finally:
        svc.close()
    snap = REGISTRIES[pkg].get_registry().snapshot()
    assert snap["counters"].get("dervet_rounds_total", 0) >= 1
    PACKAGES[pkg].validate_telemetry_section(snap)
