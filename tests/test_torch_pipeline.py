"""``DERVET.from_cases(...).solve`` through both packages.

* ``backend="cpu"`` (exact HiGHS) on both sides: the same numpy model
  assembly, so every output CSV is byte-identical (``run_health*.json``
  carries wall-clock and is left out);
* the port's ``backend="torch", device="cpu"`` (the batched PDHG solver
  with the chunk kernels' plain versions) against the JAX package's
  ``backend="jax"``: every window certified on both sides, per-window
  objectives within the float64 certificate's objective tolerance
  (``eps_obj`` = 2e-4 relative), NPV within 1e-3 relative, and the port's
  solve ledger validates and names the kernel each group would ride.
"""
import filecmp

import numpy as np
import pytest
import torch

from dervet_tpu import benchlib as jax_benchlib
from dervet_tpu.api import DERVET as JaxDERVET
from dervet_tpu_torch import benchlib
from dervet_tpu_torch.api import DERVET

torch.set_num_threads(2)

EPS_OBJ = 2e-4      # ops/certify.CertPolicy.eps_obj
NPV_RTOL = 1e-3


def _cases(pkg):
    return pkg.synthetic_sensitivity_cases(2, months=2)


@pytest.fixture(scope="module")
def cpu_runs(tmp_path_factory):
    out = {}
    for name, api, pkg, kw in (("jax", JaxDERVET, jax_benchlib, {}),
                               ("torch", DERVET, benchlib,
                                {"device": "cpu"})):
        res = api.from_cases(_cases(pkg)).solve(backend="cpu", **kw)
        d = tmp_path_factory.mktemp(f"cpu_{name}")
        res.save_as_csv(d)
        out[name] = (res, d)
    return out


def test_cpu_backend_csvs_byte_identical(cpu_runs):
    (_, dj), (_, dt) = cpu_runs["jax"], cpu_runs["torch"]
    names = sorted(p.name for p in dt.iterdir()
                   if not p.name.startswith("run_health"))
    ref = sorted(p.name for p in dj.iterdir()
                 if not p.name.startswith("run_health"))
    assert names == ref and len(names) > 5
    match, mismatch, errors = filecmp.cmpfiles(dj, dt, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


@pytest.fixture(scope="module")
def pdhg_runs():
    jres = JaxDERVET.from_cases(_cases(jax_benchlib)).solve(backend="jax")
    tres = DERVET.from_cases(_cases(benchlib)).solve(backend="torch",
                                                     device="cpu")
    return jres, tres


def _certified(res):
    cert = res.run_health["certification"]["windows"]
    return cert["certified"] + cert["certified_loose"], cert


def test_pdhg_backends_agree(pdhg_runs):
    jres, tres = pdhg_runs
    n_windows = 2 * 2
    for res in (jres, tres):
        got, cert = _certified(res)
        assert got == n_windows, cert
        assert res.run_health["windows"]["clean"] == n_windows
        assert res.run_health["invariant_audit"]["ok"]
    for key, inst in tres.instances.items():
        ours = inst.objective_values["Total Objective"]
        ref = jres.instances[key].objective_values["Total Objective"]
        assert list(ours.index) == list(ref.index)
        rel = (ours - ref).abs() / (1.0 + ref.abs())
        assert rel.max() <= EPS_OBJ, rel
        a = inst.npv_df.select_dtypes("number").to_numpy()
        b = jres.instances[key].npv_df.select_dtypes("number").to_numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= NPV_RTOL * np.abs(b).max()


def test_port_solve_ledger(pdhg_runs):
    _, tres = pdhg_runs
    led = benchlib.validate_solve_ledger(tres.solve_ledger)
    assert led["solver_version"].startswith("pdhg-torch")
    groups = [g for g in led["groups"] if g["backend"] == "torch"]
    assert groups and led["totals"]["windows"] == 4
    for g in groups:
        # the CPU runs the kernels' plain versions: reason 'backend'
        assert g["kernel"] == "torch_plain"
        assert g["kernel_fallback"] == "backend"
        assert g["kernel_launches"] == 0 and g["device"] == "cpu"
    assert led["kernel"]["fallback_reasons"] == {"backend": len(groups)}


def test_auto_backend_threshold(monkeypatch):
    """``backend="auto"`` sends runs below ``AUTO_TORCH_MIN_WINDOWS`` to
    exact HiGHS and runs at or above it to the device (the threshold the
    crossover script measured on the card)."""
    import dervet_tpu_torch.api as api
    seen = []

    def fake_dispatch(scenarios, backend, **kw):
        seen.append((len(scenarios), backend, kw.get("device")))
        raise RuntimeError("stop after routing")

    monkeypatch.setattr("dervet_tpu_torch.scenario.scenario.run_dispatch",
                        fake_dispatch)
    assert api.DERVET.AUTO_TORCH_MIN_WINDOWS == 96
    for n_cases, months in ((1, 2), (8, 12)):
        cases = benchlib.synthetic_sensitivity_cases(n_cases, months=months)
        with pytest.raises(RuntimeError, match="stop after routing"):
            DERVET.from_cases(cases).solve(device="cpu")
    assert seen == [(1, "cpu", "cpu"), (8, "torch", "cpu")]
