"""The port's copied numpy layers against the JAX package, and its
import boundary.

* the same synthetic case built by both packages gives byte-equal window
  LPs (``K``, ``c``, ``q``, ``l``, ``u``, ``n_eq``): monthly, monthly with
  the battery's daily-cycle rows, and weekly windows;
* no module of ``dervet_tpu_torch`` imports ``jax`` or ``dervet_tpu``
  (an AST scan), and importing its entry point leaves jax unloaded.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from dervet_tpu import benchlib as jax_benchlib
from dervet_tpu.scenario.scenario import MicrogridScenario as JaxScenario
from dervet_tpu_torch import benchlib
from dervet_tpu_torch.scenario.scenario import MicrogridScenario

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "dervet_tpu_torch"


def _jax_case(n, daily_cycle_limit):
    case = jax_benchlib.synthetic_case(n=n)
    if daily_cycle_limit:
        for tag, _, keys in case.ders:
            if tag == "Battery":
                keys["daily_cycle_limit"] = float(daily_cycle_limit)
    return case


def _window_lps(scen, limit):
    scen.prepare_dispatch("cpu")
    return [scen.build_window_lp(ctx, scen._annuity_scalar,
                                 scen._requirements)
            for ctx in scen.windows[:limit]]


@pytest.mark.parametrize("n,dcl,limit", [
    ("month", 0, 12), ("month", 1, 12), (168, 0, 6)],
    ids=["monthly", "monthly-daily-cycle", "weekly"])
def test_window_lps_byte_equal(n, dcl, limit):
    ours = _window_lps(MicrogridScenario(
        benchlib.synthetic_case(n=n, daily_cycle_limit=dcl)), limit)
    ref = _window_lps(JaxScenario(_jax_case(n, dcl)), limit)
    assert len(ours) == len(ref) == limit
    for a, b in zip(ours, ref):
        assert a.n_eq == b.n_eq and a.K.shape == b.K.shape
        for part in ("data", "indices", "indptr"):
            assert getattr(a.K, part).tobytes() == \
                getattr(b.K, part).tobytes(), part
        for v in ("c", "q", "l", "u"):
            assert getattr(a, v).tobytes() == getattr(b, v).tobytes(), v
    if dcl:
        # the daily-cycle rows are inequality rows beside the SOE rows
        assert ours[0].m > ours[0].n_eq


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_package_imports():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 30
    bad = []
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "dervet_tpu"):
                bad.append(f"{f.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_import_leaves_jax_unloaded():
    code = ("import sys, dervet_tpu_torch.api, dervet_tpu_torch.benchlib; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'dervet_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_unported_tags_raise_model_parameter_error():
    """Every tag the JAX package takes is ported now: the ones once
    refused here (ICE, Reliability) build, and only a tag neither
    package knows is refused, by name."""
    from dervet_tpu_torch.utils.errors import ParameterError
    case = benchlib.synthetic_case(reliability=True)
    case.ders.append(("ICE", "1", {"name": "ice", "rated_capacity": 500.0}))
    scen = MicrogridScenario(case)
    assert [d.tag for d in scen.ders] == ["Battery", "PV", "ICE"]
    assert "Reliability" in scen.streams
    case = benchlib.synthetic_case()
    case.ders.append(("Flywheel", "1", {}))
    with pytest.raises(ParameterError, match="Flywheel"):
        MicrogridScenario(case)
    case = benchlib.synthetic_case()
    case.streams["Arbitrage"] = {}
    with pytest.raises(ParameterError, match="Arbitrage"):
        MicrogridScenario(case)


def test_synthetic_data_matches_reference():
    a = benchlib.synthetic_timeseries(seed=3)
    b = jax_benchlib.synthetic_timeseries(seed=3)
    assert np.array_equal(a.to_numpy(), b.to_numpy())
    assert list(a.columns) == list(b.columns)
