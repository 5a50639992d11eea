"""The inputs repeat from the seed, and differ across seeds."""
import numpy as np
import torch

from benchmark import series
from benchmark.drivers import sweep
from benchmark.tests.conftest import ROOT
import json


def config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                      .read_text())


def test_series_repeat_from_seed():
    cfg = config("microgrid_ice_chp_rel")
    a, b = series.case_series(cfg, 11), series.case_series(cfg, 11)
    assert a.equals(b)
    assert not a.equals(series.case_series(cfg, 12))
    assert list(a.columns) == ["DA Price ($/kWh)", "PV Gen (kW/rated kW)",
                               "Site Load (kW)",
                               "Site Hot Water Thermal Load (BTU/hr)",
                               "Critical Load (kW)"]
    assert len(a) == 8760 and (a["DA Price ($/kWh)"] > 0).all()


def test_stream_seed_takes_large_and_negative_seeds():
    big = 2 ** 31 + 12345
    assert series.stream_seed(big, 3) == series.stream_seed(big, 3)
    assert series.stream_seed(big, 3) != series.stream_seed(big, 4)
    assert 0 <= series.stream_seed(big, -1, 2) < 2 ** 63


def test_sensitivity_rule():
    case = series.case_dict(config("bess_pv_da"), 0)
    cases = series.sensitivity(case, {"tag": "Battery", "key": "ene_max_rated",
                                      "lo": 0.8, "hi": 1.6}, 5)
    got = [dict((t, k) for t, _, k in c["ders"])["Battery"]["ene_max_rated"]
           for c in cases]
    assert np.allclose(got, 8000 * np.linspace(0.8, 1.6, 5))
    assert case["ders"][0][2]["ene_max_rated"] == 8000.0


def test_sweep_draw_repeats_from_seed():
    c = torch.rand(6, 10) + 0.5
    job = {"c_rep": c, "cols": torch.tensor([1, 2, 5, 7])}
    C1, M1 = sweep._draw(job, 2 ** 31 + 9, 4, 1, 0.15)
    C2, M2 = sweep._draw(job, 2 ** 31 + 9, 4, 1, 0.15)
    C3, _ = sweep._draw(job, 2 ** 31 + 9, 5, 1, 0.15)
    assert torch.equal(C1, C2) and torch.equal(M1, M2)
    assert not torch.equal(C1, C3)
    rest = [0, 3, 4, 6, 8, 9]
    assert torch.equal(C1[:, rest], c[:, rest])
    assert torch.allclose(C1[:, job["cols"]], c[:, job["cols"]] * M1)
    assert abs(float(torch.log(M1).std()) - 0.15) < 0.1
