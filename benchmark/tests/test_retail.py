"""The retail TOU + demand-charge deployment (``retail_tou_dcm``) on the
CPU: the reference's tariff semantics against the program's, its window
LPs against the program's exact solves, the program's PDHG answers
through the judge, the pool-spanning fan-out's cases, and a fault the
judge must catch."""
import json

import numpy as np
import pandas as pd
import pytest

from benchmark import run, tariff
from benchmark.drivers import fanout_pool
from benchmark.reference import billing
from benchmark.reference import lp as ref
from benchmark.tests.conftest import ROOT, small_root
from dervet_tpu_torch.api import DERVET
from dervet_tpu_torch.financial.tariff import TariffEngine
from dervet_tpu_torch.io.params import CaseParams, Datasets
from dervet_tpu_torch.scenario.scenario import MicrogridScenario

CELL = "fanout-retail_tou_dcm-24"


def config(**kw):
    cfg = json.loads((ROOT / "benchmark/configs/retail_tou_dcm.json")
                     .read_text())
    cfg.update(kw)
    return cfg


def limits():
    return json.loads((ROOT / f"benchmark/limits/{CELL}.json").read_text())


def stacked_tariff():
    """Periods the configuration lacks: an energy adder stacked on an
    all-hours price, a demand period on weekends only, and excluded hours
    at a period's start."""
    base = dict(config()["tariff"][0], **{"Excluding Start Time": None,
                                          "Excluding End Time": None})

    def row(pid, m0, m1, t0, t1, wd, value, charge, x=(None, None)):
        return dict(base, **{
            "Billing Period": pid, "Start Month": m0, "End Month": m1,
            "Start Time": t0, "End Time": t1, "Excluding Start Time": x[0],
            "Excluding End Time": x[1], "Weekday?": wd, "Value": value,
            "Charge": charge})
    return tariff.frame({"tariff": [
        row(1, 1, 12, 1, 24, 2, 0.05, "energy"),
        row(2, 6, 9, 12, 18, 1, 0.04, "Energy"),
        row(3, 1, 12, 1, 24, 2, 10.0, "demand"),
        row(4, 6, 9, 10, 22, 0, 7.0, "Demand", (10, 11))]})


@pytest.mark.parametrize("table", ["configured", "stacked"])
def test_billing_masks_equal_the_programs(table):
    tar = tariff.frame(config()) if table == "configured" else stacked_tariff()
    index = pd.date_range("2017-01-01", periods=8760, freq="h")
    engine = TariffEngine(tar)
    by_step = engine.billing_periods_by_step(index)
    demand = billing.periods(tar, index, "demand")
    assert [pid for pid, _, _ in demand] == engine.demand_periods
    for pid, value, mask in demand:
        assert mask.any() and value == engine.value_of(pid)
        assert np.array_equal(mask, [pid in s for s in by_step]), pid
    assert np.array_equal(billing.energy_price(tar, index),
                          engine.energy_price(index))


@pytest.mark.parametrize("table", ["configured", "stacked"])
def test_monthly_bill_equals_the_programs(table):
    """The reference's bill of a net load that imports and exports equals
    the program's ``TariffEngine.monthly_bill`` month by month, and a
    float32 bill misses it by more than ``fanout_pool.BILL_GAP``."""
    tar = tariff.frame(config()) if table == "configured" else stacked_tariff()
    index = pd.date_range("2017-01-01", periods=8760, freq="h")
    net = pd.Series(np.random.default_rng(3).normal(800.0, 1500.0, 8760),
                    index=index)
    _, simple = TariffEngine(tar).monthly_bill(net, net, dt=1.0)
    lim = fanout_pool.BILL_GAP
    f32 = []
    for month, rows in net.groupby(index.to_period("M")):
        energy, demand = billing.bill(tar, rows.index, rows.to_numpy(), 1.0)
        prog = simple.loc[str(month)]
        scale = max(abs(energy) + abs(demand), 1.0)
        assert abs(prog["Energy Charge ($)"] - energy) / scale <= 1e-13
        assert abs(prog["Demand Charge ($)"] - demand) / scale <= 1e-13
        e32 = np.sum(billing.energy_price(tar, rows.index).astype(np.float32)
                     * rows.to_numpy(np.float32))
        f32.append(abs(float(e32) - energy) / scale)
    assert max(f32) > lim


def _case(cfg, seed=1, hours=None):
    case = tariff.case_dict(cfg, seed)
    if hours:
        case["time_series"] = case["time_series"].iloc[:hours]
    return case


def _solve(case, backend, **kw):
    params = tariff.case_params(case, 0, CaseParams, Datasets)
    return DERVET.from_cases([params]).solve(backend=backend, device="cpu",
                                             **kw)


def _judged(case, res, windows):
    """``ref.judge``'s numbers for each (start, T) window of the case."""
    out = []
    inst = next(iter(res.instances.values()))
    for w, (start, T) in enumerate(windows):
        rl = ref.build(case, start, T, {})
        best, _ = ref.solve(rl)
        ts = inst.time_series_data.iloc[start:start + T]
        named = {}
        for tag, der_id, keys in case["ders"]:
            for short, col in ref.part(tag).RESULTS.items():
                named[f"{tag}-{der_id}/{short}"] = ts[
                    f"{tag.upper()}: {keys['name']} {col}"].to_numpy(float)
        ref.part("DCM").complete(rl, named)
        obj = inst.objective_values["Total Objective"].iloc[w]
        out.append((best, obj, ref.judge(rl, rl.vector(named), best,
                                         reported=obj)))
    return out


def test_january_window_optimum_equals_the_programs_exact_solve():
    case = _case(config(months=1))
    (best, obj, nums), = _judged(case, _solve(case, "cpu"),
                                 ref.windows(case))
    assert obj == pytest.approx(best, rel=1e-6)
    assert nums["obj_gap"] <= 1e-6 and nums["prim_viol"] <= 1e-9


def test_daily_pdhg_windows_pass_the_judge():
    """A week of daily windows, each billing its own hours' peaks: the
    program's PDHG answers on the CPU (the kernels' plain versions) judged
    under the cell's limits."""
    scen = dict(config()["scenario"], n=24)
    case = _case(config(months=1, scenario=scen), hours=7 * 24)
    res = _solve(case, "torch")
    assert res.run_health["windows"]["cpu_fallback"] == 0
    lim = limits()
    judged = _judged(case, res, [(24 * d, 24) for d in range(7)])
    assert len(judged) == 7
    for _, _, nums in judged:
        assert all(nums[k] <= lim[k] for k in lim), nums


def test_pool_fanout_spans_the_pool_alike_for_every_seed():
    cfg = config()
    mix = json.loads((ROOT / "benchmark/traffic/fanout_pool-24.json")
                     .read_text())

    def drawn(seed, k):
        cases = fanout_pool._cases(cfg, mix, seed, k)
        return [(round(float(c["time_series"]["Site Load (kW)"].iloc[0]), 9),
                 dict((t, kk) for t, _, kk in c["ders"])["Battery"][
                     "ene_max_rated"]) for c in cases]

    a, b = drawn(2 ** 31 + 5, 0), drawn(2 ** 40 + 3, 1)
    assert len(a) == 24 and a != b and sorted(a) == sorted(b)
    series_of = {s for s, _ in a}
    assert len(series_of) == 3
    for s in series_of:
        sizes = sorted(e for t, e in a if t == s)
        assert np.allclose(sizes, 8000 * np.linspace(0.8, 1.6, 8))
    warm = {round(float(c["time_series"]["Site Load (kW)"].iloc[0]), 9)
            for c in fanout_pool._warm_cases(cfg, mix)}
    assert len(warm) == 3 and not warm & series_of


SCATTER = MicrogridScenario._scatter_to_ders
SOLVE = DERVET.solve
MONTHLY_BILL = TariffEngine.monthly_bill


def start_dispatch(self, solution):
    """Every case's dispatch left at the solve's starting point, zero."""
    SCATTER(self, {k: np.zeros_like(v) for k, v in solution.items()})


def bill_short_a_period(self, *args, **kw):
    """The program's bills, not its LPs, leave out the tariff's first
    demand period (the maximum demand)."""
    masks = self.demand_masks
    self.demand_masks = lambda index: masks(index)[1:]
    try:
        return MONTHLY_BILL(self, *args, **kw)
    finally:
        del self.demand_masks


@pytest.mark.parametrize("fault, where", [
    (None, None), (start_dispatch, (MicrogridScenario, "_scatter_to_ders")),
    (bill_short_a_period, (TariffEngine, "monthly_bill"))])
def test_a_dispatch_left_at_its_start_is_not_correct(fault, where, tmp_path,
                                                     capsys, monkeypatch):
    """A CPU run at a test's size (one month, two cases) with the
    program's exact solves in place of PDHG, so the judge alone is under
    test: sound, ``correct``; the dispatch left at its start, or a bill
    short of one demand period, not."""
    monkeypatch.setattr(DERVET, "solve", lambda self, backend, **kw: SOLVE(
        self, backend="cpu", device=kw["device"]))
    if fault is not None:
        monkeypatch.setattr(*where, fault)
    root = small_root(tmp_path, months=1, scenarios=2, cases=2)
    rc = run.main(["--workload", CELL, "--seed", str(2 ** 31 + 77),
                   "--seconds", "0.1"], device="cpu", root=root)
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"] is (fault is None)
    # the mix's two whole fan-outs of two cases
    assert out["attempted"] == 4 and list(out)[-1] == "checks"
