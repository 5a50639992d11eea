"""The readers of the dense groups' counters, on recorded inputs: the
instances left at the iteration limit (the ledger's ``at_limit``) and the
traced fan-out's solves on the card against their roofline.  Each finds nothing
where the program's ledger predates the counters."""
import numpy as np
import pytest

from benchmark import core, roofline
from benchmark.drivers import fanout_pool

FANOUTS = [{"t0": 5.0, "t1": 45.0, "cases": 24, "profiled": False,
            "limit_exits": 12},
           {"t0": 45.0, "t1": 90.0, "cases": 24, "profiled": True,
            "limit_exits": 40},
           {"t0": 90.0, "t1": 130.0, "cases": 24, "profiled": False,
            "limit_exits": 15}]
GROUPS = [{"rung": "initial", "backend": "torch", "m": 1505, "n": 2690,
           "nnz": 9000, "batch": 24, "iters_sum": 24 * 50_000,
           "at_limit": 2},
          {"rung": "initial", "backend": "torch", "m": 1673, "n": 2978,
           "nnz": 10000, "batch": 48, "iters_sum": 48 * 100_000,
           "at_limit": 5},
          {"rung": "retry", "backend": "torch", "m": 1673, "n": 2978,
           "nnz": 10000, "batch": 5, "iters_sum": 5 * 1_600_000,
           "at_limit": 1},
          {"rung": "cpu_fallback", "backend": "cpu", "m": 1673, "n": 2978,
           "batch": 1}]


class Ledger:
    def __init__(self, groups):
        self.solve_ledger = {"groups": groups}


def read(name, data):
    return core.reader(name).read(data)


def test_limit_exits_mean_over_unprofiled_fanouts():
    data = {"fanouts": FANOUTS, "t_window": 5.0}
    assert read("limit_exits.retail", data) == pytest.approx(13.5)


def test_device_solves_give_the_counts_and_the_work():
    """``at_limit`` from the first solves; the work from every solve on
    the card, the ladder's retries included, its CPU rung not."""
    groups = fanout_pool._device_solves(Ledger(GROUPS))
    assert [g["rung"] for g in groups] == ["initial", "initial", "retry"]
    first = fanout_pool._first_solves(groups)
    assert [g["rung"] for g in first] == ["initial", "initial"]
    assert fanout_pool._limit_exits(first) == 7
    ops, nbytes = fanout_pool._work(groups)
    want = [roofline.solve_work(np.full(g["batch"], g["iters_sum"]
                                        / g["batch"]),
                                g["m"], g["n"], g["nnz"]) for g in groups]
    assert ops == pytest.approx(sum(w[0] for w in want))
    assert nbytes == pytest.approx(sum(w[1] for w in want))
    # iterations x (4 a non-zero + 14 a column + 11 a row)
    assert ops == pytest.approx(24 * 50_000 * (4 * 9000 + 14 * 2690
                                               + 11 * 1505)
                                + (48 * 100_000 + 5 * 1_600_000)
                                * (4 * 10000 + 14 * 2978 + 11 * 1673))


def test_roofline_share_of_the_kernels_time():
    work = (6.7e11, 3.35e8)              # 10 ms of operations, 0.1 ms
    data = {"trace": {"kernel_s": 2.0, "busy_s": 2.5, "window_s": 40.0},
            "solve_work": work}
    assert read("pdhg_roofline.retail", data) == pytest.approx(0.5)


def test_nothing_where_the_ledger_predates_the_counters():
    old = [{k: v for k, v in g.items()
            if k not in ("nnz", "iters_sum", "at_limit")} for g in GROUPS]
    groups = fanout_pool._device_solves(Ledger(old))
    assert fanout_pool._limit_exits(fanout_pool._first_solves(groups)) is None
    assert fanout_pool._work(groups) is None
    assert fanout_pool._device_solves(Ledger([])) == []
    assert fanout_pool._limit_exits([]) is None
    fanouts = [dict(f, limit_exits=None) for f in FANOUTS]
    assert read("limit_exits.retail", {"fanouts": fanouts}) is None
    assert read("limit_exits.retail", {"t_window": 0.0}) is None
    trace = {"kernel_s": 2.0, "busy_s": 2.5, "window_s": 40.0}
    assert read("pdhg_roofline.retail", {"trace": trace}) is None
    assert read("pdhg_roofline.retail", {"solve_work": (1.0, 1.0)}) is None
    assert read("pdhg_roofline.retail", {
        "trace": dict(trace, kernel_s=0.0), "solve_work": (1.0, 1.0)}) is None


def test_both_readers_are_in_the_spec():
    spec = core.load_spec(core.ROOT)
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    assert per_layer["pdhg_roofline.retail"]["source"] == "device_trace"
    assert per_layer["limit_exits.retail"]["source"] == "program_counter"
    for name in ("pdhg_roofline.retail", "limit_exits.retail"):
        assert per_layer[name]["workloads"] == ["fanout-retail_tou_dcm-24"]
        assert per_layer[name]["moves"] == "valuation_cases_per_s"
