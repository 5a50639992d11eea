"""The readers of the program's per-phase span sums: each is the mean of
its ``Result.phase_seconds`` key over the window's fan-outs that were not
profiled, and finds nothing where the program has no such key (a program
that predates the key)."""
import pytest

from benchmark import core

KEYS = {"certify_s.valuation": "certify_s",
        "escalate_s.valuation": "escalate_s",
        "solver_setup_s.valuation": "solver_setup_s",
        "post_work_s.valuation": "post_work_s",
        "outage_walk_s.valuation": "outage_walk_s"}


def fanouts(key):
    return [{"t0": 5.0, "t1": 15.0, "cases": 32, "profiled": False,
             "phase_seconds": {"dispatch_solve_s": 5.0, key: 1.0}},
            {"t0": 15.0, "t1": 27.0, "cases": 32, "profiled": True,
             "phase_seconds": {"dispatch_solve_s": 9.0, key: 9.0}},
            {"t0": 27.0, "t1": 35.0, "cases": 32, "profiled": False,
             "phase_seconds": {"dispatch_solve_s": 7.0, key: 2.0}}]


@pytest.mark.parametrize("name", sorted(KEYS))
def test_mean_over_unprofiled_fanouts(name):
    data = {"fanouts": fanouts(KEYS[name]), "t_window": 5.0}
    assert core.reader(name).read(data) == pytest.approx(1.5)


@pytest.mark.parametrize("name", sorted(KEYS))
def test_nothing_without_the_key(name):
    data = {"fanouts": fanouts("another_s"), "t_window": 5.0}
    assert core.reader(name).read(data) is None
    assert core.reader(name).read({"t_window": 0.0}) is None


def test_every_reader_is_in_the_spec():
    spec = core.load_spec(core.ROOT)
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in KEYS:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["unit"] == "s"
        assert m["moves"] == "valuation_cases_per_s"
