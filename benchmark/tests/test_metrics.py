"""Every metric's reader on recorded inputs, and the trace's reduction."""
import numpy as np
import pytest

from benchmark import core, roofline, trace

PASSES = [(10.0, 10.5, 12000), (10.5, 11.0, 12000), (11.0, 11.6, 12000),
          (11.6, 12.0, 12000)]
TRACE = {"busy_s": 0.6, "window_s": 1.0,
         "span_device_s": {"solve/T=744": 0.4, "solve/T=720": 0.1,
                           "draw": 0.05},
         "device_ops": [], "idle_gaps": []}
FANOUTS = [{"t0": 5.0, "t1": 15.0, "cases": 32, "profiled": False,
            "phase_seconds": {"prep_s": 1.0, "dispatch_assembly_s": 2.0,
                              "dispatch_solve_s": 5.0, "post_s": 0.5}},
           {"t0": 15.0, "t1": 27.0, "cases": 32, "profiled": True,
            "phase_seconds": {"prep_s": 9.0, "dispatch_assembly_s": 9.0,
                              "dispatch_solve_s": 9.0, "post_s": 9.0}},
           {"t0": 27.0, "t1": 35.0, "cases": 32, "profiled": False,
            "phase_seconds": {"prep_s": 3.0, "dispatch_assembly_s": 4.0,
                              "dispatch_solve_s": 7.0, "post_s": 1.5}}]


def read(name, data):
    return core.reader(name).read(data)


def test_sweep_readers():
    data = {"passes": PASSES, "t_window": 10.0, "setup_s": 21.5,
            "capture_s": 0.25, "iters_traced": np.arange(1, 101),
            "trace": TRACE, "solve_work": (6.7e9, 3.35e6)}
    assert read("sweep_windows_per_s", data) == pytest.approx(48000 / 2.0)
    assert read("sweep_pass_p90_s", data) == pytest.approx(
        np.percentile([0.5, 0.5, 0.6, 0.4], 90))
    assert read("setup_s", data) == 21.5
    assert read("capture_s.sweep", data) == 0.25
    assert read("iters_p99.sweep", data) == pytest.approx(99.01)
    assert read("device_idle.sweep", data) == pytest.approx(40.0)
    # 6.7e9 operations at 67 TFLOP/s: 1e-4 s over 0.5 s under solves
    assert read("pdhg_roofline.sweep", data) == pytest.approx(0.02)


def test_readers_find_nothing_without_their_inputs():
    for name in ("sweep_windows_per_s", "sweep_pass_p90_s",
                 "valuation_cases_per_s", "iters_p99.sweep",
                 "pdhg_roofline.sweep", "device_idle.sweep",
                 "device_idle.valuation", "prep_s.valuation"):
        assert read(name, {"t_window": 0.0}) is None


def test_fanout_readers_skip_the_profiled_fanout():
    data = {"fanouts": FANOUTS, "t_window": 5.0, "trace": TRACE}
    assert read("valuation_cases_per_s", data) == pytest.approx(96 / 30.0)
    assert read("prep_s.valuation", data) == pytest.approx(2.0)
    assert read("assembly_s.valuation", data) == pytest.approx(3.0)
    assert read("solve_s.valuation", data) == pytest.approx(6.0)
    assert read("post_s.valuation", data) == pytest.approx(1.0)
    assert read("device_idle.valuation", data) == pytest.approx(40.0)


def test_roofline_counts_needed_work():
    ops, nbytes = roofline.solve_work([10, 20], m=3, n=5, nnz=7)
    assert ops == 30 * (4 * 7 + 14 * 5 + 11 * 3)
    assert nbytes == 2 * 4 * (4 * 5 + 2 * 3) + 4 * 7
    assert roofline.bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 3.35e12) == pytest.approx(1.0)


def test_trace_reduce_unions_overlaps_and_names_gaps():
    device = [("k1", 0.0, 2.0), ("k2", 1.0, 3.0), ("k1", 5.0, 6.0),
              ("copy", 9.0, 9.5)]
    spans = [("pass", 0.0, 10.0), ("solve/T=744", 0.0, 3.5),
             ("draw", 3.5, 8.0)]
    out = trace.reduce(device, spans, 0.0, 10.0)
    assert out["busy_s"] == pytest.approx(4.5)
    assert out["window_s"] == 10.0
    assert out["span_device_s"]["solve/T=744"] == pytest.approx(3.0)
    assert out["span_device_s"]["draw"] == pytest.approx(1.0)
    assert out["device_ops"][0] == ["k1", 3.0]
    # gaps 6-9 (begun in draw), 3-5 (begun in the solve), 9.5-10 (pass)
    assert out["idle_gaps"][0] == ["draw", pytest.approx(3.0)]
    assert out["idle_gaps"][1] == ["solve/T=744", pytest.approx(2.0)]
    assert out["idle_gaps"][2] == ["pass", pytest.approx(0.5)]
    assert trace.union(np.zeros((0, 2))).shape == (0, 2)
