"""The single-card dispatch pipeline's in-flight groups.

* The admission rule (``scenario.pipeline_admits`` over the limits
  ``_pipeline_limits`` reads): a group of batch width B holds about B of
  the card's SMs, so groups of 24 on 132 SMs run five at once, groups of
  448 keep the default depth, ``DERVET_TPU_PIPELINE=2`` pins two and
  ``0`` is the serial reference mode.
* The in-flight clock's peak and time-weighted mean.
* A fan-out of four cases with six structure groups (more than the
  default depth) through ``DERVET.solve`` on the CPU: every answer is
  byte-identical to ``DERVET_TPU_PIPELINE=0``, and the counter in the
  solve ledger, ``Result.run_health`` and the ``dispatch`` span reads at
  least two groups in flight (the first two groups' solves wait for each
  other, so they can only finish if the pipeline runs them at once).
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from dervet_tpu_torch import benchlib
from dervet_tpu_torch.api import DERVET
from dervet_tpu_torch.parallel import elastic
from dervet_tpu_torch.scenario import scenario
from dervet_tpu_torch.telemetry import trace as ttrace

torch.set_num_threads(2)

H100_SMS = 132


def _admitted(width, sm_count, monkeypatch, env=None, multi_dev=False):
    """How many groups of ``width`` the pipeline runs at once on a device
    of ``sm_count`` SMs (None: a device without SMs) under ``env``."""
    if env is None:
        monkeypatch.delenv(scenario.PIPELINE_ENV, raising=False)
    else:
        monkeypatch.setenv(scenario.PIPELINE_ENV, env)
    monkeypatch.setattr(elastic, "multiprocessor_count",
                        lambda device: sm_count)
    depth, sms, max_inflight = scenario._pipeline_limits(
        torch.device("cpu"), multi_dev)
    inflight = []
    while len(inflight) < max_inflight and scenario.pipeline_admits(
            inflight, width, sms, depth):
        inflight.append(width)
    return len(inflight)


def _default_depth(monkeypatch):
    monkeypatch.delenv(scenario.PIPELINE_ENV, raising=False)
    depth, pinned = scenario._pipeline_depth()
    assert not pinned and 2 <= depth <= 3
    return depth


@pytest.mark.parametrize("width, want", [
    (24, 5),     # the retail fan-out's months: 5 x 24 = 120 of 132
    (32, 4),     # the microgrid fan-out's: 4 x 32 = 128
    (44, 3),     # 3 x 44 = 132 exactly
    (8, scenario.PIPELINE_MAX_INFLIGHT),   # narrow groups stop at the cap
])
def test_groups_fill_the_sms(width, want, monkeypatch):
    assert _admitted(width, H100_SMS, monkeypatch) == want


@pytest.mark.parametrize("width", [64, 256, 448])
def test_wide_groups_keep_the_default_depth(width, monkeypatch):
    """A group that fills the card alone: the depth, so host assembly
    still overlaps a solve."""
    depth = _default_depth(monkeypatch)
    assert _admitted(width, H100_SMS, monkeypatch) == depth


def test_no_sms_keeps_the_default_depth(monkeypatch):
    depth = _default_depth(monkeypatch)
    assert _admitted(24, None, monkeypatch) == depth


@pytest.mark.parametrize("env", ["2", "4"])
def test_explicit_depth_pins(env, monkeypatch):
    assert _admitted(24, H100_SMS, monkeypatch, env=env) == int(env)
    assert _admitted(448, H100_SMS, monkeypatch, env=env) == int(env)


def test_several_devices_run_one_split_solve(monkeypatch):
    assert _admitted(24, H100_SMS, monkeypatch, multi_dev=True) == 1


@pytest.mark.parametrize("env", ["0", "off"])
def test_zero_is_the_serial_mode(env, monkeypatch):
    monkeypatch.setenv(scenario.PIPELINE_ENV, env)
    assert not scenario._pipeline_enabled()
    assert scenario._pipeline_depth() == (0, True)


def test_mixed_widths_count_the_running_ones():
    """A wide group running leaves room only at the depth."""
    assert scenario.pipeline_admits([24, 24], 24, H100_SMS, 3)
    assert scenario.pipeline_admits([24, 24, 24, 24], 24, H100_SMS, 3)
    assert not scenario.pipeline_admits([24] * 5, 24, H100_SMS, 3)
    assert scenario.pipeline_admits([448, 24], 24, H100_SMS, 3)
    assert not scenario.pipeline_admits([448, 24, 24], 24, H100_SMS, 3)


def test_inflight_clock_peak_and_mean():
    clock = scenario._InflightClock()
    clock._spans = [(0.0, 2.0), (1.0, 3.0), (2.0, 4.0)]
    # 1 group over [0, 1), 2 over [1, 3), 1 over [3, 4]: 6 / 4
    assert clock.summary() == {"worker_streams": 0, "inflight_peak": 2,
                               "inflight_mean": 1.5}
    assert scenario._InflightClock().summary()["inflight_peak"] == 0


def test_inflight_clock_under_many_threads():
    """More workers than cores, switching often: no group is lost, the
    peak is the groups that were held in flight together, and streams
    count once however many groups ran on them."""
    import os
    import sys
    clock = scenario._InflightClock()
    n = 4 * (os.cpu_count() or 1) + 4
    meet = threading.Barrier(n, timeout=60)

    class Stream:       # what the clock reads of a CUDA stream
        def __init__(self, handle):
            self.cuda_stream = handle

    def group(i):
        clock.add_stream(Stream(i % 4))
        meet.wait()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=clock.track, args=(group, i))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = clock.summary()
    assert got["worker_streams"] == 4 and got["inflight_peak"] == n, got


def test_worker_streams_are_handed_back_and_reused(monkeypatch):
    """A worker holds a stream no other worker has while it solves and
    hands it back after: two at once take two, the next takes one of
    those, so dispatches do not draw new streams (the CUDA calls faked)."""
    import contextlib
    made = []

    def new_stream(device):
        made.append(object())
        return made[-1]

    monkeypatch.setattr(torch.cuda, "Stream", new_stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(elastic, "_idle_streams", {})
    card = torch.device("cuda", 0)
    with elastic.worker_stream(card) as a, elastic.worker_stream(card) as b:
        assert a is not b
    with elastic.worker_stream(card) as c:
        assert c is a or c is b
    assert len(made) == 2
    with elastic.worker_stream(torch.device("cpu")) as none:
        assert none is None


def _cases():
    """Four one-month cases of four window lengths: six structure groups
    (each length's full windows, and the three shorter last windows)."""
    out = []
    for i, n in enumerate((96, 120, 144, 168)):
        c, = benchlib.synthetic_sensitivity_cases(1, months=1, n=n)
        out.append(dataclasses.replace(c, case_id=i))
    return out


@pytest.fixture(scope="module")
def runs():
    """The fan-out under ``DERVET_TPU_PIPELINE=0``, then through the
    pipeline with its first two group solves waiting for each other."""
    mp = pytest.MonkeyPatch()
    solve = scenario.resolve_group
    meet = threading.Barrier(2, timeout=120)
    lock = threading.Lock()
    calls = []

    def two_at_once(*args, **kwargs):
        with lock:
            calls.append(None)
            first = len(calls) <= 2
        if first:
            meet.wait()
        return solve(*args, **kwargs)

    try:
        mp.setenv(ttrace.ENV, "1")
        mp.setenv(scenario.PIPELINE_ENV, "0")
        serial = DERVET.from_cases(_cases()).solve(backend="torch",
                                                   device="cpu")
        mp.delenv(scenario.PIPELINE_ENV)
        mp.setattr(scenario, "resolve_group", two_at_once)
        piped = DERVET.from_cases(_cases()).solve(backend="torch",
                                                  device="cpu")
    finally:
        mp.undo()
    return serial, piped


def test_more_groups_than_the_depth(runs):
    serial, piped = runs
    depth, _ = scenario._pipeline_depth()
    for res in runs:
        assert len(res.solve_ledger["groups"]) == 6 > depth


def test_answers_byte_identical_to_serial(runs):
    serial, piped = runs
    assert list(serial.instances) == list(piped.instances) == [0, 1, 2, 3]
    for k, inst in serial.instances.items():
        a, b = inst.scenario, piped.instances[k].scenario
        assert a.objective_values == b.objective_values
        assert set(a._solution) == set(b._solution)
        for name in a._solution:
            assert np.array_equal(a._solution[name], b._solution[name]), name


def test_inflight_counter_reaches_ledger_health_and_span(runs):
    serial, piped = runs
    led = piped.solve_ledger
    assert led["pipeline"] is True and led["inflight_peak"] >= 2
    assert 1.0 <= led["inflight_mean"] <= led["inflight_peak"] \
        <= led["max_inflight"]
    assert led["worker_streams"] == 0      # no CUDA streams on the CPU
    assert piped.run_health["pipeline"] == {
        k: led[k] for k in scenario.PIPELINE_KEYS}
    span, = [s for s in piped.trace if s["name"] == "dispatch"]
    for k in scenario.PIPELINE_KEYS[1:]:
        assert span["attrs"][k] == led[k], k
    # the serial mode: one group at a time, no pool
    sled = serial.solve_ledger
    assert sled["pipeline"] is False and sled["inflight_peak"] == 1
    assert serial.run_health["pipeline"]["inflight_peak"] == 1
