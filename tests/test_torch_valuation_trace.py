"""The product entry's trace: every phase of the port's ``DERVET.solve``
is a phase of ``telemetry.trace`` under one ``valuation`` root, and
``Result.phase_seconds`` is summed from those phases.

On the CPU (``backend="torch", device="cpu"``: the kernels' plain
versions), on the small synthetic fan-outs of the pipeline tests:

* one call's ``Result.trace`` passes ``validate_trace``: one root
  ``valuation``, every parent present, no negative duration;
* every ``phase_seconds`` key equals the sum of its spans (``prep_s``
  plus ``init_seconds``), the Reliability case's outage walks included;
* under a fault plan that forces non-convergence, ``escalate`` spans
  name their rung, ``escalate_s`` > 0, and the groups' ``retried`` and
  ``cpu_fallback`` attributes sum to the run-health totals;
* with ``DERVET_TPU_TELEMETRY=0`` the trace is empty, ``phase_seconds``
  has the same keys, and nothing enters the collector;
* a direct solve (``ops.solve_lp``, a service-style ``run_dispatch``)
  leaves no trace in the collector;
* a span and a ``torch.profiler`` range around the same block agree
  within 1 ms at start and at end: span records sit on the profiler's
  clock;
* each ``dispatch_group`` carries its LP (``m``, ``n``, ``nnz``), its
  instances' iterations (``iters_sum``) and those left at ``max_iters``
  (``at_limit``), and the ledger's totals sum the groups.
"""
import time

import numpy as np
import pytest
import torch

from dervet_tpu_torch import benchlib
from dervet_tpu_torch.api import DERVET
from dervet_tpu_torch.telemetry import trace as ttrace
from dervet_tpu_torch.utils import faultinject

torch.set_num_threads(2)

# phase_seconds key -> the spans whose durations it sums
PHASE_SPANS = {"prep_s": ("prep",), "dispatch_s": ("dispatch",),
               "post_s": ("post",), "dispatch_assembly_s": ("assembly",),
               "dispatch_solve_s": ("dispatch_group",),
               "dispatch_stage_s": ("stage",), "certify_s": ("certify",),
               "escalate_s": ("escalate",),
               "solver_setup_s": ("solver_build", "graph_capture"),
               "outage_walk_s": ("outage_walk",),
               "post_work_s": ("post_case",)}


@pytest.fixture(autouse=True)
def _clean_collector():
    ttrace.COLLECTOR.reset()
    yield
    ttrace.COLLECTOR.reset()


def _solve(n=2, months=1, telemetry="1", **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(ttrace.ENV, telemetry)
        return DERVET.from_cases(benchlib.synthetic_sensitivity_cases(
            n, months=months, **kw)).solve(backend="torch", device="cpu")


@pytest.fixture(scope="module")
def fanout():
    return _solve(months=2)


@pytest.fixture(scope="module")
def reliability():
    return _solve(reliability=True)


def _sums(spans):
    out = {}
    for s in spans:
        out[s["name"]] = out.get(s["name"], 0.0) + s["duration_s"]
    return out


@pytest.mark.parametrize("run", ["fanout", "reliability"])
def test_one_valuation_tree(run, request):
    res = request.getfixturevalue(run)
    info = ttrace.validate_trace(res.trace)
    assert info["root"]["name"] == "valuation"
    assert info["root"]["attrs"]["backend"] == "torch"
    names = {s["name"] for s in res.trace}
    assert {"prep", "dispatch", "assembly", "stage", "dispatch_group",
            "solver_build", "certify", "wait", "scatter", "post",
            "post_case"} <= names
    by_id = {s["span_id"]: s for s in res.trace}
    parent = {s["name"]: by_id[s["parent_id"]]["name"]
              for s in res.trace if s["parent_id"]}
    assert parent["prep"] == parent["dispatch"] == "valuation"
    assert parent["post_case"] == parent["post"] == "valuation"
    assert parent["dispatch_group"] == parent["assembly"] == "dispatch"
    assert parent["certify"] == "dispatch_group"
    assert parent["solver_build"] == "dispatch_group"
    # a group solved on a pool worker: its thread is not the dispatch's
    threads = {s["name"]: s["attrs"]["thread"] for s in res.trace}
    assert threads["dispatch_group"] != threads["dispatch"]


@pytest.mark.parametrize("run", ["fanout", "reliability"])
def test_phase_seconds_sum_their_spans(run, request):
    res = request.getfixturevalue(run)
    sums = _sums(res.trace)
    assert set(res.phase_seconds) == set(PHASE_SPANS)
    for key, names in PHASE_SPANS.items():
        got = sum(sums.get(n, 0.0) for n in names)
        # phase_seconds rounds to 1 ms, each span record to 1 us
        assert res.phase_seconds[key] == pytest.approx(got, abs=1.1e-3), key
    assert res.phase_seconds["dispatch_s"] > 0
    assert res.phase_seconds["post_work_s"] > 0
    for key in ("certify_s", "solver_setup_s"):
        assert 0 < res.phase_seconds[key] \
            <= res.phase_seconds["dispatch_solve_s"]


def test_outage_walks_are_spans(reliability):
    walks = [s for s in reliability.trace if s["name"] == "outage_walk"]
    stages = {s["attrs"]["stage"] for s in walks}
    assert {"requirements", "coverage"} <= stages
    assert all(s["attrs"]["L"] > 0 and s["attrs"]["starts"] > 0
               for s in walks)
    assert reliability.phase_seconds["outage_walk_s"] > 0


@pytest.mark.parametrize("rungs,landed", [({"solve"}, "retried"),
                                          ({"solve", "retry"},
                                           "cpu_fallback")])
def test_escalation_rungs_are_spans(rungs, landed):
    with faultinject.inject(nonconverge="all", rungs=rungs):
        res = _solve()
    ttrace.validate_trace(res.trace)
    esc = [s for s in res.trace if s["name"] == "escalate"]
    want = ["retry"] if landed == "retried" else ["retry", "cpu_fallback"]
    assert sorted({s["attrs"]["rung"] for s in esc}) == sorted(want)
    by_id = {s["span_id"]: s for s in res.trace}
    assert all(by_id[s["parent_id"]]["name"] == "dispatch_group"
               for s in esc)
    assert res.phase_seconds["escalate_s"] > 0
    assert res.phase_seconds["escalate_s"] \
        <= res.phase_seconds["dispatch_solve_s"]
    # each rung re-certifies what it recovered, as a child phase
    assert any(by_id[s["parent_id"]]["name"] == "escalate"
               for s in res.trace if s["name"] == "certify")
    groups = [s for s in res.trace if s["name"] == "dispatch_group"]
    health = res.run_health["windows"]
    for k in ("retried", "cpu_fallback"):
        assert sum(g["attrs"][k] for g in groups) == health[k]
    assert health[landed] == 2
    recovered = {s["attrs"]["rung"]: s["attrs"]["recovered"] for s in esc}
    assert recovered[want[-1]] == 2


def test_groups_carry_their_instance_windows(fanout):
    """Each ``dispatch_group`` span carries the solve's instance-window
    counts beside ``retried``: the active ones of all of them."""
    groups = [s for s in fanout.trace if s["name"] == "dispatch_group"]
    assert groups
    for g in groups:
        a = g["attrs"]
        assert "retried" in a
        assert 0 < a["active_instance_windows"] <= a["instance_windows"]


def test_kill_switch_keeps_phase_seconds(fanout):
    res = _solve(months=2, telemetry="0")
    assert res.trace == []
    assert set(res.phase_seconds) == set(fanout.phase_seconds)
    assert res.phase_seconds["dispatch_solve_s"] > 0
    assert not ttrace.COLLECTOR._traces


def test_direct_solves_leave_no_trace():
    from dervet_tpu_torch.ops import solve_lp
    from dervet_tpu_torch.scenario.scenario import (MicrogridScenario,
                                                    run_dispatch)
    _, by_len = benchlib.build_window_lps(
        benchlib.synthetic_sensitivity_cases(1, months=1)[0])
    solve_lp(next(iter(by_len.values()))[0], device="cpu")
    scens = [MicrogridScenario(c) for c in
             benchlib.synthetic_sensitivity_cases(1, months=1)]
    run_dispatch(scens, backend="torch", device="cpu")
    assert scens[0].solve_metadata["dispatch_solve_s"] > 0
    assert not ttrace.COLLECTOR._traces


def test_export_chrome_trace_of_a_call(fanout, tmp_path):
    import json
    path = ttrace.export_chrome_trace(fanout.trace, tmp_path / "t.json")
    events = json.loads(path.read_text())["traceEvents"]
    lanes = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert "thread:MainThread" in lanes and len(lanes) >= 3
    assert sum(e["ph"] == "X" for e in events) == len(fanout.trace)


def test_spans_sit_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ttrace.phase("valuation", root=True) as run:
            with record_function("block"):
                time.sleep(0.02)
    span, = run.trace
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "block"]
    start, dur = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
    assert start == pytest.approx(span["t_start"], abs=1e-3)
    assert start + dur == pytest.approx(
        span["t_start"] + span["duration_s"], abs=1e-3)


@pytest.fixture(scope="module")
def limited():
    """A fan-out whose solves stop at 64 iterations, far short of
    convergence: every window climbs the ladder."""
    from dervet_tpu_torch.ops.pdhg import PDHGOptions
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(ttrace.ENV, "1")
        return DERVET.from_cases(benchlib.synthetic_sensitivity_cases(
            2, months=1)).solve(backend="torch", device="cpu",
                                solver_opts=PDHGOptions(max_iters=64))


def _group_attrs(res):
    return [s["attrs"] for s in res.trace if s["name"] == "dispatch_group"]


def test_groups_carry_their_lp_and_iterations(fanout):
    """Each ``dispatch_group`` span carries its window LP as the kernel
    receives it (``m``, ``n``, K's non-zeros), the iterations of its
    instances summed, and how many stopped at the limit: none here."""
    _, by_len = benchlib.build_window_lps(
        benchlib.synthetic_sensitivity_cases(1, months=2)[0])
    groups = _group_attrs(fanout)
    assert sorted(a["T"] for a in groups) == sorted(by_len)
    for a in groups:
        lp = by_len[a["T"]][0]
        assert (a["m"], a["n"]) == (lp.m, lp.n)
        assert a["nnz"] == np.count_nonzero(lp.K.data) > 0
        assert a["windows"] <= a["iters_sum"] <= a["windows"] * a["iters_max"]
        assert a["at_limit"] == 0


def test_at_limit_counts_every_instance_below_convergence(limited):
    groups = _group_attrs(limited)
    assert groups
    for a in groups:
        assert a["rung"] == "initial"
        assert a["at_limit"] == a["windows"] == 2
        assert a["iters_sum"] >= 64 * a["windows"]
    health = limited.run_health["windows"]
    assert health["retried"] + health["cpu_fallback"] == 2 * len(groups)


@pytest.mark.parametrize("key", ["iters_sum", "at_limit"])
def test_ledger_totals_sum_the_groups(key, limited):
    led = limited.solve_ledger
    rungs = {g["rung"] for g in led["groups"]}
    assert {"initial", "retry"} <= rungs
    device = [g for g in led["groups"] if g.get("backend") != "cpu"]
    assert led["totals"][key] == sum(g[key] for g in device) > 0
