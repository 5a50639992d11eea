"""The elastic multi-device scheduler (``parallel/elastic.py``) in both
packages, and the port's elastic dispatch on eight CPU devices.

* the JAX package's scheduler unit cases (env parsing, the cost
  estimate, LPT placement, affinity, a steal from a busy straggler, no
  steal from an idle victim, a worker's error propagating) run against
  both packages' modules;
* the port's ``run_dispatch`` on eight CPU entries — the test seam
  ``elastic.visible_devices``, as the JAX tests force eight virtual CPU
  devices (``tests/conftest.py``): 8-, 2- and 1-device schedules are
  bitwise equal, agree with the plain pipeline (which splits each batch
  over the eight entries) within certification tolerance, every window
  is certified, the ledger carries the ``elastic`` section and per-group
  device tags, the straggler drill steals and stays bitwise equal, the
  retry rung runs on its group's device, a preemption mid-round resumes
  to the same answer, ``warmup_devices`` reports per-device timings, and
  cache shards share the warm-start memory and mirror their counters;
* the port's elastic run against the JAX package's elastic run on its
  eight virtual devices (ROADMAP's hold-against rule: every window
  certified, objectives within the certificate's objective tolerance
  ``eps_obj`` = 2e-4 relative, the same statuses and per-group iteration
  counts within one check window of 128).
"""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from dervet_tpu import benchlib as jax_benchlib
from dervet_tpu.parallel import elastic as jax_elastic
from dervet_tpu.scenario import scenario as jax_scenario
from dervet_tpu.utils import faultinject as jax_faultinject
from dervet_tpu_torch import benchlib
from dervet_tpu_torch.io.summary import HEALTH_KEYS
from dervet_tpu_torch.parallel import elastic
from dervet_tpu_torch.scenario.scenario import (MicrogridScenario,
                                                SolverCache, run_dispatch)
from dervet_tpu_torch.utils import faultinject

torch.set_num_threads(1)

N_DEVICES = 8
EPS_OBJ = 2e-4          # ops/certify.CertPolicy.eps_obj
CHECK_WINDOW = 128      # PDHGOptions.check_every
ELASTIC_ENVS = (elastic.ELASTIC_ENV, elastic.ELASTIC_DEVICES_ENV)


def _eight_cpus(device=None):
    return [torch.device("cpu")] * N_DEVICES


@pytest.fixture
def seam(monkeypatch):
    monkeypatch.setattr(elastic, "visible_devices", _eight_cpus)


# ---------------------------------------------------------------------------
# Scheduler unit cases, over both packages
# ---------------------------------------------------------------------------

PACKAGES = {
    "jax": (jax_elastic, jax_scenario.SolverCache, jax_faultinject, "jax",
            None),
    "torch": (elastic, SolverCache, faultinject, "torch", "cpu"),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request, monkeypatch):
    mod, cache_cls, fi, backend, device = PACKAGES[request.param]
    if request.param == "torch":
        monkeypatch.setattr(elastic, "visible_devices", _eight_cpus)
    for k in ELASTIC_ENVS:
        monkeypatch.delenv(k, raising=False)

    def devices(b=backend):
        return (mod.elastic_devices(b) if device is None
                else mod.elastic_devices(b, device))
    return mod, cache_cls, fi, backend, devices


class TestScheduler:
    def test_env_parsing(self, pkg, monkeypatch):
        mod, _, _, backend, devices = pkg
        monkeypatch.setenv(mod.ELASTIC_ENV, "0")
        assert devices() is None
        monkeypatch.setenv(mod.ELASTIC_ENV, "1")
        assert devices("cpu") is None
        devs = devices()
        assert devs is not None and len(devs) == N_DEVICES
        monkeypatch.setenv(mod.ELASTIC_DEVICES_ENV, "2")
        assert len(devices()) == 2
        monkeypatch.setenv(mod.ELASTIC_DEVICES_ENV, "1")
        assert len(devices()) == 1

    def test_cost_estimate_uses_ledger_baseline(self, pkg):
        mod, cache_cls, _, _, _ = pkg
        cache = cache_cls()
        items = [(None, type("Ctx", (), {"T": 10})(), None)] * 4
        cold = mod.estimate_group_cost("k1", items, cache)
        assert cold == 4 * 10 * mod.DEFAULT_ITERS_BASELINE
        cache.note_iters("k1", 2000.0)
        assert mod.estimate_group_cost("k1", items, cache) == 4 * 10 * 2000.0
        # EWMA: feedback converges toward the latest measurement
        cache.note_iters("k1", 1000.0)
        assert cache.iters_hint("k1") == 1500.0

    def test_lpt_placement_balances_cost(self, pkg):
        mod = pkg[0]
        sched = mod.ElasticScheduler(["d0", "d1", "d2"])
        for i, cost in enumerate((100.0, 90.0, 50.0, 40.0, 30.0)):
            sched.submit(f"k{i}", [None], cost)
        assert sorted(sched.placed_cost) == [90.0, 100.0, 120.0]

    def test_affinity_overrides_balance(self, pkg):
        mod = pkg[0]
        sched = mod.ElasticScheduler(["d0", "d1"])
        sched.submit("k0", [None], 100.0)
        sched.submit("k1", [None], 100.0, affinity=0)
        assert sched.placed_cost == [200.0, 0.0]

    def test_workers_solve_and_steal_from_busy_straggler(self, pkg):
        """4 groups over 2 fake devices; device 0's solves are slow, so
        device 1 must steal device 0's queued group while 0 is busy —
        and every group still completes exactly once."""
        mod = pkg[0]
        sched = mod.ElasticScheduler(["slow", "fast"])

        def solve(device, idx, task):
            time.sleep(0.5 if device == "slow" else 0.05)
            return ("done", task.key)

        for i, cost in enumerate((100.0, 99.0, 98.0, 97.0)):
            sched.submit(f"k{i}", [None], cost)
        sched.start(solve)
        sched.close_submissions()
        done = []
        for task, result, err in sched.completions():
            assert err is None
            done.append(result[1])
        sched.shutdown()
        assert sorted(done) == ["k0", "k1", "k2", "k3"]
        st = sched.stats()
        assert st["n_steals"] >= 1
        assert st["devices"]["1"]["steals_in"] >= 1
        assert st["devices"]["0"]["steals_out"] >= 1

    def test_idle_victim_is_not_stolen_from(self, pkg):
        """A group queued on an idle device belongs to that device."""
        mod = pkg[0]
        sched = mod.ElasticScheduler(["a", "b"])
        order = []

        def solve(device, idx, task):
            order.append((task.key, device))
            time.sleep(0.02)
            return "ok"

        sched.submit("k0", [None], 10.0, affinity=0)
        sched.start(solve)
        time.sleep(0.3)
        sched.close_submissions()
        list(sched.completions())
        sched.shutdown()
        assert order == [("k0", "a")]
        assert sched.stats()["n_steals"] == 0

    def test_worker_error_propagates(self, pkg):
        mod = pkg[0]
        sched = mod.ElasticScheduler(["d0"])

        def solve(device, idx, task):
            raise RuntimeError("boom")

        sched.submit("k0", [None], 1.0)
        sched.start(solve)
        sched.close_submissions()
        (task, result, err), = list(sched.completions())
        sched.shutdown()
        assert isinstance(err, RuntimeError)

    def test_straggler_env_knobs_parse(self, pkg, monkeypatch):
        fi = pkg[2]
        monkeypatch.setenv("DERVET_TPU_FAULT_STRAGGLER", "1")
        monkeypatch.setenv("DERVET_TPU_FAULT_STRAGGLER_DEVICE", "3")
        monkeypatch.setenv("DERVET_TPU_FAULT_STRAGGLER_S", "0.25")
        plan = fi.get_plan()
        assert plan is not None and plan.straggler
        assert plan.straggler_device == 3
        assert plan.straggler_delay(3) == 0.25
        assert plan.straggler_delay(1) == 0.0
        assert (fi.EVENT_STRAGGLER, "3") in plan.fired


def test_visible_devices_without_the_seam():
    """On the CPU there is one device; ``device=None`` means the GPU and
    raises without one, as every entry point does."""
    assert elastic.visible_devices("cpu") == [torch.device("cpu")]
    assert elastic.elastic_devices("torch", "cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            elastic.visible_devices()


def test_worker_stream_is_a_no_op_off_cuda():
    with elastic.worker_stream(torch.device("cpu")):
        pass
    with elastic.worker_stream("a fake device"):
        pass


# ---------------------------------------------------------------------------
# The port's elastic dispatch on eight CPU entries
# ---------------------------------------------------------------------------

def _mixed_cases(lib=benchlib, lengths=(96, 168, 120)):
    """Window LENGTHS that differ across cases: distinct structure groups
    (plus their tail-window remainders), so a multi-device round has
    several groups to place and steal."""
    cases = []
    for i, n in enumerate(lengths):
        for c in lib.synthetic_sensitivity_cases(1, months=1, n=n, seed=i):
            cases.append(dataclasses.replace(c, case_id=f"w{n}.{c.case_id}"))
    return cases


def _dispatch(env=None, lengths=(96, 168, 120), **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(elastic, "visible_devices", _eight_cpus)
        for k in ELASTIC_ENVS:
            mp.delenv(k, raising=False)
        for k, v in (env or {}).items():
            mp.setenv(k, v)
        scens = [MicrogridScenario(c) for c in _mixed_cases(lengths=lengths)]
        run_dispatch(scens, backend="torch", device="cpu", **kw)
        return scens


@pytest.fixture(scope="module")
def elastic_run():
    return _dispatch()


@pytest.fixture(scope="module")
def single_run():
    return _dispatch({elastic.ELASTIC_DEVICES_ENV: "1"})


@pytest.fixture(scope="module")
def serial_run():
    return _dispatch({elastic.ELASTIC_ENV: "0"})


def _assert_identical(a_scens, b_scens):
    for sa, sb in zip(a_scens, b_scens):
        assert sa.quarantine is None and sb.quarantine is None
        assert sa.objective_values == sb.objective_values
        assert set(sa._solution) == set(sb._solution)
        for name in sa._solution:
            assert np.array_equal(sa._solution[name], sb._solution[name]), \
                (sa.case.case_id, name)


def _assert_close(a_scens, b_scens, obj_rtol=EPS_OBJ, x_atol=0.05):
    for sa, sb in zip(a_scens, b_scens):
        assert set(sa.objective_values) == set(sb.objective_values)
        for w in sa.objective_values:
            oa = sa.objective_values[w]["Total Objective"]
            ob = sb.objective_values[w]["Total Objective"]
            assert abs(oa - ob) <= obj_rtol * max(1.0, abs(ob)), (w, oa, ob)
        for name in sa._solution:
            assert np.allclose(sa._solution[name], sb._solution[name],
                               atol=x_atol, rtol=1e-3), name


def _ledger(scens):
    return scens[0].solve_metadata["solve_ledger"]


class TestSchedulerInvariance:
    def test_eight_vs_single_device_schedule_bitwise(self, elastic_run,
                                                     single_run):
        _assert_identical(elastic_run, single_run)

    def test_two_device_schedule_bitwise(self, single_run):
        scens = _dispatch({elastic.ELASTIC_DEVICES_ENV: "2"})
        assert _ledger(scens)["elastic"]["n_devices"] == 2
        _assert_identical(scens, single_run)

    def test_serial_scheduler_within_certification_tolerance(
            self, elastic_run, serial_run):
        """The plain pipeline splits every batch over the eight entries
        (``solve_batch_sharded``: no compaction, other batch widths), so
        against it agreement is at certification tolerance."""
        _assert_close(elastic_run, serial_run)
        initial = [g for g in _ledger(serial_run)["groups"]
                   if g.get("rung") == "initial"]
        assert any(g["sharded"] for g in initial)
        assert all(g["sharded"] == (g["batch"] > 1) for g in initial)

    @pytest.mark.parametrize("run", ["elastic_run", "serial_run"])
    def test_run_fully_certified(self, run, request):
        for s in request.getfixturevalue(run):
            cert = s.certification
            assert cert["rejected_final"] == 0
            assert cert["certified"] + cert["certified_loose"] \
                == len(s.windows)

    def test_serial_run_has_no_elastic_section(self, serial_run):
        assert "elastic" not in _ledger(serial_run)


class TestElasticLedger:
    def test_elastic_section_schema(self, elastic_run):
        el = _ledger(elastic_run)["elastic"]
        assert el["n_devices"] == N_DEVICES
        assert el["round_wall_s"] > 0
        assert el["devices_with_groups"] >= 2
        assert len(el["devices"]) == el["n_devices"]
        json.dumps(el)

    def test_group_entries_carry_device_axis(self, elastic_run):
        initial = [g for g in _ledger(elastic_run)["groups"]
                   if g.get("rung") == "initial"]
        assert initial
        for g in initial:
            assert isinstance(g["device"], int)
            assert 0 <= g["device"] < N_DEVICES
            assert g["sharded"] is False

    def test_per_device_slices_account_for_busy_wall(self, elastic_run):
        el = _ledger(elastic_run)["elastic"]
        for d, rec in el["devices"].items():
            if not rec["groups"]:
                continue
            assert rec["busy_s"] <= el["round_wall_s"] * 1.05
            assert rec["accounted_fraction"] is not None
            assert 0.5 <= rec["accounted_fraction"] <= 1.05, (d, rec)

    def test_device_windows_sum_to_round(self, elastic_run):
        led = _ledger(elastic_run)
        total = sum(rec["windows"] for rec in led["elastic"]["devices"]
                    .values())
        assert total == led["totals"]["windows"]

    def test_kernel_choice_recorded_per_group(self, elastic_run):
        led = _ledger(elastic_run)
        initial = [g for g in led["groups"] if g.get("rung") == "initial"]
        for g in initial:
            # the CPU runs the kernels' plain versions: reason 'backend'
            assert g["kernel"] == "torch_plain"
            assert g["kernel_fallback"] == "backend"
        assert led["kernel"]["fallback_reasons"] == {"backend": len(initial)}


class TestStragglerDrill:
    def test_straggler_is_stolen_from_and_results_correct(self, single_run):
        """Device 0 slowed on a 2-device schedule: the round records at
        least one steal, finishes every window, and stays byte-identical
        to the straggler-free single-device schedule."""
        with faultinject.inject(straggler=True, straggler_device=0,
                                straggler_seconds=1.5) as plan:
            scens = _dispatch({elastic.ELASTIC_DEVICES_ENV: "2"})
        assert any(ev == faultinject.EVENT_STRAGGLER for ev, _ in plan.fired)
        led = _ledger(scens)
        el = led["elastic"]
        assert el["n_devices"] == 2
        assert el["n_steals"] >= 1, el
        assert el["devices"]["1"]["steals_in"] >= 1
        stolen = [g for g in led["groups"] if g.get("stolen")]
        assert stolen and all(g["device"] == 1 for g in stolen)
        _assert_identical(scens, single_run)


class TestEscalationUnderElastic:
    def test_retry_rung_runs_on_the_groups_device(self):
        """Forced non-convergence inside an elastic round: the boosted
        retry re-solves the failed members on the SAME device slot, and
        its ledger entries carry the device tag."""
        with faultinject.inject(nonconverge="all", rungs={"solve"}):
            scens = _dispatch(lengths=(96,))
        s = scens[0]
        assert s.quarantine is None
        assert s.health["retried"] == len(s.windows)
        by_rung = {}
        for g in _ledger(scens)["groups"]:
            if g.get("rung") in ("initial", "retry"):
                by_rung.setdefault(g["batch"], {})[g["rung"]] = \
                    g.get("device")
        paired = [r for r in by_rung.values()
                  if "retry" in r and "initial" in r]
        assert paired
        for rungs in paired:
            assert isinstance(rungs["initial"], int)
            assert rungs["retry"] == rungs["initial"]


class TestDrainMidElasticRound:
    def test_preempt_flushes_and_resume_completes(self, tmp_path,
                                                  single_run):
        from dervet_tpu_torch.utils import supervisor as sup
        from dervet_tpu_torch.utils.errors import PreemptedError

        with faultinject.inject(preempt_after=1) as plan:
            with sup.RunSupervisor() as rs:
                with pytest.raises(PreemptedError):
                    _dispatch(checkpoint_dir=tmp_path, supervisor=rs)
        assert ("preempt", "1") in plan.fired
        manifest = json.loads(sup.manifest_path(tmp_path).read_text())
        assert manifest["cases"]
        scens = _dispatch(checkpoint_dir=tmp_path)
        _assert_identical(scens, single_run)


class TestWarmupDevices:
    def test_every_device_warmed_with_timings(self, seam):
        from dervet_tpu_torch.parallel.mesh import warmup_devices
        info = warmup_devices()
        assert info["n_devices"] == N_DEVICES
        assert info["platform"] == "cpu"
        assert sorted(info["warmup_s"]) == sorted(str(i)
                                                  for i in range(N_DEVICES))
        assert all(v > 0 for v in info["warmup_s"].values())
        assert info["warmup_total_s"] >= max(info["warmup_s"].values())

    def test_inventory_only_mode(self, seam):
        from dervet_tpu_torch.parallel.mesh import warmup_devices
        info = warmup_devices(per_device_solve=False,
                              devices=[torch.device("cpu")] * 2)
        assert "warmup_s" not in info and info["n_devices"] == N_DEVICES


class TestCacheShards:
    def test_shards_share_memory_and_mirror_counters(self):
        from dervet_tpu_torch.ops.warmstart import SolutionMemory
        mem = SolutionMemory()
        root = SolverCache(pad_grid=True, memory=mem)
        s0 = root.shard_for("cpu", 0)
        s1 = root.shard_for("cpu", 1)
        assert s0 is root.shard_for("cpu", 0)      # persistent
        assert s0.memory is mem and s1.memory is mem
        assert s0.pad_grid and s1.pad_grid
        assert s0.device == torch.device("cpu")
        s0.note_iters("k", 300.0)
        assert root.iters_hint("k") == s1.iters_hint("k") == 300.0

    def test_shard_builds_are_sticky_and_cloned(self):
        from dervet_tpu_torch.ops import lp as port_lp
        from tests.test_torch_parallel import battery_like_lp
        lp = battery_like_lp(port_lp.LPBuilder, T=16)
        root = SolverCache()
        s0 = root.shard_for("cpu", 0)
        solver0 = s0.get("k", lp, None)
        assert root.builds == 1
        assert root.device_index_for("k") == 0
        # a second shard copies the preconditioning instead of rebuilding
        s1 = root.shard_for("cpu", 1)
        solver1 = s1.get("k", lp, None)
        assert solver1 is not solver0
        assert solver1._solve_lock is not solver0._solve_lock
        assert solver1.dr is solver0.dr         # same device: shared
        assert root.builds == 2
        assert s1.get("k", lp, None) is solver1 and root.hits == 1
        assert root.structures_cached() == 1    # one structure, two shards
        root.clear()
        assert root.structures_cached() == 0
        assert root.device_index_for("k") is None


# ---------------------------------------------------------------------------
# Against the JAX package's elastic run (its eight virtual devices)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_elastic_run():
    import jax
    assert len(jax.devices()) >= N_DEVICES
    with pytest.MonkeyPatch.context() as mp:
        for k in ELASTIC_ENVS:
            mp.delenv(k, raising=False)
        scens = [jax_scenario.MicrogridScenario(c)
                 for c in _mixed_cases(lib=jax_benchlib)]
        jax_scenario.run_dispatch(scens, backend="jax")
    return scens


def test_elastic_run_matches_the_jax_packages(elastic_run, jax_elastic_run):
    ours, ref = elastic_run, jax_elastic_run
    assert [s.case.case_id for s in ours] == [s.case.case_id for s in ref]
    for sa, sb in zip(ours, ref):
        for s in (sa, sb):
            cert = s.certification
            assert cert["rejected_final"] == 0
            assert cert["certified"] + cert["certified_loose"] \
                == len(s.windows)
        # the same window statuses: clean, retried, on the CPU, ...
        assert {k: sa.health[k] for k in HEALTH_KEYS} == \
            {k: sb.health[k] for k in HEALTH_KEYS}
        assert set(sa.objective_values) == set(sb.objective_values)
        for w in sa.objective_values:
            oa = sa.objective_values[w]["Total Objective"]
            ob = sb.objective_values[w]["Total Objective"]
            assert abs(oa - ob) <= EPS_OBJ * (1.0 + abs(ob)), (w, oa, ob)
    la, lb = _ledger(ours), _ledger(ref)
    assert la["elastic"]["n_devices"] == lb["elastic"]["n_devices"]

    def groups(led):
        return sorted((g["m"], g["n"], g["batch"], g["iters_p50"],
                       g["iters_max"])
                      for g in led["groups"] if g.get("rung") == "initial")
    ga, gb = groups(la), groups(lb)
    assert [g[:3] for g in ga] == [g[:3] for g in gb]
    for a, b in zip(ga, gb):
        assert abs(a[3] - b[3]) <= CHECK_WINDOW and \
            abs(a[4] - b[4]) <= CHECK_WINDOW, (a, b)


class _Planned(Exception):
    pass


@pytest.mark.parametrize("switch,shards", [("0", 1), ("off", 1),
                                           ("false", 1), ("1", 2)])
def test_portfolio_shard_clamp_follows_the_kill_switch(seam, monkeypatch,
                                                       switch, shards):
    """Local portfolio shards on several devices run monolithically under
    the elastic kill switch, in each spelling ``elastic_enabled`` takes,
    and keep their count with the scheduler on."""
    from dervet_tpu_torch.portfolio import PortfolioSpec, shard
    from dervet_tpu_torch.portfolio import solve_portfolio
    from dervet_tpu_torch.portfolio.service import \
        synthetic_portfolio_members
    planned = []

    def plan(scens, n_shards):
        planned.append(n_shards)
        raise _Planned
    monkeypatch.setattr(shard, "plan_shards", plan)
    monkeypatch.setenv(elastic.ELASTIC_ENV, switch)
    spec = PortfolioSpec(members=synthetic_portfolio_members(
        2, hours=48, window=24, seed=0, pv_kw=9000.0),
        export_cap_kw=1e9, shards=2)
    with pytest.raises(_Planned):
        solve_portfolio(spec, backend="torch", device="cpu")
    assert planned == [shards]
