"""The port's scenario service (``dervet_tpu_torch.service``) against the
JAX package's, on the CPU.

* the admission queue, the journal, the load shedder, the poison
  registry, the client's backoff and the metrics registry: the JAX
  package's unit cases (``tests/test_service.py``,
  ``test_service_degradation.py``, ``test_telemetry.py``) run against
  both packages' classes, parametrized over the package;
* a coalesced round of ``_cases(2)`` + ``_cases(3)`` through the port's
  service (``backend="torch", device="cpu"``: the kernels' plain
  versions) and the JAX service (``backend="jax"``): the same statuses,
  every window certified on both sides, per-instance iteration counts
  equal, objectives within the certificate's 2e-4, the same batched
  windows and cross-request coalescing;
* the port's service against the port's solo ``DERVET.solve``: objectives,
  solutions and result CSVs byte-identical (its plain path is
  batch-invariant);
* ``backend="cpu"`` on both sides: the served results CSVs byte-identical
  (``run_health*``/``solve_ledger*`` JSON carry wall-clock and are left
  out);
* the hot service: a second mix builds nothing, an exact repeat
  substitutes every window and launches nothing (also with a 2-entry
  warm-start memory, where the JAX service evicts), a near request
  seeds, a shed round answers ``fidelity="degraded"`` uncertified;
* the loss drill: an injected ``DeviceLossError`` re-initializes once
  with no failover and the replay equals the undisturbed answer; three
  consecutive losses fail over to the CPU;
* ``is_backend_loss``: CUDA runtime death is a loss, build failures and
  shape/device/dtype errors are not;
* without a GPU, ``ScenarioService()``, ``warmup_device()`` and ``serve``
  without ``--device`` raise before anything is admitted;
* ``serve --once`` serves pickled payloads and a ``portfolio.json`` on
  both backends and parks a malformed portfolio request with its typed
  error; ``serve`` in its own process drains on SIGTERM and exits 0;
  a malformed portfolio request is refused at admission.
"""
import filecmp
import math
import pickle
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import dervet_tpu.service.journal as jax_journal
import dervet_tpu.service.queue as jax_queue
import dervet_tpu.service.resilience as jax_resilience
import dervet_tpu.telemetry.registry as jax_registry
from dervet_tpu import benchlib as jax_benchlib
from dervet_tpu.ops.pdhg import CompiledLPSolver as JaxSolver
from dervet_tpu.service import ScenarioClient as JaxClient
from dervet_tpu.service import ScenarioService as JaxService
from dervet_tpu_torch import benchlib
from dervet_tpu_torch.api import DERVET
from dervet_tpu_torch.ops import fused_chunk
from dervet_tpu_torch.ops.pdhg import CompiledLPSolver
from dervet_tpu_torch.service import ScenarioClient, ScenarioService
from dervet_tpu_torch.service import journal, queue, resilience
from dervet_tpu_torch.service.server import serve_main
from dervet_tpu_torch.telemetry import registry
from dervet_tpu_torch.utils import faultinject
from dervet_tpu_torch.utils.errors import (BackendLostError, BreakerOpenError,
                                          DeviceLossError, ParameterError)

torch.set_num_threads(2)

EPS_OBJ = 2e-4      # ops/certify.CertPolicy.eps_obj

PKGS = {
    "jax": SimpleNamespace(queue=jax_queue, journal=jax_journal,
                           resilience=jax_resilience,
                           registry=jax_registry, client=JaxClient),
    "torch": SimpleNamespace(queue=queue, journal=journal,
                             resilience=resilience, registry=registry,
                             client=ScenarioClient),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _cases(n, months=1, bump=0.0, lib=benchlib):
    cs = lib.synthetic_sensitivity_cases(n, months=months)
    if bump:
        for c in cs:
            for tag, _, keys in c.ders:
                if tag == "Battery":
                    keys["ene_max_rated"] = float(keys["ene_max_rated"]) \
                        * (1.0 + bump)
    return dict(enumerate(cs))


def _service(**kw):
    return ScenarioService(backend="torch", device="cpu", max_wait_s=0.0,
                           **kw)


def _objectives(res):
    return {k: inst.objective_values["Total Objective"].to_numpy()
            for k, inst in res.instances.items()}


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


# ---------------------------------------------------------------------------
# Unit cases, both packages
# ---------------------------------------------------------------------------

def _req(pkg, rid, **kw):
    return pkg.queue.QueuedRequest(rid, {0: None}, **kw)


def test_queue_fifo_within_priority(pkg):
    q = pkg.queue.AdmissionQueue(max_depth=8)
    for name in ("a", "b", "c"):
        q.put(_req(pkg, name))
    assert [r.request_id for r in q.take(max_batch=8, block=False)] == \
        ["a", "b", "c"]


def test_queue_priority_pops_first_fifo_breaks_ties(pkg):
    q = pkg.queue.AdmissionQueue(max_depth=8)
    for rid, pri in (("low1", 0), ("hi1", 5), ("low2", 0), ("hi2", 5)):
        q.put(_req(pkg, rid, priority=pri))
    assert [r.request_id for r in q.take(max_batch=8, block=False)] == \
        ["hi1", "hi2", "low1", "low2"]


def test_queue_bounded_depth_rejects_with_retry_after(pkg):
    q = pkg.queue.AdmissionQueue(max_depth=1)
    q.retry_after_s = 2.5
    q.put(_req(pkg, "a"))
    with pytest.raises(pkg.queue.QueueFullError) as ei:
        q.put(_req(pkg, "b"))
    assert ei.value.retry_after_s == 2.5
    assert q.counters["rejected_full"] == 1
    # observed drain: 4 requests a second; depth 1 + the retry -> 0.5 s
    q.note_round(requests_served=8, round_s=2.0)
    with pytest.raises(pkg.queue.QueueFullError) as ei:
        q.put(_req(pkg, "c"))
    assert ei.value.retry_after_s == pytest.approx(0.5)


def test_queue_take_respects_max_batch(pkg):
    q = pkg.queue.AdmissionQueue(max_depth=8)
    for i in range(5):
        q.put(_req(pkg, f"r{i}"))
    assert len(q.take(max_batch=2, block=False)) == 2
    assert q.depth() == 3


def test_queue_expired_request_answered_not_batched(pkg):
    q = pkg.queue.AdmissionQueue(max_depth=8)
    dead = _req(pkg, "dead", deadline_s=1e-9)
    q.put(dead)
    q.put(_req(pkg, "live"))
    time.sleep(0.01)
    assert [r.request_id for r in q.take(max_batch=8, block=False)] == \
        ["live"]
    with pytest.raises(pkg.queue.DeadlineExpiredError):
        dead.future.result(0)
    assert q.counters["expired"] == 1


def test_queue_closed_rejects(pkg):
    q = pkg.queue.AdmissionQueue(max_depth=8)
    q.close()
    with pytest.raises(pkg.queue.ServiceClosedError):
        q.put(_req(pkg, "a"))


def test_queue_fairness_floor(pkg):
    q = pkg.queue.AdmissionQueue(max_depth=64, fairness_after_s=0.05)
    q.put(_req(pkg, "starved", priority=0))
    time.sleep(0.06)
    for i in range(6):
        q.put(_req(pkg, f"hi{i}", priority=9))
    got = [r.request_id for r in q.take(max_batch=2, block=False)]
    assert got[0] == "starved"
    assert q.counters["fairness_promotions"] == 1


def test_journal_admitted_completed_replay(pkg, tmp_path):
    j = pkg.journal.ServiceJournal(tmp_path / "j.jsonl")
    j.admitted("a", file="a.csv")
    j.admitted("b", file="b.csv")
    j.completed("a")
    j.failed("c", error={"kind": "request_failed"})
    assert j.replay()["a"]["state"] == "completed"
    assert j.unfinished() == [("b", "b.csv")]
    j.close()


def test_journal_torn_tail_tolerated(pkg, tmp_path):
    path = tmp_path / "j.jsonl"
    j = pkg.journal.ServiceJournal(path)
    j.admitted("a", file="a.csv")
    j.close()
    with open(path, "a") as fh:         # a SIGKILL mid-append
        fh.write('{"event": "comple')
    j2 = pkg.journal.ServiceJournal(path)
    assert j2.unfinished() == [("a", "a.csv")]
    j2.close()


def test_journal_recover_spool(pkg, tmp_path):
    dirs = {n: tmp_path / n for n in ("incoming", "done", "failed")}
    for d in dirs.values():
        d.mkdir()
    for n in "xyz":
        (dirs["incoming"] / f"{n}.csv").write_text(n)
    j = pkg.journal.ServiceJournal(tmp_path / "j.jsonl")
    for n in "xyz":
        j.admitted(n, file=f"{n}.csv")
    j.completed("x")                    # killed before the move
    j.failed("z", error={"kind": "request_failed"})
    rec = j.recover_spool(dirs["incoming"], dirs["done"], dirs["failed"])
    assert rec["reserve"] == ["y"]
    assert sorted(rec["moved"]) == ["x", "z"]
    assert (dirs["done"] / "x.csv").exists()
    assert (dirs["failed"] / "z.csv").exists()
    assert (dirs["incoming"] / "y.csv").exists()
    j.close()


def test_shedder_requires_sustained_pressure(pkg):
    sh = pkg.resilience.LoadShedder(threshold_frac=0.5, sustain_rounds=2)
    assert not sh.observe(8, 8, 0)
    assert sh.observe(8, 8, 0)
    assert not sh.observe(0, 8, 0)
    assert not sh.observe(8, 8, 0)
    certified, degraded = sh.partition(
        [_req(pkg, "a", priority=0), _req(pkg, "b", priority=1)])
    assert [r.request_id for r in certified] == ["b"]
    assert [r.request_id for r in degraded] == ["a"]
    assert sh.snapshot()["degraded_by_kind"] == {"scenario": 1}


def test_poison_registry_two_strikes(pkg):
    reg = pkg.resilience.PoisonRegistry(threshold=2)
    fp = "f" * 64
    assert reg.blocked(fp) is None
    assert reg.strike(fp, "r1", "boom") == 1
    assert reg.blocked(fp) is None
    assert reg.strike(fp, "r2", "boom again") == 2
    assert reg.blocked(fp) == "boom again"
    assert reg.snapshot()["quarantined"] == 1


def test_request_fingerprints_equal_across_packages():
    """The poison key hashes case content the same way in both."""
    for bump in (0.0, 0.01):
        ours = resilience.request_fingerprint(_cases(2, bump=bump))
        ref = jax_resilience.request_fingerprint(
            _cases(2, bump=bump, lib=jax_benchlib))
        assert ours == ref
    assert resilience.request_fingerprint(_cases(2)) != \
        resilience.request_fingerprint(_cases(2, bump=0.01))


def test_client_backoff_capped_and_jittered(pkg):
    client = pkg.client(object(), backoff_cap_s=2.0, jitter_frac=0.25,
                        jitter_seed=7)
    waits = {client._backoff_s(100.0) for _ in range(16)}
    assert all(1.5 <= w <= 2.5 for w in waits) and len(waits) > 1
    a, b = (pkg.client(object(), jitter_seed=3) for _ in range(2))
    assert [a._backoff_s(1.0) for _ in range(5)] == \
        [b._backoff_s(1.0) for _ in range(5)]


def test_registry_counter_gauge_histogram(pkg):
    reg = pkg.registry.MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(2)
    assert reg.counter("c").value == 3
    with pytest.raises(ValueError):
        reg.counter("c").inc(-1)
    reg.gauge("g", replica="a").set(4.5)
    assert reg.gauge("g", replica="a").value == 4.5
    reg.histogram("h").observe(0.5)
    snap = reg.histogram("h").snapshot()
    assert snap["count"] == 1 and snap["sum"] == 0.5
    with pytest.raises(TypeError):
        reg.gauge("c")


def test_registry_histogram_merge_exact(pkg):
    treg = pkg.registry
    a, b = treg.Histogram("h", {}), treg.Histogram("h", {})
    obs_a, obs_b = [0.001, 0.5, 2.0, 100.0], [0.002, 0.25, 3.0]
    a.observe_many(obs_a)
    b.observe_many(obs_b)
    merged = treg.merge_histograms([a.snapshot(), b.snapshot()])
    ref = treg.Histogram("h", {})
    ref.observe_many(obs_a + obs_b)
    assert merged["buckets"] == ref.snapshot()["buckets"]
    assert merged["count"] == 7
    assert math.isclose(merged["sum"], sum(obs_a + obs_b))
    for q in (0.5, 0.99):
        assert treg.quantile_from_buckets(merged, q) == \
            treg.quantile_from_buckets(ref.snapshot(), q)
    with pytest.raises(ValueError, match="layout"):
        treg.merge_histograms([{"count": 1, "sum": 1.0, "buckets": [1, 0],
                                "overflow": 0}])


def test_registry_prometheus_round_trip(pkg, tmp_path):
    treg = pkg.registry
    reg = treg.MetricsRegistry()
    reg.counter("dervet_requests_total", outcome="completed").inc(5)
    reg.counter("dervet_breaker_trips_total",
                replica='we"ird\\na\nme').inc(2)
    reg.gauge("dervet_queue_depth").set(3)
    reg.histogram("dervet_request_latency_seconds").observe_many(
        [0.01, 0.2, 0.2, 4.0])
    text = reg.to_prometheus()
    parsed = treg.parse_prometheus(text)
    assert treg.sample_value(parsed, "dervet_requests_total",
                             {"outcome": "completed"}) == 5
    assert treg.sample_value(parsed, "dervet_breaker_trips_total",
                             {"replica": 'we"ird\\na\nme'}) == 2
    assert treg.sample_value(parsed, "dervet_queue_depth") == 3
    hist = treg.histogram_from_parsed(parsed,
                                      "dervet_request_latency_seconds")
    orig = reg.histogram("dervet_request_latency_seconds").snapshot()
    assert hist["buckets"] == orig["buckets"]
    path = reg.write_prom(tmp_path / "telemetry.prom")
    assert treg.sample_value(treg.parse_prometheus(path.read_text()),
                             "dervet_queue_depth") == 3
    assert not list(tmp_path.glob(".*tmp"))


def test_registry_exposition_equal_across_packages():
    """The same observations expose the same Prometheus text in both
    packages (one bucket layout, so replicas of either merge)."""
    texts = []
    for treg in (registry, jax_registry):
        reg = treg.MetricsRegistry()
        reg.counter("dervet_windows_total").inc(12)
        reg.gauge("dervet_queue_depth").set(2)
        reg.histogram("dervet_request_latency_seconds").observe_many(
            [0.003, 0.07, 1.5, 40.0])
        # the last line stamps the exposition's wall-clock time
        texts.append(reg.to_prometheus().splitlines()[:-1])
    assert texts[0] == texts[1]
    assert registry.HIST_BOUNDS == jax_registry.HIST_BOUNDS


def test_registry_series_ring_buffer_bounded(pkg):
    treg = pkg.registry
    reg = treg.MetricsRegistry()
    g = reg.gauge("depth")
    for i in range(treg.SERIES_CAP + 10):
        g.set(i)
        reg.sample()
    series = reg.series("depth")
    assert len(series) == treg.SERIES_CAP
    assert series[-1][1] == treg.SERIES_CAP + 9


# ---------------------------------------------------------------------------
# is_backend_loss: CUDA death is a loss, code faults are not
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exc,loss", [
    (DeviceLossError("injected"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     True),
    (RuntimeError("banded_chunk kernel launch failed: CUDA error 700 (an "
                  "illegal memory access was encountered)"), True),
    (RuntimeError("dense_chunk kernel launch failed: CUDA error 719 "
                  "(unspecified launch failure)"), True),
    (RuntimeError("CUDA error: device-side assert triggered"), True),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"), True),
    (RuntimeError("CUDA driver error: unknown error"), True),
    (RuntimeError("No CUDA GPUs are available"), True),
    (RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                  "fused_chunk.cu"), False),
    (RuntimeError("nvcc failed (1) building fused_chunk.cu:\nerror: an "
                  "illegal memory access in a comment"), False),
    (RuntimeError("banded_chunk kernel launch failed: CUDA error 1 "
                  "(invalid argument)"), False),
    (ValueError("banded_chunk does not take m=9000 n=9000 nb=12 "
                "variant='reflected'"), False),
    (ValueError("dense_chunk: x is on cpu, expected cuda:0"), False),
    (TypeError("dense_chunk: c must be torch.float32, got torch.float64"),
     False),
    (RuntimeError("some bug"), False),
    (KeyError("illegal memory access"), False),
], ids=["injected", "illegal-address", "kernel-illegal-address",
        "kernel-launch-failure", "assert", "ecc", "driver", "no-gpu",
        "nvcc-not-found", "nvcc-failed", "kernel-invalid-argument",
        "unsupported-shape", "wrong-device", "wrong-dtype", "plain-bug",
        "not-a-runtime-error"])
def test_is_backend_loss(exc, loss):
    assert resilience.is_backend_loss(exc) is loss


def test_accelerator_error_is_a_loss():
    accel = getattr(torch, "AcceleratorError", None)
    if accel is None:
        pytest.skip("this torch has no torch.AcceleratorError")
    assert resilience.is_backend_loss(accel("CUDA error: unknown error"))


# ---------------------------------------------------------------------------
# The coalesced round against the JAX service
# ---------------------------------------------------------------------------

def _record_iters(mp, cls, sink):
    real = cls.solve

    def solve(self, *a, **k):
        res = real(self, *a, **k)
        sink.append(np.asarray(res.iters).tolist())
        return res

    mp.setattr(cls, "solve", solve)


@pytest.fixture(scope="module")
def coalesced():
    """``_cases(2)`` and ``_cases(3)`` coalesced into one round of each
    package's service, every solve call's per-instance iterations
    recorded; the port's solo solves of the same cases."""
    iters = {"jax": [], "torch": []}
    out = {"iters": iters}
    with pytest.MonkeyPatch.context() as mp:
        _record_iters(mp, JaxSolver, iters["jax"])
        _record_iters(mp, CompiledLPSolver, iters["torch"])
        for name, svc, lib in (
                ("jax", JaxService(backend="jax", max_wait_s=0.0),
                 jax_benchlib),
                ("torch", _service(), benchlib)):
            fa = svc.submit(_cases(2, lib=lib), request_id="reqA")
            fb = svc.submit(_cases(3, lib=lib), request_id="reqB")
            served = svc.run_once()
            out[name] = {"svc": svc, "served": served,
                         "res": {"reqA": fa.result(0), "reqB": fb.result(0)}}
    out["solo"] = {rid: DERVET.from_cases(_cases(n)).solve(
        backend="torch", device="cpu") for rid, n in (("reqA", 2),
                                                      ("reqB", 3))}
    yield out
    for name in ("jax", "torch"):
        out[name]["svc"].close()


def test_coalesced_round_matches_jax(coalesced):
    ours, ref = coalesced["torch"], coalesced["jax"]
    assert ours["served"] == ref["served"] == 2
    for rid in ("reqA", "reqB"):
        a, b = ours["res"][rid], ref["res"][rid]
        assert sorted(a.instances) == sorted(b.instances)
        for res in (a, b):
            cert = res.run_health["certification"]
            n_win = sum(len(i.scenario.windows)
                        for i in res.instances.values())
            assert cert["enabled"] and cert["windows_certified"] == n_win
            assert cert["windows"]["rejected_final"] == 0
            assert res.run_health["windows"]["clean"] == n_win
        assert a.run_health["windows"] == b.run_health["windows"]
        oa, ob = _objectives(a), _objectives(b)
        for k in oa:
            assert _rel(oa[k], ob[k]).max() < EPS_OBJ, (rid, k)
        sa, sb = a.solve_ledger, b.solve_ledger
        assert sa["totals"]["batched_windows"] == \
            sb["totals"]["batched_windows"] == 5
        assert sa["coalesced_groups"] == sb["coalesced_groups"] >= 1


def test_coalesced_iteration_counts_equal(coalesced):
    """Per-instance iteration counts of every solve call are equal: the
    port's plain chunk follows the JAX solver step for step."""
    ours, ref = coalesced["iters"]["torch"], coalesced["iters"]["jax"]
    assert ours and ours == ref
    led_a = coalesced["torch"]["svc"].last_round_ledger
    led_b = coalesced["jax"]["svc"].last_round_ledger
    key = ("m", "n", "batch", "padded_to", "requests", "iters_p50",
           "iters_max")
    assert [tuple(g.get(k) for k in key) for g in led_a["groups"]] == \
        [tuple(g.get(k) for k in key) for g in led_b["groups"]]


def test_coalesced_metrics_match_jax(coalesced):
    ma = coalesced["torch"]["svc"].metrics()
    mb = coalesced["jax"]["svc"].metrics()
    for m in (ma, mb):
        assert m["requests"]["completed"] == 2
        assert m["latency_s"]["n"] == 2
        assert m["latency_s"]["p99"] >= m["latency_s"]["p50"] > 0
    assert ma["batch_occupancy"] == mb["batch_occupancy"]
    assert ma["queue"] == mb["queue"]
    assert ma["service"]["backend"] == "torch"
    assert ma["compile_cache"]["solver_builds"] == 1


def test_service_byte_identical_to_solo(coalesced, tmp_path):
    """The port's service answers exactly what the port's solo solve of
    the same cases answers: objectives, solution arrays, result CSVs."""
    for rid in ("reqA", "reqB"):
        solo, srv = coalesced["solo"][rid], coalesced["torch"]["res"][rid]
        for k in solo.instances:
            s, v = solo.instances[k].scenario, srv.instances[k].scenario
            assert s.objective_values == v.objective_values
            assert set(s._solution) == set(v._solution)
            for name in s._solution:
                assert np.array_equal(s._solution[name], v._solution[name])
        solo.save_as_csv(tmp_path / rid / "solo")
        srv.save_as_csv(tmp_path / rid / "srv")
        names = sorted(p.name for p in (tmp_path / rid / "solo").glob("*.csv"))
        assert names == sorted(
            p.name for p in (tmp_path / rid / "srv").glob("*.csv"))
        match, mismatch, errors = filecmp.cmpfiles(
            tmp_path / rid / "solo", tmp_path / rid / "srv", names,
            shallow=False)
        assert match == names, (mismatch, errors)
        assert (tmp_path / rid / "srv" / f"run_health.{rid}.json").exists()
        assert (tmp_path / rid / "srv" / f"solve_ledger.{rid}.json").exists()


def test_cpu_backend_service_csvs_byte_identical(tmp_path):
    outs = {}
    for name, svc, lib in (("jax", JaxService(backend="cpu",
                                              max_wait_s=0.0), jax_benchlib),
                           ("torch", ScenarioService(backend="cpu",
                                                     max_wait_s=0.0),
                            benchlib)):
        fa = svc.submit(_cases(1, months=2, lib=lib), request_id="a")
        fb = svc.submit(_cases(2, lib=lib), request_id="b")
        assert svc.run_once() == 2
        for rid, fut in (("a", fa), ("b", fb)):
            fut.result(0).save_as_csv(tmp_path / name / rid)
        svc.close()
    for rid in ("a", "b"):
        d_t, d_j = tmp_path / "torch" / rid, tmp_path / "jax" / rid
        names = sorted(p.name for p in d_t.iterdir()
                       if p.suffix == ".csv")
        assert names == sorted(p.name for p in d_j.iterdir()
                               if p.suffix == ".csv") and len(names) > 5
        assert sorted(p.name for p in d_t.iterdir()) == \
            sorted(p.name for p in d_j.iterdir())
        match, mismatch, errors = filecmp.cmpfiles(d_j, d_t, names,
                                                   shallow=False)
        assert match == names, (mismatch, errors)


# ---------------------------------------------------------------------------
# The hot service
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hot():
    """One warm port service: a first round, a different mix, an exact
    repeat of the first round's second request, a near request."""
    svc = _service()
    out = {"svc": svc}
    f = [svc.submit(_cases(2), request_id="first"),
         svc.submit(_cases(3, bump=0.05), request_id="second")]
    svc.run_once()
    out["second"] = f[1].result(0)
    out["builds_0"] = svc.solver_cache.builds
    f = [svc.submit(_cases(1, bump=0.11), request_id="mix1"),
         svc.submit(_cases(4, bump=0.13), request_id="mix2")]
    assert svc.run_once() == 2
    [x.result(0) for x in f]
    out["mix_ledger"] = svc.last_round_ledger
    out["builds_1"] = svc.solver_cache.builds
    fused_chunk.reset_launch_counts()
    f = svc.submit(_cases(3, bump=0.05), request_id="repeat")
    svc.run_once()
    out["repeat"] = f.result(0)
    out["repeat_ledger"] = svc.last_round_ledger
    out["repeat_launches"] = dict(fused_chunk.LAUNCHES)
    f = svc.submit(_cases(3, bump=0.07), request_id="near")
    svc.run_once()
    out["near"] = f.result(0)
    out["near_ledger"] = svc.last_round_ledger
    yield out
    svc.close()


def test_second_mix_builds_nothing(hot):
    assert hot["builds_1"] == hot["builds_0"] == 1
    assert hot["svc"].solver_cache.hits >= 1
    led = hot["mix_ledger"]
    assert led["totals"]["compile_events"] == 0
    assert all(g.get("padded_to") == 8 for g in led["groups"])


def test_exact_repeat_substitutes_every_window(hot):
    led = hot["repeat_ledger"]
    assert led["warm_start"]["substituted"] == 3
    assert not any(g.get("kernel_launches") for g in led["groups"])
    assert hot["repeat_launches"] == {k: 0 for k in fused_chunk.KERNELS}
    assert _objectives(hot["repeat"]).keys() == \
        _objectives(hot["second"]).keys()
    for k, v in _objectives(hot["repeat"]).items():
        assert v.tobytes() == _objectives(hot["second"])[k].tobytes()
    m = hot["svc"].metrics()
    assert m["rounds"]["substituted_windows"] >= 3


def test_near_request_seeds(hot):
    warm = hot["near_ledger"]["warm_start"]
    assert warm["seeded"] == 3 and warm["substituted"] == 0, warm
    assert warm["exact"] == 0 and warm["near"] + warm["predicted"] == 3
    cert = hot["near"].run_health["certification"]
    assert cert["windows_certified"] == 3


def test_repeat_substitutes_with_a_small_memory(monkeypatch):
    """The memory holds one entry per window; the round raises it to
    hold its own windows, so a repeat substitutes every one even under
    a 2-entry cap (the JAX service keeps the cap and substitutes 2 of 4
    windows here)."""
    monkeypatch.setenv("DERVET_TPU_WARMSTART_CAP", "2")
    svc = _service()
    f = svc.submit(_cases(4), request_id="a")
    svc.run_once()
    first = f.result(0)
    f = svc.submit(_cases(4), request_id="b")
    svc.run_once()
    warm = svc.last_round_ledger["warm_start"]
    assert warm["substituted"] == 4 and warm["exact"] == 4
    assert svc.solver_cache.memory.stats["evictions"] == 0
    for k, v in _objectives(f.result(0)).items():
        assert v.tobytes() == _objectives(first)[k].tobytes()
    svc.close()


def test_degraded_round_marked_and_uncertified():
    svc = _service(max_queue_depth=4, max_batch_requests=4,
                   shed_threshold_frac=0.5, shed_sustain_rounds=1)
    futs = {i: svc.submit(_cases(1, bump=0.01 * i), request_id=f"d{i}",
                          priority=i % 2) for i in range(4)}
    assert svc.run_once() == 4
    for i, fut in futs.items():
        res = fut.result(0)
        cert = res.run_health["certification"]
        if i % 2:
            assert res.fidelity == "certified"
            assert cert["enabled"] and cert["windows_certified"] == 1
        else:
            assert res.fidelity == "degraded"
            assert res.run_health["fidelity"] == "degraded"
            assert not cert["enabled"] and cert["windows_certified"] == 0
            assert "resubmit" in res.resubmit_hint
    m = svc.metrics()
    assert m["rounds"]["degraded_rounds"] == 1
    assert m["resilience"]["load_shedding"]["degraded_requests"] == 2
    svc.close()


# ---------------------------------------------------------------------------
# Backend loss
# ---------------------------------------------------------------------------

def test_loss_drill_reinits_once_and_replays_exactly():
    undisturbed = _service()
    f = undisturbed.submit(_cases(2, months=2), request_id="u")
    undisturbed.run_once()
    want = _objectives(f.result(0))
    undisturbed.close()
    svc = _service()
    with faultinject.inject(device_loss=True, device_loss_n=1) as plan:
        f = svc.submit(_cases(2, months=2), request_id="dl")
        assert svc.run_once() == 1
    assert [k for k, _ in plan.fired].count(
        faultinject.EVENT_DEVICE_LOSS) == 1
    res = f.result(0)
    rec = svc.metrics()["resilience"]["backend_recovery"]
    assert (rec["losses"], rec["reinits"], rec["rounds_lost"]) == (1, 1, 0)
    assert res.fidelity == "certified"
    assert res.run_health["certification"]["windows_certified"] == 4
    assert all(g["backend"] == "torch"
               for g in svc.last_round_ledger["groups"])
    for k, v in _objectives(res).items():
        assert v.tobytes() == want[k].tobytes()
    svc.close()


def test_consecutive_losses_fail_the_round_typed():
    """Past its re-init budget a round is lost: its requests fail with
    the typed BackendLostError, counted as failed and against the
    backend breaker — nothing is answered from the CPU instead."""
    svc = _service(backend_max_reinits=2)
    with faultinject.inject(device_loss=True, device_loss_n=3):
        f = svc.submit(_cases(2), request_id="lost")
        with pytest.raises(BackendLostError):
            svc.run_once()
    err = f.exception(0)
    assert isinstance(err, BackendLostError) and err.kind == "backend_lost"
    assert "2 re-init attempts" in str(err)
    m = svc.metrics()
    rec = m["resilience"]["backend_recovery"]
    assert (rec["losses"], rec["reinits"], rec["reinit_failures"],
            rec["rounds_lost"]) == (1, 0, 2, 1)
    assert (m["requests"]["completed"], m["requests"]["failed"]) == (0, 1)
    assert svc.last_round_ledger is None
    svc.close()


def test_open_certify_breaker_refuses_the_round():
    """While the certify breaker is open a round's requests fail fast
    with the typed BreakerOpenError and nothing is dispatched (no CPU
    answer in the card's place); once it closes the service certifies
    again."""
    svc = _service()
    svc.breakers.configure("certify", min_samples=1, cooldown_s=3600.0)
    svc.breakers.record("certify", False)
    f = svc.submit(_cases(1), request_id="storm")
    assert svc.run_once() == 1
    err = f.exception(0)
    assert isinstance(err, BreakerOpenError) and err.retry_hint > 0
    assert svc.solver_cache.builds == 0
    assert svc.metrics()["requests"]["failed"] == 1
    svc.breakers.configure("certify")
    f = svc.submit(_cases(1), request_id="calm")
    assert svc.run_once() == 1
    assert f.result(0).fidelity == "certified"
    svc.close()


# ---------------------------------------------------------------------------
# Admission surface
# ---------------------------------------------------------------------------

def test_portfolio_refused_at_admission(tmp_path):
    """Portfolio requests are served now; a malformed one is refused at
    admission, typed, with nothing queued: a one-site spec, a shard with
    no sites (directly and as a pickled spool payload)."""
    from dervet_tpu_torch.portfolio import PortfolioSpec
    from dervet_tpu_torch.portfolio.service import \
        synthetic_portfolio_members
    svc = _service()
    one_site = PortfolioSpec(members=synthetic_portfolio_members(
        1, hours=48, window=24), export_cap_kw=1e9)
    with pytest.raises(ParameterError, match=">= 2 sites"):
        svc.submit_portfolio(one_site, request_id="p")
    with pytest.raises(ValueError, match="non-empty 'sites'"):
        svc.submit_portfolio_shard({"sites": {}}, request_id="s")
    path = tmp_path / "shard.pkl"
    path.write_bytes(pickle.dumps({"portfolio_shard": {"sites": {}}}))
    with pytest.raises(ValueError, match="non-empty 'sites'"):
        svc.submit_pickle(path, request_id="s2")
    assert svc.queue.depth() == 0 and not svc._active_ids
    svc.close()


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_none_raises_without_gpu(no_gpu, tmp_path):
    from dervet_tpu_torch.device import warmup_device
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScenarioService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warmup_device()
    spool = tmp_path / "spool"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main([str(spool), "--once"])
    assert not spool.exists()       # nothing created, nothing admitted
    # the exact backend takes no device; a named CPU device is explicit
    ScenarioService(backend="cpu").close()
    assert warmup_device("cpu", solve=False)["platform"] == "cpu"


def test_warmup_device_on_cpu():
    from dervet_tpu_torch.device import warmup_device
    info = warmup_device("cpu")
    assert set(info) == {"n_devices", "platform", "device_kind",
                         "warmup_s"}
    assert info["platform"] == "cpu" and info["warmup_s"] >= 0
    with _service() as svc:
        assert svc.metrics()["service"]["device"]["platform"] == "cpu"


def test_started_service_serves_on_its_batcher_thread():
    with _service() as svc:
        fut = svc.submit(_cases(1, bump=0.3), request_id="t")
        res = fut.result(timeout=120)
        assert svc._thread is not None and svc._thread.is_alive()
    assert res.fidelity == "certified"
    assert svc.metrics()["requests"]["completed"] == 1


# ---------------------------------------------------------------------------
# The spool serve loop
# ---------------------------------------------------------------------------

def _payload(n, bump):
    return {"cases": _cases(n, bump=bump), "priority": 0}


@pytest.mark.parametrize("backend", ["torch", "cpu"])
def test_serve_once_spool(backend, tmp_path):
    import json
    spool = tmp_path / "spool"
    (spool / "incoming").mkdir(parents=True)
    for rid, (n, bump) in {"p1": (1, 0.2), "p2": (2, 0.4)}.items():
        (spool / "incoming" / f"{rid}.pkl").write_bytes(
            pickle.dumps(_payload(n, bump)))
    (spool / "incoming" / "folio.json").write_text(json.dumps(
        {"portfolio": {"synthetic_members": {"sites": 2, "hours": 48,
                                             "window": 24},
                       "export_cap_kw": 1e9, "max_outer": 4}}))
    (spool / "incoming" / "bad.json").write_text(
        json.dumps({"portfolio": {"sites": []}}))
    rc = serve_main([str(spool), "--once", "--backend", backend,
                     "--device", "cpu", "--heartbeat-s", "0"])
    assert rc == 0
    for rid in ("p1", "p2"):
        out = spool / "results" / rid
        assert (out / f"run_health.{rid}.json").exists()
        assert list(out.glob("timeseries_results*.csv"))
        assert (spool / "done" / f"{rid}.pkl").exists()
        health = json.loads((out / f"run_health.{rid}.json").read_text())
        assert health["fidelity"] == "certified"
    folio = json.loads((spool / "results" / "folio" / "portfolio.json")
                       .read_text())
    assert folio["converged"] and folio["certification"]["verdict"] in (
        "certified", "certified_loose")
    assert (spool / "done" / "folio.json").exists()
    err = json.loads((spool / "failed" / "bad.json.error.json")
                     .read_text())
    assert err["error"] == "ParameterError" and "members" in \
        err["message"]
    metrics = json.loads((spool / "service_metrics.json").read_text())
    assert metrics["requests"]["completed"] == 3
    assert metrics["service"]["backend"] == backend
    states = journal.ServiceJournal.replay_path(
        spool / "service_journal.jsonl")
    assert {r: s["state"] for r, s in states.items()} == \
        {"p1": "completed", "p2": "completed", "folio": "completed"}


def test_serve_loop_drains_on_sigterm(tmp_path):
    """``serve SPOOL`` (no ``--once``) in its own process: it beats, and
    a SIGTERM drains the service and exits 0 with its metrics written."""
    import json
    import pathlib
    import signal
    import subprocess
    import sys
    spool = tmp_path / "spool"
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "dervet_tpu_torch", "serve", str(spool),
         "--device", "cpu", "--heartbeat-s", "0.1", "--poll-s", "0.1"],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        t0 = time.monotonic()
        while not (spool / "heartbeat.json").exists():
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() - t0 < 60, "no heartbeat"
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert json.loads((spool / "heartbeat.json").read_text())["draining"]
    metrics = json.loads((spool / "service_metrics.json").read_text())
    assert metrics["service"]["draining"]
