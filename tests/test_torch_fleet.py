"""The port's fleet tier (``dervet_tpu_torch.service.{fleet,router,
lifecycle,reqcache}``) on the CPU.

* The JAX package's fleet cases — ``tests/test_fleet.py`` (structure
  fingerprint, memory handoff, replica faults, journal races, routing,
  failover, epoch fencing, hedging, in-process and spool fleets),
  ``tests/test_fleet_lifecycle.py`` (respawn, backoff, quarantine,
  autoscaling, the state file) and the fleet cases of
  ``tests/test_telemetry.py`` — run here against the port's classes, the
  same bodies with the package swapped; their own files run them
  against the JAX package.
* Spawned port replicas (``python -m dervet_tpu_torch serve --device
  cpu``): affinity routing, a SIGKILL failover answered exactly once and
  byte-identical to a single-replica run, a request-cache hit, the
  supervisor's respawn, and the lost-backend exit: a child whose
  ``device_loss`` plan outlives its re-init budget exits
  ``EXIT_BACKEND_LOST`` with its round unanswered, the router re-routes
  the request and the sibling answers.
* ``spawn_replica``'s child command names ``dervet_tpu_torch`` and never
  ``jax``.
"""
import json
import pickle
import threading
import time

import numpy as np
import pytest
import torch

from dervet_tpu_torch.benchlib import synthetic_sensitivity_cases
from dervet_tpu_torch.ops.lp import LP
from dervet_tpu_torch.ops.warmstart import SolutionMemory
from dervet_tpu_torch.service import (FleetRouter, FleetUnavailableError,
                                      LocalReplica, QueueFullError,
                                      ScenarioClient, ScenarioService,
                                      ServiceJournal)
from dervet_tpu_torch.service.fleet import (MEMORY_EXPORT_FILE,
                                            ReplicaHandle, SpoolReplica,
                                            structure_fingerprint)
from dervet_tpu_torch.service.lifecycle import (BACKOFF, QUARANTINED,
                                                STOPPED, UP,
                                                FleetSupervisor,
                                                ReplicaSpec,
                                                supervision_enabled)
from dervet_tpu_torch.telemetry import trace as ttrace
from dervet_tpu_torch.utils import faultinject
from dervet_tpu_torch.utils.breaker import CircuitBreaker
from dervet_tpu_torch.utils.errors import ReplicaQuarantinedError

torch.set_num_threads(2)


def _cases(n=1, window=None, months=1, variant=0):
    kwargs = {"months": months}
    if window is not None:
        kwargs["n"] = window
    cases = synthetic_sensitivity_cases(n, **kwargs)
    for c in cases:
        for tag, _, keys in c.ders:
            if tag == "Battery":
                keys["ene_max_rated"] = \
                    float(keys["ene_max_rated"]) + 0.5 * variant
    return {i: c for i, c in enumerate(cases)}


# ---------------------------------------------------------------------------
# Structure fingerprint (the affinity key)
# ---------------------------------------------------------------------------

class TestStructureFingerprint:
    def test_content_invariant(self):
        # different prices/ratings, same structure -> same fingerprint
        assert structure_fingerprint(_cases(variant=0)) == \
            structure_fingerprint(_cases(variant=7))

    def test_window_scheme_changes_it(self):
        assert structure_fingerprint(_cases(window=72)) != \
            structure_fingerprint(_cases(window=96))

    def test_der_set_changes_it(self):
        a = _cases()
        b = _cases()
        b[0].ders.pop()             # drop the PV
        assert structure_fingerprint(a) != structure_fingerprint(b)

    def test_horizon_changes_it(self):
        assert structure_fingerprint(_cases(months=1)) != \
            structure_fingerprint(_cases(months=2))


# ---------------------------------------------------------------------------
# Warm-start memory export/import (the failover handoff)
# ---------------------------------------------------------------------------

def _lp(seed=0, n=6, m=4):
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    return LP(c=rng.normal(size=n),
              K=sp.csr_matrix(rng.normal(size=(m, n))),
              q=rng.normal(size=m), n_eq=2, l=np.full(n, -10.0),
              u=np.full(n, 10.0), var_refs={}, row_groups={})


class _Opts:
    eps_abs = 1e-4
    eps_rel = 1e-4
    max_iters = 1000
    inaccurate_factor = 10.0
    dtype = np.float32


class TestMemoryHandoff:
    def test_export_import_roundtrip_exact_grade(self):
        from dervet_tpu_torch.ops.warmstart import data_digest, opts_tag
        mem = SolutionMemory(max_entries=16)
        lp = _lp()
        tag = opts_tag(_Opts)
        mem.store("s1", lp, tag, np.ones(lp.n), np.ones(lp.m), 1.0)
        blob = pickle.dumps(mem.export_entries())

        other = SolutionMemory(max_entries=16)
        assert other.import_entries(pickle.loads(blob)) == 1
        assert other.snapshot()["imported"] == 1
        entry, kind = other.lookup("s1", lp, tag)
        assert kind == "exact"
        np.testing.assert_array_equal(entry.x, np.ones(lp.n))
        # and the key carries the same digest the donor computed
        assert entry.exact == data_digest(lp, np.float32)

    def test_exact_only_import_invisible_to_near(self):
        from dervet_tpu_torch.ops.warmstart import opts_tag
        mem = SolutionMemory(max_entries=16)
        tag = opts_tag(_Opts)
        mem.store("s1", _lp(seed=0), tag, np.ones(6), np.ones(4), 1.0)
        other = SolutionMemory(max_entries=16)
        other.import_entries(mem.export_entries())
        # a NEARBY (not byte-exact) instance must come back cold: a
        # near-grade seed from imported foreign data would shift the
        # re-solve's iterate path and break byte-identical failover
        entry, kind = other.lookup("s1", _lp(seed=1), tag)
        assert entry is None and kind is None
        # the donor itself WOULD near-seed it (its own entries are
        # fully indexed)
        _, kind_donor = mem.lookup("s1", _lp(seed=1), tag)
        assert kind_donor == "near"

    def test_import_skips_existing_and_malformed(self):
        from dervet_tpu_torch.ops.warmstart import opts_tag
        mem = SolutionMemory(max_entries=16)
        tag = opts_tag(_Opts)
        mem.store("s1", _lp(), tag, np.ones(6), np.ones(4), 1.0)
        payload = mem.export_entries()
        assert mem.import_entries(payload) == 0       # already present
        assert SolutionMemory(max_entries=16).import_entries(
            [("garbage", {"nope": 1})] + payload) == 1

    def test_eviction_unlinks_imported(self):
        from dervet_tpu_torch.ops.warmstart import opts_tag
        mem = SolutionMemory(max_entries=16)
        tag = opts_tag(_Opts)
        mem.store("s1", _lp(), tag, np.ones(6), np.ones(4), 1.0)
        tiny = SolutionMemory(max_entries=1)
        tiny.import_entries(mem.export_entries())
        assert tiny.snapshot()["imported_live"] == 1
        tiny.store("s2", _lp(seed=3), tag, np.ones(6), np.ones(4), 2.0)
        assert tiny.snapshot()["imported_live"] == 0   # evicted cleanly


# ---------------------------------------------------------------------------
# replica_crash / replica_hang fault kinds
# ---------------------------------------------------------------------------

class TestReplicaFaults:
    def test_env_knobs_parse_and_one_shot(self, monkeypatch):
        monkeypatch.setenv("DERVET_TPU_FAULT_REPLICA_CRASH", "3")
        monkeypatch.setenv("DERVET_TPU_FAULT_REPLICA_HANG", "2")
        monkeypatch.setenv("DERVET_TPU_FAULT_REPLICA_HANG_S", "0.01")
        plan = faultinject.get_plan()
        assert plan.replica_crash_after == 3
        assert plan.replica_hang_after == 2
        assert not plan.replica_crash_due(2)
        assert plan.replica_crash_due(3)
        assert not plan.replica_crash_due(4)          # one-shot
        assert plan.replica_hang_seconds_due(1) == 0.0
        assert plan.replica_hang_seconds_due(2) == 0.01
        assert plan.replica_hang_seconds_due(5) == 0.0  # one-shot
        # env-plan memo: the same plan object (with its latches) comes
        # back on the next hook call
        assert faultinject.get_plan() is plan
        assert [e for e, _ in plan.fired] == ["replica_crash",
                                              "replica_hang"]

    def test_hang_hook_sleeps(self):
        with faultinject.inject(replica_hang_after=1,
                                replica_hang_seconds=0.05):
            t0 = time.monotonic()
            assert faultinject.maybe_replica_hang(0) == 0.0
            assert faultinject.maybe_replica_hang(1) == 0.05
            assert time.monotonic() - t0 >= 0.05
        assert faultinject.maybe_replica_hang(9) == 0.0   # plan closed


# ---------------------------------------------------------------------------
# Journal: racing recoveries stay idempotent (the satellite drill)
# ---------------------------------------------------------------------------

class TestJournalRecoveryRace:
    def _spool(self, tmp_path):
        incoming = tmp_path / "incoming"
        done = tmp_path / "done"
        failed = tmp_path / "failed"
        for d in (incoming, done, failed):
            d.mkdir()
        return incoming, done, failed

    def test_concurrent_recover_spool_idempotent(self, tmp_path):
        """Router failover firing while the replica restarts: both replay
        the same journal concurrently.  The interrupted result move must
        finish exactly once and no request may be re-served twice."""
        incoming, done, failed = self._spool(tmp_path)
        jpath = tmp_path / "service_journal.jsonl"
        seed = ServiceJournal(jpath)
        # killed between journaling 'completed' and moving the file:
        seed.admitted("rid-done", "rid-done.pkl")
        seed.completed("rid-done")
        (incoming / "rid-done.pkl").write_bytes(b"payload")
        # killed mid-flight (admitted, no terminal): must be re-served
        seed.admitted("rid-open", "rid-open.pkl")
        (incoming / "rid-open.pkl").write_bytes(b"payload")
        seed.close()

        journals = [ServiceJournal(jpath) for _ in range(2)]
        outcomes = [None, None]
        barrier = threading.Barrier(2)

        def recover(i):
            barrier.wait()
            outcomes[i] = journals[i].recover_spool(incoming, done,
                                                    failed)

        threads = [threading.Thread(target=recover, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for j in journals:
            j.close()
        assert all(o is not None for o in outcomes), "a recovery crashed"
        # the interrupted move finished exactly once
        assert (done / "rid-done.pkl").exists()
        assert not (incoming / "rid-done.pkl").exists()
        assert sum("rid-done" in o["moved"] for o in outcomes) == 1
        # the in-flight request is re-servable (file untouched), and
        # both recoveries agree on that — re-serving is idempotent by
        # the atomic-rewrite contract, never a double answer
        assert (incoming / "rid-open.pkl").exists()
        assert all("rid-open" in o["reserve"] for o in outcomes)
        # a third recovery after the dust settles is a no-op move-wise
        j3 = ServiceJournal(jpath)
        assert j3.recover_spool(incoming, done, failed)["moved"] == []
        j3.close()

    def test_cancelled_state_removal_replayed(self, tmp_path):
        incoming, done, failed = self._spool(tmp_path)
        j = ServiceJournal(tmp_path / "service_journal.jsonl")
        j.admitted("hedge-loser", "hedge-loser.pkl")
        j.note("cancelled", "hedge-loser", file="hedge-loser.pkl")
        (incoming / "hedge-loser.pkl").write_bytes(b"payload")
        out = j.recover_spool(incoming, done, failed)
        j.close()
        # the kill landed between journaling the cancel and unlinking:
        # recovery finishes the removal instead of re-serving the loser
        assert not (incoming / "hedge-loser.pkl").exists()
        assert "hedge-loser" not in out["reserve"]

    def test_note_events_and_replay_path(self, tmp_path):
        jpath = tmp_path / "j.jsonl"
        j = ServiceJournal(jpath)
        j.note("routed", "r1", replica="a")
        j.note("rerouted", "r1", to="b")
        j.completed("r1")
        j.close()
        states = ServiceJournal.replay_path(jpath)
        assert states["r1"]["state"] == "completed"
        lines = [json.loads(ln) for ln in
                 jpath.read_text().splitlines()]
        assert [ln["event"] for ln in lines] == ["routed", "rerouted",
                                                 "completed"]
        assert lines[1]["to"] == "b"


# ---------------------------------------------------------------------------
# Router logic against stub replicas
# ---------------------------------------------------------------------------

class StubReplica(ReplicaHandle):
    """Scripted replica: answers/heartbeats under test control."""

    def __init__(self, name, reject_with=None):
        super().__init__(name)
        self.reqs = {}
        self.answers = {}
        self.beating = True
        self.reject_with = reject_with      # raise on submit when set
        self.reject_count = 0
        self.cancelled = []
        self.retracted = []
        self.probes = []
        self.imported = []
        self.export = None

    def submit(self, cases, rid, *, priority=0, deadline_epoch=None,
               payload=None, trace_ctx=None):
        if self.reject_with is not None:
            self.reject_count += 1
            raise QueueFullError("stub full",
                                 retry_after_s=self.reject_with)
        self.reqs[rid] = cases

    def poll(self, rid):
        return self.answers.get(rid)

    def heartbeat(self):
        if not self.beating:
            return None
        hb = {"t": time.time(), "name": self.name}
        if self.probes:
            hb["probe_nonce"] = self.probes[-1]
        return hb

    def probe(self, nonce, trace=None):
        self.probes.append(nonce)

    def cancel(self, rid):
        self.cancelled.append(rid)

    def retract(self, rid):
        self.retracted.append(rid)
        self.reqs.pop(rid, None)

    def read_memory_export(self):
        return self.export

    def import_memory(self, blob):
        self.imported.append(blob)


def _router(reps, **kw):
    kw.setdefault("heartbeat_timeout_s", 0.4)
    kw.setdefault("tick_s", 0.02)
    kw.setdefault("startup_grace_s", 5.0)
    return FleetRouter(reps, **kw).start()


def _wait(pred, timeout=10.0, msg="condition not reached"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(msg)


CASES = None


def _stub_cases():
    # one shared case dict: fingerprinting only reads it, and building
    # synthetic frames per test is the slow part
    global CASES
    if CASES is None:
        CASES = _cases()
    return CASES


class TestRouterRouting:
    def test_affinity_sticks_and_counts(self):
        a, b = StubReplica("a"), StubReplica("b")
        r = _router([a, b])
        try:
            r.submit(_stub_cases(), request_id="x1")
            first = "a" if "x1" in a.reqs else "b"
            r.submit(_stub_cases(), request_id="x2")
            # same structure fingerprint -> same replica, even though
            # the other one is now less loaded
            assert ("x2" in (a if first == "a" else b).reqs)
            m = r.metrics()["routing"]
            assert m["affinity_hits"] == 1
            assert m["affinity_misses"] == 1
        finally:
            r.close(terminate_replicas=False)

    def test_least_loaded_fallback_when_affinity_full(self):
        a, b = StubReplica("a"), StubReplica("b")
        r = _router([a, b], max_inflight_per_replica=1)
        try:
            r.submit(_stub_cases(), request_id="x1")
            loaded = a if "x1" in a.reqs else b
            other = b if loaded is a else a
            # affinity replica at its inflight bound -> least-loaded
            r.submit(_stub_cases(), request_id="x2")
            assert "x2" in other.reqs
        finally:
            r.close(terminate_replicas=False)

    def test_queue_full_redirects_to_next_replica(self):
        a = StubReplica("a", reject_with=3.0)
        b = StubReplica("b")
        r = _router([a, b])
        try:
            r.submit(_stub_cases(), request_id="x1")
            assert "x1" in b.reqs
            assert r.metrics()["routing"]["redirects"] >= 1
        finally:
            r.close(terminate_replicas=False)

    def test_all_full_propagates_min_retry_hint(self):
        a = StubReplica("a", reject_with=7.0)
        b = StubReplica("b", reject_with=3.0)
        r = _router([a, b])
        try:
            with pytest.raises(FleetUnavailableError) as ei:
                r.submit(_stub_cases(), request_id="x1")
            # the hint survives the routing hop: the SMALLEST per-
            # replica drain-rate hint, and the typed error is still a
            # QueueFullError so client backoff discipline applies
            assert ei.value.retry_after_s == 3.0
            assert isinstance(ei.value, QueueFullError)
        finally:
            r.close(terminate_replicas=False)

    def test_client_retry_discipline_through_router(self):
        a = StubReplica("a", reject_with=0.02)
        b = StubReplica("b", reject_with=0.02)
        r = _router([a, b])
        try:
            client = ScenarioClient(r, max_retries=8, jitter_seed=7)

            def release():
                time.sleep(0.03)
                a.reject_with = None

            threading.Thread(target=release).start()
            fut = client.submit(_stub_cases(), request_id="x1")
            assert "x1" in a.reqs and fut is not None
            # and the backoff the client slept was the router's hint,
            # capped + jittered within +/-25%
            hint = 0.02
            w = ScenarioClient(r, jitter_seed=7)._backoff_s(hint)
            assert 0.75 * hint <= w <= 1.25 * hint
            # seeded determinism
            assert w == ScenarioClient(r, jitter_seed=7)._backoff_s(hint)
        finally:
            r.close(terminate_replicas=False)

    def test_rid_reuse_rejected(self):
        a = StubReplica("a")
        r = _router([a])
        try:
            r.submit(_stub_cases(), request_id="x1")
            a.answers["x1"] = ("done", object())
            with pytest.raises(ValueError, match="already routed"):
                r.submit(_stub_cases(), request_id="x1")
        finally:
            r.close(terminate_replicas=False)

    def test_no_healthy_replica_is_typed(self):
        a = StubReplica("a")
        a.state = "dead"
        a.beating = False       # a beating "dead" replica resurrects
        r = _router([a])
        try:
            with pytest.raises(FleetUnavailableError):
                r.submit(_stub_cases(), request_id="x1")
        finally:
            r.close(terminate_replicas=False)


class TestRouterFailover:
    def test_heartbeat_death_reroutes_exactly_once(self):
        a, b = StubReplica("a"), StubReplica("b")
        r = _router([a, b])
        try:
            fut = r.submit(_stub_cases(), request_id="x1")
            victim = a if "x1" in a.reqs else b
            other = b if victim is a else a
            victim.export = b"fake-memory-blob"
            victim.beating = False
            _wait(lambda: "x1" in other.reqs, msg="not rerouted")
            # fencing + memory handoff happened
            assert "x1" in victim.retracted
            assert other.imported == [b"fake-memory-blob"]
            other.answers["x1"] = ("done", object())
            res = fut.result(timeout=5)
            assert res.recovered and res.replica == other.name
            m = r.metrics()
            assert m["routing"]["failovers"] == 1
            assert m["routing"]["rerouted"] == 1
            assert m["routing"]["memory_handoffs"] == 1
            assert m["replicas"][victim.name]["state"] == "dead"
            assert m["replicas"][victim.name]["breaker"]["state"] == \
                "open"
            assert m["failover_latency_s"]["n"] == 1
        finally:
            r.close(terminate_replicas=False)

    def test_dead_replicas_completed_answer_is_harvested(self):
        """Kill between answering and the router noticing: the journal/
        spool already holds the result — harvest it, never re-solve."""
        a, b = StubReplica("a"), StubReplica("b")
        r = _router([a, b])
        try:
            fut = r.submit(_stub_cases(), request_id="x1")
            victim = a if "x1" in a.reqs else b
            answer = object()
            victim.answers["x1"] = ("done", answer)
            victim.beating = False
            res = fut.result(timeout=5)
            assert res.result is answer
            m = r.metrics()["routing"]
            # harvested (if death won the race) or plainly completed (if
            # the poller read the answer first) — never both, never zero
            assert m["completed"] == 1
            assert m["rerouted"] == 0
        finally:
            r.close(terminate_replicas=False)

    def test_watchdog_reroutes_wedged_request(self):
        a, b = StubReplica("a"), StubReplica("b")
        r = _router([a, b], request_timeout_s=0.2)
        try:
            fut = r.submit(_stub_cases(), request_id="x1")
            primary = a if "x1" in a.reqs else b
            other = b if primary is a else a
            # primary heartbeats happily but never answers: only the
            # per-request watchdog can see this
            _wait(lambda: "x1" in other.reqs, msg="watchdog never fired")
            assert primary.beating
            other.answers["x1"] = ("done", object())
            res = fut.result(timeout=5)
            assert res.replica == other.name
            m = r.metrics()
            assert m["routing"]["watchdog_reroutes"] == 1
            # the wedged replica took a breaker failure sample
            assert m["replicas"][primary.name]["breaker"]["samples"] >= 1
        finally:
            r.close(terminate_replicas=False)

    def test_late_duplicate_suppressed_first_answer_wins(self):
        a, b = StubReplica("a"), StubReplica("b")
        r = _router([a, b], request_timeout_s=0.2)
        try:
            fut = r.submit(_stub_cases(), request_id="x1")
            primary = a if "x1" in a.reqs else b
            other = b if primary is a else a
            _wait(lambda: "x1" in other.reqs, msg="watchdog never fired")
            first = object()
            other.answers["x1"] = ("done", first)
            res = fut.result(timeout=5)
            assert res.result is first
            # the wedged primary finally answers: suppressed, counted
            primary.answers["x1"] = ("done", object())
            _wait(lambda: r.metrics()["routing"][
                "duplicates_suppressed"] == 1,
                msg="late duplicate not counted")
            assert fut.result(timeout=0).result is first
        finally:
            r.close(terminate_replicas=False)

    def test_probe_closes_breaker_after_flap(self):
        a, b = StubReplica("a"), StubReplica("b")
        r = _router([a, b], request_timeout_s=0.1,
                    breaker_opts={"min_samples": 1,
                                  "failure_threshold": 0.5,
                                  "cooldown_s": 0.2})
        try:
            fut = r.submit(_stub_cases(), request_id="x1")
            primary = a if "x1" in a.reqs else b
            other = b if primary is a else a
            _wait(lambda: "x1" in other.reqs, msg="watchdog never fired")
            other.answers["x1"] = ("done", object())
            fut.result(timeout=5)
            # the flapping replica's breaker opened on the watchdog
            # failure; it keeps heartbeating, so after the cooldown the
            # router probes it (nonce echo, no solve) and closes
            br = r.breakers.get(primary.name)
            _wait(lambda: br.state == CircuitBreaker.CLOSED,
                  msg="probe never closed the breaker")
            assert primary.probes, "no probe nonce was sent"
            assert r.metrics()["routing"]["probes_ok"] >= 1
        finally:
            r.close(terminate_replicas=False)


class EpochStubReplica(StubReplica):
    """Stub whose heartbeats carry a controllable incarnation epoch —
    the handle's `epoch` is what it was spawned with, `hb_epoch` is
    what its beats claim (split so tests can play a zombie process
    beating with a fenced epoch, then a replacement beating above it)."""

    def __init__(self, name, epoch=None):
        super().__init__(name)
        self.epoch = epoch
        self.hb_epoch = epoch

    def heartbeat(self):
        hb = super().heartbeat()
        if hb is not None and self.hb_epoch is not None:
            hb["epoch"] = self.hb_epoch
        return hb


class TestEpochFence:
    """The satellite drill: `_declare_dead` re-route racing a
    concurrent same-named respawn.  The heartbeat-epoch fence must
    reject the stale incarnation's late beats and answers while the
    replacement (strictly higher epoch) earns routing back — exactly
    one answer ever reaches the caller."""

    def test_zombie_beats_at_fence_epoch_never_resurrect(self):
        a = EpochStubReplica("a", epoch=1)
        b = EpochStubReplica("b", epoch=1)
        r = _router([a, b])
        try:
            fut = r.submit(_stub_cases(), request_id="x1")
            victim = a if "x1" in a.reqs else b
            other = b if victim is a else a
            victim.beating = False
            _wait(lambda: "x1" in other.reqs, msg="not rerouted")
            assert victim.state == "dead"
            # declare-dead armed the fence at the corpse's incarnation
            assert victim.fence_epoch == 1
            # the zombie wakes up and resumes beating with its OWN
            # (fenced) epoch: the beats are discredited wholesale — no
            # liveness credit, no resurrection, routing stays closed
            victim.beating = True
            time.sleep(0.2)
            assert victim.state == "dead"
            assert r._hb_cache[victim.name] is None
            # its late answer is inert (the route was resolved at
            # failover) — only the re-routed sibling delivers
            victim.answers["x1"] = ("done", object())
            real = object()
            other.answers["x1"] = ("done", real)
            res = fut.result(timeout=5)
            assert res.result is real and res.replica == other.name
            m = r.metrics()["routing"]
            assert m["rerouted"] == 1
            # a replacement incarnation beating ABOVE the fence is the
            # only thing that resurrects the name — and it disarms it
            victim.hb_epoch = 2
            _wait(lambda: victim.state == "up",
                  msg="replacement epoch never resurrected the name")
            assert victim.fence_epoch is None
        finally:
            r.close(terminate_replicas=False)

    def test_respawn_race_no_double_delivery(self):
        """Replacement handle adopted DURING the failover window, same
        name, epoch bumped past the fence: the stale process's answer
        can never be delivered and the caller sees exactly one result."""
        a = EpochStubReplica("a", epoch=1)
        b = EpochStubReplica("b", epoch=1)
        r = _router([a, b])
        try:
            fut = r.submit(_stub_cases(), request_id="x1")
            victim = a if "x1" in a.reqs else b
            other = b if victim is a else a
            victim.beating = False
            _wait(lambda: "x1" in other.reqs, msg="not rerouted")
            # supervisor respawn lands mid-flight: same name, epoch+1
            repl = EpochStubReplica(victim.name, epoch=2)
            r.adopt_replica(repl)
            assert r.replicas[victim.name] is repl
            # replacement re-proves liveness from scratch (fresh grace)
            assert r._first_seen[victim.name] is None
            # the zombie answers late through its orphaned handle: it
            # is no longer registered or polled — no double delivery
            victim.beating = True
            victim.answers["x1"] = ("done", object())
            real = object()
            other.answers["x1"] = ("done", real)
            res = fut.result(timeout=5)
            assert res.result is real and res.replica == other.name
            m = r.metrics()["routing"]
            assert m["rerouted"] == 1
            assert m["duplicates_suppressed"] == 0
            # the replacement's own fresh beats earn it back into the
            # routable set
            _wait(lambda: r._first_seen[repl.name] is not None,
                  msg="replacement's beats never credited")
            assert r.replicas[repl.name].state == "up"
        finally:
            r.close(terminate_replicas=False)

    def test_spool_epoch_filter_discredits_stale_beats(self, tmp_path):
        """SpoolReplica path: a heartbeat.json written by an older
        incarnation over the shared spool (epoch below the handle's) is
        discredited entirely; the matching epoch restores credit."""
        from dervet_tpu_torch.service.fleet import HEARTBEAT_FILE, SpoolReplica
        spool = tmp_path / "r0"
        h = SpoolReplica("r0", spool)
        h.epoch = 2
        r = _router([h])
        try:
            def beat(epoch):
                tmp = spool / f".{HEARTBEAT_FILE}.tmp"
                tmp.write_text(json.dumps(
                    {"t": time.time(), "name": "r0", "epoch": epoch}))
                tmp.replace(spool / HEARTBEAT_FILE)

            beat(1)                 # the fenced predecessor's late write
            time.sleep(0.2)
            assert r._hb_cache["r0"] is None
            assert r._first_seen["r0"] is None
            beat(2)                 # the real incarnation announces
            _wait(lambda: r._first_seen["r0"] is not None,
                  msg="current-epoch beat never credited")
            assert r._hb_cache["r0"]["epoch"] == 2
        finally:
            r.close(terminate_replicas=False)


class TestRouterHedging:
    def test_deadline_pressure_hedges_first_answer_wins(self):
        a, b = StubReplica("a"), StubReplica("b")
        r = _router([a, b], hedge_min_wait_s=0.1, hedge_wait_frac=0.01)
        try:
            fut = r.submit(_stub_cases(), request_id="x1",
                           deadline_s=30.0)
            primary = a if "x1" in a.reqs else b
            other = b if primary is a else a
            _wait(lambda: "x1" in other.reqs, msg="hedge never fired")
            m = r.metrics()["routing"]
            assert m["hedged"] == 1
            # hedge answers first -> it wins, the loser gets a cancel
            other.answers["x1"] = ("done", object())
            res = fut.result(timeout=5)
            assert res.hedged and res.replica == other.name
            _wait(lambda: "x1" in primary.cancelled,
                  msg="loser never cancelled")
            assert r.metrics()["routing"]["hedge_wins"] == 1
            # loser answers anyway at its round boundary: suppressed
            primary.answers["x1"] = ("done", object())
            _wait(lambda: r.metrics()["routing"][
                "duplicates_suppressed"] == 1,
                msg="hedge loser's answer not suppressed")
        finally:
            r.close(terminate_replicas=False)

    def test_no_hedge_without_deadline(self):
        a, b = StubReplica("a"), StubReplica("b")
        r = _router([a, b], hedge_min_wait_s=0.05, hedge_wait_frac=0.01)
        try:
            r.submit(_stub_cases(), request_id="x1")
            time.sleep(0.3)
            assert r.metrics()["routing"]["hedged"] == 0
            assert len(a.reqs) + len(b.reqs) == 1
        finally:
            r.close(terminate_replicas=False)


# ---------------------------------------------------------------------------
# Local-replica (real ScenarioService) end-to-end
# ---------------------------------------------------------------------------

class TestLocalFleet:
    def _fleet(self, n=2, **router_kw):
        services = [ScenarioService(backend="cpu", max_wait_s=0.0)
                    for _ in range(n)]
        for s in services:
            s.start()
        reps = [LocalReplica(f"n{i}", s)
                for i, s in enumerate(services)]
        router = _router(reps, heartbeat_timeout_s=1.0, **router_kw)
        return router, reps, services

    def test_routed_solve_end_to_end(self):
        router, reps, services = self._fleet()
        try:
            fut = router.submit(_cases(), request_id="e1")
            res = fut.result(timeout=300)
            assert res.result is not None
            cert = res.load_run_health()["certification"]
            assert cert["enabled"] and cert["windows_certified"] > 0
            assert res.latency_s > 0
        finally:
            router.close(terminate_replicas=False)
            for s in services:
                s.close()

    def test_kill_mid_flight_recovers_on_sibling(self):
        router, reps, services = self._fleet()
        try:
            fut = router.submit(_cases(), request_id="e1")
            victim = next(rep for rep in reps if "e1" in rep._futures)
            # the service keeps solving (a hung-not-dead replica), but
            # its heartbeats stop: the router must not wait for it
            victim.kill()
            res = fut.result(timeout=300)
            assert res.result is not None
            m = router.metrics()["routing"]
            assert m["completed"] == 1
            # either the sibling solved it (reroute) or the victim's
            # answer landed before death was declared (harvest-or-
            # normal) — exactly one delivery either way
            assert m["failovers"] >= 1
        finally:
            router.close(terminate_replicas=False)
            for s in services:
                s.close()

    def test_overload_redirect_with_real_services(self):
        router, reps, services = self._fleet()
        try:
            # the first admission is rejected by the overload fault
            # (queue-full shape, real drain-rate hint); the router
            # redirects to the sibling and the request still completes
            with faultinject.inject(overload=True, overload_n=1):
                fut = router.submit(_cases(), request_id="e1")
            res = fut.result(timeout=300)
            assert res.result is not None
            assert router.metrics()["routing"]["redirects"] == 1
        finally:
            router.close(terminate_replicas=False)
            for s in services:
                s.close()


# ---------------------------------------------------------------------------
# Subprocess spool replicas: the replica_crash fault drill
# ---------------------------------------------------------------------------

class TestSpoolFleet:
    def test_replica_crash_failover_exactly_once(self, tmp_path):
        """A real serve process hard-exits (os._exit — the SIGKILL
        analogue) right after journaling its first admission.  The
        router must detect the death, replay the journal, re-route the
        orphaned request to the healthy replica, and deliver exactly
        one certified answer."""
        from dervet_tpu_torch.service import spawn_replica
        logs = [open(tmp_path / f"r{i}.log", "w") for i in range(2)]
        victim = spawn_replica(
            tmp_path / "victim", name="victim", backend="cpu", device="cpu",
            stdout=logs[0], stderr=logs[0],
            env={"DERVET_TPU_FAULT_REPLICA_CRASH": "1"})
        healthy = spawn_replica(
            tmp_path / "healthy", name="healthy", backend="cpu", device="cpu",
            stdout=logs[1], stderr=logs[1])
        router = FleetRouter(
            [victim, healthy], fleet_dir=tmp_path / "fleet",
            heartbeat_timeout_s=3.0, tick_s=0.05,
            # force the primary route onto the crashing replica
            max_inflight_per_replica=32).start()
        try:
            # two DISTINCT structures so affinity cannot pile both onto
            # one replica: least-loaded puts c0 on 'healthy' (name
            # order), c1 on 'victim' — whose first admission crashes it
            futs = {
                "c0": router.submit(_cases(), request_id="c0",
                                    deadline_s=300.0),
                "c1": router.submit(_cases(window=96, variant=1),
                                    request_id="c1", deadline_s=300.0),
            }
            results = {rid: fut.result(timeout=280)
                       for rid, fut in futs.items()}
            m = router.metrics()
            r = m["routing"]
            assert r["completed"] == 2 and r["failed"] == 0
            assert r["failovers"] == 1, r
            assert r["harvested"] + r["rerouted"] >= 1, r
            assert m["replicas"]["victim"]["state"] == "dead"
            assert m["replicas"]["victim"]["breaker"]["state"] == "open"
            recovered = [rid for rid, res in results.items()
                         if res.recovered]
            assert recovered, "crash produced no recovered request"
            for rid, res in results.items():
                cert = res.load_run_health()["certification"]
                assert cert["enabled"]
                assert cert["windows"]["rejected_final"] == 0
            # the victim's journal shows the orphaned admission the
            # failover recovered
            states = ServiceJournal.replay_path(
                tmp_path / "victim" / "service_journal.jsonl")
            assert any(e["state"] == "admitted"
                       for e in states.values())
            # failover-drill trace contract: the harvested/re-routed
            # request yields ONE stitched trace (router slice + both
            # replicas' exports merge under the router root) carrying
            # the fence event plus harvest or re-route on the timeline
            from dervet_tpu_torch.telemetry import trace as ttrace
            from dervet_tpu_torch.telemetry.ops import load_stitched_trace
            rid = recovered[0]
            spans = load_stitched_trace(rid, [tmp_path])
            report = ttrace.validate_trace(spans)
            assert report["n_spans"] >= 3, spans
            assert report["root"]["name"] == "fleet_request"
            events = [e["name"] for s in spans
                      for e in s.get("events") or ()]
            assert "fence" in events, events
            assert "harvest" in events or "reroute" in events, events
            # the un-recovered request's trace must NOT carry failover
            # events — fencing is attributed per request, not fleet-wide
            other = next(r for r in results if r != rid)
            other_events = [
                e["name"] for s in load_stitched_trace(other, [tmp_path])
                for e in s.get("events") or ()]
            assert "reroute" not in other_events, other_events
        finally:
            router.close()
            for lg in logs:
                lg.close()


# ---------------------------------------------------------------------------
# Lifecycle supervisor (the JAX package's tests/test_fleet_lifecycle.py)
# ---------------------------------------------------------------------------

class FakeReplica(ReplicaHandle):
    """Controllable replica: beats/liveness/load under test control."""

    def __init__(self, name, epoch=None):
        super().__init__(name)
        self.epoch = epoch
        self.beating = True
        self.alive_flag = True
        self.queue_depth = 0.0
        self.imported = []
        self.terminated = False

    def submit(self, cases, rid, **kw):
        pass

    def poll(self, rid):
        return None

    def heartbeat(self):
        if not self.beating:
            return None
        return {"t": time.time(), "name": self.name,
                **({"epoch": self.epoch} if self.epoch is not None
                   else {})}

    def alive(self):
        return self.alive_flag

    def published_load(self):
        return {"queue_depth": float(self.queue_depth),
                "drain_rate_rps": 1.0, "pending": 0.0}

    def import_memory(self, blob):
        self.imported.append(blob)

    def terminate(self, timeout=30.0):
        self.terminated = True
        self.alive_flag = False
        self.beating = False

    def die(self):
        self.beating = False
        self.alive_flag = False


class SpawnLog:
    """Injectable spawn_fn: records every call, returns FakeReplicas."""

    def __init__(self):
        self.calls = []
        self.spawned = []

    def __call__(self, spool, *, name=None, epoch=None, **kw):
        self.calls.append({"spool": spool, "name": name, "epoch": epoch,
                           **kw})
        fake = FakeReplica(name, epoch=epoch)
        self.spawned.append(fake)
        return fake


def _lc_wait(pred, timeout=10.0, msg="condition not reached"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(msg)


def _spec(spool):
    return ReplicaSpec(spool, device="cpu")


def _lc_router(tmp_path, **kw):
    kw.setdefault("heartbeat_timeout_s", 0.4)
    kw.setdefault("tick_s", 0.02)
    kw.setdefault("startup_grace_s", 5.0)
    kw.setdefault("fleet_dir", tmp_path / "fleet")
    return FleetRouter([], **kw).start()


def _supervisor(router, specs, spawn, **kw):
    kw.setdefault("backoff_base_s", 0.05)
    kw.setdefault("backoff_max_s", 0.5)
    kw.setdefault("tick_s", 0.03)
    return FleetSupervisor(router, specs, spawn_fn=spawn, **kw)


class TestKillSwitch:
    def test_disabled_supervisor_is_a_complete_noop(self, tmp_path,
                                                    monkeypatch):
        monkeypatch.setenv("DERVET_TPU_FLEET_SUPERVISE", "0")
        assert not supervision_enabled()
        r = _lc_router(tmp_path)
        spawn = SpawnLog()
        sup = _supervisor(r, [_spec(tmp_path / "r0")], spawn)
        try:
            sup.start()
            # nothing attached, nothing spawned, no thread, no state
            assert r.supervisor is None
            assert spawn.calls == []
            assert sup._thread is None
            sup.on_replica_dead("r0", "crash")       # also a no-op
            time.sleep(0.1)
            assert spawn.calls == []
            assert not (tmp_path / "fleet" /
                        "supervisor_state.json").exists()
        finally:
            sup.stop()
            r.close(terminate_replicas=False)


class TestRespawn:
    def test_crash_respawns_with_epoch_bump_and_warm_import(
            self, tmp_path):
        spool = tmp_path / "r0"
        spool.mkdir()
        # the dead incarnation's last published warm-start export
        (spool / MEMORY_EXPORT_FILE).write_bytes(b"WARM-BLOB")
        r = _lc_router(tmp_path)
        spawn = SpawnLog()
        sup = _supervisor(r, [_spec(spool)], spawn,
                          rapid_crash_window_s=0.0)   # never quarantine
        try:
            sup.start()
            assert r.supervisor is sup
            _lc_wait(lambda: "r0" in r.replicas, msg="initial spawn")
            assert spawn.calls[0]["epoch"] == 1
            first = spawn.spawned[0]
            # cold start: no warm import on the initial spawn
            assert first.imported == []
            _lc_wait(lambda: sup.snapshot()["replicas"]["r0"]["state"]
                  == UP, msg="never reached UP")

            first.die()
            _lc_wait(lambda: len(spawn.spawned) >= 2, msg="no respawn")
            second = spawn.spawned[1]
            assert spawn.calls[1]["epoch"] == 2       # fence bump
            _lc_wait(lambda: r.replicas.get("r0") is second,
                  msg="router never adopted the replacement")
            # warm respawn: the dead spool's export rode along
            _lc_wait(lambda: second.imported == [b"WARM-BLOB"],
                  msg="no warm import")
            assert second.restarts == 1
            assert second.last_restart_reason == "process exited"
            snap = sup.snapshot()
            assert snap["counters"]["restarts"] == 1
            assert snap["counters"]["warm_imports"] == 1
            assert snap["replicas"]["r0"]["epoch"] == 2
            assert snap["replicas"]["r0"]["last_restart_reason"] \
                == "process exited"
        finally:
            sup.stop()
            r.close(terminate_replicas=False)

    def test_backoff_grows_exponentially(self, tmp_path):
        r = _lc_router(tmp_path)
        spawn = SpawnLog()
        sup = _supervisor(r, [_spec(tmp_path / "r0")], spawn,
                          backoff_base_s=0.1, backoff_max_s=10.0,
                          rapid_crash_window_s=100.0,
                          quarantine_after=10)
        try:
            sup.start()
            _lc_wait(lambda: len(spawn.spawned) == 1, msg="initial spawn")
            _lc_wait(lambda: sup.snapshot()["replicas"]["r0"]["state"]
                  == UP, msg="never up")
            rec = sup._records["r0"]
            t0 = time.monotonic()
            sup.on_replica_dead("r0", "crash #1")
            assert rec.state == BACKOFF
            d1 = rec.backoff_until - t0
            # simulate the respawned incarnation crashing again, fast
            rec.state = UP
            rec.last_spawn_mono = time.monotonic()
            t1 = time.monotonic()
            sup.on_replica_dead("r0", "crash #2")
            d2 = rec.backoff_until - t1
            assert d2 > d1 * 1.5        # base * 2^k doubling
        finally:
            sup.stop()
            r.close(terminate_replicas=False)


class TestQuarantine:
    def test_rapid_crashes_reach_typed_quarantine(self, tmp_path):
        r = _lc_router(tmp_path)
        spawn = SpawnLog()
        sup = _supervisor(r, [_spec(tmp_path / "r0")], spawn,
                          rapid_crash_window_s=60.0, quarantine_after=3)
        try:
            sup.start()
            _lc_wait(lambda: len(spawn.spawned) == 1, msg="initial spawn")
            _lc_wait(lambda: sup.snapshot()["replicas"]["r0"]["state"]
                  == UP, msg="never up")
            # crash-loop: each incarnation dies as soon as it is live
            for i in range(3):
                if sup.snapshot()["replicas"]["r0"]["state"] \
                        == QUARANTINED:
                    break
                _lc_wait(lambda: spawn.spawned[-1].alive_flag,
                      msg="no live incarnation")
                n = len(spawn.spawned)
                spawn.spawned[-1].die()
                _lc_wait(lambda: (len(spawn.spawned) > n
                               or sup.snapshot()["replicas"]["r0"]
                               ["state"] == QUARANTINED),
                      msg="no respawn/quarantine after death")
            _lc_wait(lambda: sup.snapshot()["replicas"]["r0"]["state"]
                  == QUARANTINED, msg="never quarantined")
            snap = sup.snapshot()["replicas"]["r0"]
            q = snap["quarantine"]
            assert q["kind"] == "replica_quarantined"
            assert q["replica"] == "r0"
            assert q["crashes"] >= 3
            assert q["retry_hint"] is None
            n_spawns = len(spawn.spawned)
            time.sleep(0.3)
            # terminal: no hot-loop respawning out of quarantine
            assert len(spawn.spawned) == n_spawns
            # the typed error round-trips like the rest of the family
            err = ReplicaQuarantinedError("x", replica="r0", crashes=3,
                                          last_reason="boom")
            assert err.as_dict()["kind"] == "replica_quarantined"

            # operator release clears it and respawns immediately
            assert sup.release("r0")
            _lc_wait(lambda: len(spawn.spawned) > n_spawns,
                  msg="release did not respawn")
            assert sup.snapshot()["counters"]["released"] == 1
        finally:
            sup.stop()
            r.close(terminate_replicas=False)


class TestAutoscale:
    def test_scale_up_on_pressure_then_down_after_clean_drain(
            self, tmp_path):
        r = _lc_router(tmp_path)
        spawn = SpawnLog()
        sup = _supervisor(r, [_spec(tmp_path / "r0")], spawn,
                          min_replicas=1, max_replicas=2,
                          scale_up_backlog=4.0, scale_pressure_s=0.1,
                          scale_down_idle_s=0.15,
                          spool_root=tmp_path / "scaled")
        try:
            sup.start()
            _lc_wait(lambda: len(spawn.spawned) == 1, msg="initial spawn")
            base = spawn.spawned[0]
            _lc_wait(lambda: sup.snapshot()["replicas"]["r0"]["state"]
                  == UP, msg="never up")
            base.queue_depth = 50.0         # sustained backlog
            _lc_wait(lambda: len(spawn.spawned) >= 2,
                  msg="no scale-up under sustained pressure")
            scaled = spawn.spawned[1]
            assert scaled.name.startswith("scale")
            assert spawn.calls[1]["spool"] == tmp_path / "scaled" \
                / scaled.name
            _lc_wait(lambda: scaled.name in r.replicas,
                  msg="scaled replica not adopted")
            snap = sup.snapshot()
            assert snap["counters"]["scale_up"] == 1
            assert snap["replicas"][scaled.name]["scaled"] is True
            # bounded: pressure continues but max_replicas=2 holds
            time.sleep(0.3)
            assert len(spawn.spawned) == 2

            # idle fleet: the scaled replica drains CLEAN and goes away
            base.queue_depth = 0.0
            scaled.queue_depth = 0.0
            _lc_wait(lambda: sup.snapshot()["replicas"][scaled.name]
                  ["state"] == STOPPED, msg="no scale-down")
            assert scaled.terminated        # polite drain, not a kill
            assert scaled.name not in r.replicas
            assert sup.snapshot()["counters"]["scale_down"] == 1
            # the baseline replica is never scaled down
            assert "r0" in r.replicas
        finally:
            sup.stop()
            r.close(terminate_replicas=False)


class TestStateAndAdoption:
    def test_state_file_published_for_status_cli(self, tmp_path):
        r = _lc_router(tmp_path)
        spawn = SpawnLog()
        sup = _supervisor(r, [_spec(tmp_path / "r0")], spawn)
        try:
            sup.start()
            state_path = tmp_path / "fleet" / "supervisor_state.json"
            _lc_wait(lambda: state_path.exists(), msg="no state file")
            doc = json.loads(state_path.read_text())
            assert doc["enabled"] is True
            assert "r0" in doc["replicas"]
            assert doc["replicas"]["r0"]["restarts"] == 0
            # and the router's metrics() carries the same snapshot
            assert r.metrics()["supervisor"]["replicas"]["r0"]
        finally:
            sup.stop()
            r.close(terminate_replicas=False)

    def test_existing_spool_replicas_adopted_without_specs(
            self, tmp_path):
        spool = tmp_path / "r0"
        handle = SpoolReplica("r0", spool)    # caller-spawned, no proc
        handle.epoch = 4
        r = FleetRouter([handle], fleet_dir=tmp_path / "fleet",
                        heartbeat_timeout_s=0.4, tick_s=0.02).start()
        spawn = SpawnLog()
        sup = _supervisor(r, [], spawn)
        try:
            sup.start()
            snap = sup.snapshot()["replicas"]
            assert "r0" in snap
            assert snap["r0"]["epoch"] == 4
            # a crash of the adopted replica respawns at epoch 5
            sup.on_replica_dead("r0", "heartbeats stopped")
            _lc_wait(lambda: spawn.calls, msg="no respawn of adopted")
            assert spawn.calls[0]["epoch"] == 5
            assert spawn.calls[0]["spool"] == spool
        finally:
            sup.stop()
            r.close(terminate_replicas=False)


# ---------------------------------------------------------------------------
# Fleet telemetry (the fleet cases of tests/test_telemetry.py)
# ---------------------------------------------------------------------------

class TestFleetTelemetry:
    @pytest.fixture(autouse=True)
    def _clean_collector(self):
        ttrace.COLLECTOR.reset()
        yield
        ttrace.COLLECTOR.reset()

    def test_local_fleet_single_stitched_trace(self):
        from dervet_tpu_torch.service import ScenarioService
        from dervet_tpu_torch.service.fleet import LocalReplica
        from dervet_tpu_torch.service.router import FleetRouter
        svcs = [ScenarioService(backend="cpu", max_wait_s=0.0)
                for _ in range(2)]
        reps = [LocalReplica(f"lr{i}", s) for i, s in enumerate(svcs)]
        router = FleetRouter(reps, heartbeat_timeout_s=5.0,
                             tick_s=0.02).start()
        try:
            fut = router.submit(_cases(1), request_id="fl1",
                                deadline_s=300.0)
            deadline = time.monotonic() + 120
            while not fut.done() and time.monotonic() < deadline:
                for s in svcs:
                    s.run_once()
                time.sleep(0.01)
            res = fut.result(timeout=1)
            assert res.result is not None
            # ONE trace: the replica's spans parent under the router's
            # root via the transport context — single root, full chain
            spans = ttrace.COLLECTOR.spans(ttrace.trace_id_for("fl1"))
            info = ttrace.validate_trace(spans)
            assert info["root"]["name"] == "fleet_request"
            names = {s["name"] for s in spans}
            assert {"fleet_request", "transport", "request",
                    "admission", "batch_round",
                    "dispatch_group"} <= names
            root = info["root"]
            assert any(e["name"] == "routed"
                       for e in root.get("events", ()))
        finally:
            router.close()
            for s in svcs:
                s.close()

    def test_published_load_outranks_inflight(self):
        from dervet_tpu_torch.service.router import FleetRouter
        a, b = StubReplica("a"), StubReplica("b")
        router = FleetRouter([a, b], heartbeat_timeout_s=5.0,
                             tick_s=1000.0)   # no monitor interference
        # a never published -> inflight fallback tier (sorts after b)
        router._pub_load["b"] = {"queue_depth": 0.0,
                                 "drain_rate_rps": 2.0, "pending": 0.0}
        assert router._load_score("a")[0] == 1
        assert router._load_score("b")[0] == 0
        # published backlog ranks by estimated drain seconds
        router._pub_load["a"] = {"queue_depth": 8.0,
                                 "drain_rate_rps": 2.0, "pending": 0.0}
        assert router._load_score("a")[1] == pytest.approx(4.0)
        assert router._load_score("b")[1] == pytest.approx(0.0)
        fut = router.submit(_stub_cases(), request_id="lr1")
        assert "lr1" in b.reqs and "lr1" not in a.reqs
        assert not fut.done()
        router.close(terminate_replicas=False)

    def test_stale_publication_falls_back_to_inflight(self):
        from dervet_tpu_torch.service.router import FleetRouter
        a, b = StubReplica("a"), StubReplica("b")
        router = FleetRouter([a, b], heartbeat_timeout_s=5.0,
                             tick_s=1000.0)
        # a frozen exposition (dead replica, or one respawned with
        # telemetry off) must not keep ranking as idle: a stale
        # t_published demotes to the inflight fallback tier
        router._pub_load["b"] = {
            "queue_depth": 0.0, "drain_rate_rps": 2.0, "pending": 0.0,
            "t_published": time.time() - 10 * router._pub_stale_s}
        assert router._load_score("b")[0] == 1
        router._pub_load["b"]["t_published"] = time.time()
        assert router._load_score("b")[0] == 0
        # local-transport signals carry no t_published (read live) —
        # they never go stale
        router._pub_load["a"] = {"queue_depth": 1.0,
                                 "drain_rate_rps": 1.0, "pending": 0.0}
        assert router._load_score("a")[0] == 0
        router.close(terminate_replicas=False)

    def test_local_replica_publishes_live_queue(self):
        from dervet_tpu_torch.service import ScenarioService
        from dervet_tpu_torch.service.fleet import LocalReplica
        svc = ScenarioService(backend="cpu", max_wait_s=0.0)
        rep = LocalReplica("pub", svc)
        pub = rep.published_load()
        assert pub is not None and pub["queue_depth"] == 0
        rep.kill()
        assert rep.published_load() is None
        svc._fail_pending()

    def test_spool_payload_carries_trace_context(self, tmp_path):
        import pickle
        from dervet_tpu_torch.service.fleet import SpoolReplica
        ctx = {"trace_id": "t" * 32, "span_id": "s1"}
        blob = SpoolReplica.encode_payload(
            {"0": None}, priority=1, deadline_epoch=None, trace=ctx)
        assert pickle.loads(blob)["trace"] == ctx
        # probe file carries the context too (heartbeat echo path)
        rep = SpoolReplica("r", tmp_path)
        rep.probe("n1", trace=ctx)
        doc = json.loads((tmp_path / "probe.json").read_text())
        assert doc["nonce"] == "n1" and doc["trace"] == ctx


# ---------------------------------------------------------------------------
# Spawned port replicas: ``python -m dervet_tpu_torch serve --device cpu``
# ---------------------------------------------------------------------------

def _csv_bytes(d):
    from pathlib import Path
    return {p.name: p.read_bytes() for p in sorted(Path(d).rglob("*.csv"))}


def _spawn(tmp_path, name, logs, **kw):
    from dervet_tpu_torch.service import spawn_replica
    log = open(tmp_path / f"{name}.log", "w")
    logs.append(log)
    return spawn_replica(tmp_path / name, name=name, backend="torch",
                         device="cpu", stdout=log, stderr=log, **kw)


def _solo_csvs(cases, rid, out):
    """The same request answered by one in-process service on the CPU
    device: the single-replica run a fleet answer must equal."""
    svc = ScenarioService(backend="torch", device="cpu", max_wait_s=0.0)
    try:
        fut = svc.submit(cases, request_id=rid)
        svc.run_once()
        fut.result(timeout=1).save_as_csv(out)
    finally:
        svc.close()
    return _csv_bytes(out)


def test_replica_command_is_the_port(monkeypatch, tmp_path):
    """The child of ``spawn_replica`` is this package's ``serve`` on the
    device asked for, never the JAX package and never a jax preamble;
    the default replica runs the torch backend on ``cuda:0``."""
    import os
    import subprocess

    from dervet_tpu_torch.service import spawn_replica
    seen = {}

    class _Popen:
        def __init__(self, args, **kw):
            seen["args"], seen["env"] = args, kw["env"]

    monkeypatch.setattr(subprocess, "Popen", _Popen)
    spawn_replica(tmp_path / "r0", device="cpu")
    args = seen["args"]
    assert args[1:4] == ["-m", "dervet_tpu_torch", "serve"]
    assert args[args.index("--backend") + 1] == "torch"
    assert args[args.index("--device") + 1] == "cpu"
    assert not any("jax" in str(a) for a in args)
    # the child's environment is the caller's: nothing pins a jax platform
    assert seen["env"].get("JAX_PLATFORMS") == \
        os.environ.get("JAX_PLATFORMS")
    spec = ReplicaSpec("spool")
    assert (spec.backend, spec.device) == ("torch", "cuda:0")


def test_spawned_replicas_affinity_cache_and_delta(tmp_path):
    """Two port replicas on the CPU device: two structures go to
    different replicas and a same-structure request follows its
    structure; an exact repeat is answered from the request cache with
    byte-identical artifacts; a delta that edits one month re-solves only
    that window."""
    logs = []
    reps = [_spawn(tmp_path, f"r{i}", logs) for i in range(2)]
    assert all("dervet_tpu_torch" in r.process.args
               and not any("jax" in str(a) for a in r.process.args)
               for r in reps)
    router = FleetRouter(reps, fleet_dir=tmp_path / "fleet",
                         heartbeat_timeout_s=60.0, tick_s=0.05).start()
    try:
        monthly, weekly = _cases(months=2), _cases(window=168)
        a = router.submit(monthly, request_id="m0", deadline_s=300.0)
        b = router.submit(weekly, request_id="w0", deadline_s=300.0)
        ra, rb = a.result(timeout=280), b.result(timeout=280)
        assert {ra.replica, rb.replica} == {"r0", "r1"}
        near = router.submit(_cases(months=2, variant=3),
                             request_id="m1", deadline_s=300.0)
        assert near.result(timeout=280).replica == ra.replica
        rep = router.submit(_cases(months=2), request_id="m2",
                            deadline_s=300.0).result(timeout=280)
        assert rep.cached and rep.replica == "request_cache"
        assert _csv_bytes(rep.results_dir) == _csv_bytes(ra.results_dir)
        edited = _cases(months=2)
        ts = edited[0].datasets.time_series
        feb = ts.index.month == 2
        ts.loc[feb, ts.columns[0]] = ts.loc[feb, ts.columns[0]] * 1.01
        d = router.submit_delta(_cases(months=2), edited,
                                request_id="d0", deadline_s=300.0)
        rd = d.result(timeout=280)
        assert rd.replica == ra.replica and not rd.cached
        led = json.loads((rd.results_dir / "solve_ledger.d0.json")
                         .read_text())
        warm = [g["warm"] for g in led["groups"]]
        # January unchanged: substituted exactly; February re-solved
        assert sum(w["substituted"] for w in warm) == 1, warm
        assert led["totals"]["windows"] == 2
        m = router.metrics()["routing"]
        assert m["request_cache_hits"] == 1 and m["delta_requests"] == 1
        assert m["failed"] == 0
    finally:
        router.close()
        for lg in logs:
            lg.close()


def _admitted_in(tmp_path, names, rid):
    for n in names:
        states = ServiceJournal.replay_path(
            tmp_path / n / "service_journal.jsonl")
        if rid in states:
            return n
    return None


def test_lost_backend_exit_failover_respawn_and_sigkill(tmp_path):
    """The drill of a lost backend, then a SIGKILL, on one supervised
    fleet of two port replicas:

    * ``r0`` runs a ``device_loss`` plan longer than its re-init budget:
      its round's request fails with ``BackendLostError``, the serve
      loop exits ``EXIT_BACKEND_LOST`` with the request still admitted
      (no failed/ marker), the router re-routes it and ``r1`` answers it
      exactly once;
    * the supervisor respawns ``r0`` unarmed at the next epoch
      (``restarts`` 1) and the new incarnation serves;
    * a replica SIGKILLed mid-round: its request is answered once, by
      the sibling, byte-identical to a single-replica run."""
    from dervet_tpu_torch.service.server import EXIT_BACKEND_LOST
    logs = []
    names = ("r0", "r1")
    victim = _spawn(tmp_path, "r0", logs, epoch=1, env={
        "DERVET_TPU_FAULT_DEVICE_LOSS": "1",
        "DERVET_TPU_FAULT_DEVICE_LOSS_N": "3"})
    healthy = _spawn(tmp_path, "r1", logs, epoch=1)
    router = FleetRouter([victim, healthy], fleet_dir=tmp_path / "fleet",
                         heartbeat_timeout_s=60.0, tick_s=0.05,
                         breaker_opts={"cooldown_s": 0.5}).start()
    sup = FleetSupervisor(
        router, [ReplicaSpec(tmp_path / n, name=n, device="cpu")
                 for n in names],
        backoff_base_s=0.05, tick_s=0.05).start()
    try:
        # least-loaded in name order: c0 lands on r0, whose first solve
        # loses the backend, and c1 (another structure) on r1
        futs = {"c0": router.submit(_cases(), request_id="c0",
                                    deadline_s=300.0),
                "c1": router.submit(_cases(window=96, variant=1),
                                    request_id="c1", deadline_s=300.0)}
        res = {rid: f.result(timeout=280) for rid, f in futs.items()}
        assert victim.process.wait(timeout=60) == EXIT_BACKEND_LOST
        assert res["c0"].replica == "r1" and res["c0"].recovered
        assert not (tmp_path / "r0" / "failed" / "c0.pkl").exists()
        states = ServiceJournal.replay_path(
            tmp_path / "r0" / "service_journal.jsonl")
        assert states["c0"]["state"] == "admitted"
        for r in res.values():
            cert = r.load_run_health()["certification"]
            assert cert["windows"]["rejected_final"] == 0
        _wait(lambda: sup.snapshot()["counters"]["restarts"] == 1
              and router.metrics()["replicas"]["r0"]["breaker"][
                  "state"] == "closed"
              and router.load_snapshot()["r0"]["published"] is not None,
              timeout=120, msg="r0 never respawned into routing")
        snap = sup.snapshot()
        assert snap["counters"]["quarantined"] == 0
        assert snap["replicas"]["r0"]["epoch"] == 2
        # a new structure: least-loaded in name order -> the respawn
        again = router.submit(_cases(window=48, variant=2),
                              request_id="c2", deadline_s=300.0)
        assert again.result(timeout=280).replica == "r0"
        # SIGKILL mid-round: the request is journaled admitted, then the
        # process dies; its structure (124-hour windows, no remainder) is
        # new to both replicas, so a cold solve anywhere is the answer
        cases = _cases(n=3, window=124, months=2, variant=5)
        fut = router.submit(cases, request_id="k0", deadline_s=300.0)
        _wait(lambda: _admitted_in(tmp_path, names, "k0") is not None,
              timeout=60, msg="k0 never admitted")
        target = _admitted_in(tmp_path, names, "k0")
        router.replicas[target].process.kill()
        rk = fut.result(timeout=280)
        assert rk.recovered and rk.replica != target
        assert _csv_bytes(rk.results_dir) == _solo_csvs(
            cases, "k0", tmp_path / "solo")
        m = router.metrics()["routing"]
        assert m["completed"] == 4 and m["failed"] == 0, m
        assert m["failovers"] >= 2, m
    finally:
        sup.stop()
        router.close()
        for lg in logs:
            lg.close()


def test_sticky_device_loss_plan(monkeypatch):
    """``DERVET_TPU_FAULT_DEVICE_LOSS=sticky`` arms the device-loss fault
    in its sticky mode; off the card it raises the typed loss (a real
    device-side assert needs a CUDA device), and the provoking gather is
    a no-op on a CPU device."""
    from dervet_tpu_torch.utils.errors import DeviceLossError
    monkeypatch.setenv("DERVET_TPU_FAULT_DEVICE_LOSS", "sticky")
    plan = faultinject.get_plan()
    assert plan.device_loss and plan.device_loss_sticky
    faultinject.provoke_device_assert("cpu")
    with pytest.raises(DeviceLossError):
        faultinject.maybe_device_loss("cpu")
    faultinject.maybe_device_loss("cpu")          # one loss, then healed
    monkeypatch.setenv("DERVET_TPU_FAULT_DEVICE_LOSS", "1")
    assert not faultinject.get_plan().device_loss_sticky
