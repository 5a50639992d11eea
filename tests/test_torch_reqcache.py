"""The port's request-level memoization (``dervet_tpu_torch.service.
reqcache``) on the CPU.

* The JAX package's cases (``tests/test_reqcache.py``: key safety, the
  certificate store guard, collisions, warm-memory invalidation,
  per-window delta digests, the router's hit / dedup / kill-switch
  paths, a LocalReplica end to end) run here against the port's
  classes, the same bodies with the package swapped; their own file
  runs them against the JAX package.
* Over both packages: a warm-start entry a certificate rejects
  (``SolutionMemory.invalidate``, the certifier's call) clears every
  live ``RequestResultCache`` of the process — the port's copy of the
  warm-start memory lost that call once — and the key carries each
  package's own ``SOLVER_VERSION``.
"""
import copy
import json
import pickle
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import dervet_tpu.ops.warmstart as jax_warmstart
import dervet_tpu.service.reqcache as jax_reqcache
import dervet_tpu_torch.ops.warmstart as warmstart
from dervet_tpu_torch.benchlib import synthetic_sensitivity_cases
from dervet_tpu_torch.ops.lp import LP
from dervet_tpu_torch.ops.warmstart import SolutionMemory, opts_tag
from dervet_tpu_torch.service import (FleetRouter, LocalReplica,
                                      ScenarioService)
from dervet_tpu_torch.service import reqcache
from dervet_tpu_torch.service.fleet import ReplicaHandle


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


CASES = None


def _shared_cases():
    global CASES
    if CASES is None:
        CASES = _cases()
    return CASES


def _wait(pred, timeout=10.0, msg="condition not reached"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.01)
    raise AssertionError(msg)


# ---------------------------------------------------------------------------
# Key material
# ---------------------------------------------------------------------------

def _clean_health(**over):
    h = {"windows": {"clean": 4, "inaccurate": 0, "retried": 0,
                     "cpu_fallback": 0, "quarantined": 0, "skipped": 0},
         "cases_quarantined": [],
         "certification": {"enabled": True, "windows_certified": 4,
                           "windows": {"certified": 4,
                                       "certified_loose": 0,
                                       "rejected": 0,
                                       "rejected_then_recovered": 0,
                                       "rejected_final": 0}},
         "invariant_audit": {"ok": True, "cases_audited": 1,
                             "failing": []}}
    h.update(over)
    return h


class TestKeyMaterial:
    def test_tolerance_tag_changes_key(self):
        cases = _shared_cases()
        a = reqcache.key_material(cases, tolerance_tag="default")
        b = reqcache.key_material(cases, tolerance_tag="loose-1e-2")
        assert reqcache.material_key(a) != reqcache.material_key(b)

    def test_solver_version_changes_key(self):
        cases = _shared_cases()
        a = reqcache.key_material(cases)
        b = reqcache.key_material(cases, solver_version="pdhg-99.0")
        assert a["solver_version"] != "unknown"
        assert reqcache.material_key(a) != reqcache.material_key(b)

    def test_content_changes_data_not_structure(self):
        # same LP structure, different battery rating: the affinity
        # fingerprint matches but the content digest must not
        a = reqcache.key_material(_cases(variant=0))
        b = reqcache.key_material(_cases(variant=7))
        assert a["structure"] == b["structure"]
        assert a["data"] != b["data"]
        assert reqcache.material_key(a) != reqcache.material_key(b)

    def test_precomputed_digest_matches_inline(self):
        cases = _shared_cases()
        digest = reqcache.request_content_digest(cases)
        assert reqcache.key_material(cases) == \
            reqcache.key_material(cases, content_digest=digest)


# ---------------------------------------------------------------------------
# The store guard
# ---------------------------------------------------------------------------

class TestCacheable:
    def test_certified_clean_ok(self):
        ok, why = reqcache.cacheable(_clean_health(), "certified")
        assert ok, why

    def test_degraded_fidelity_refused(self):
        assert not reqcache.cacheable(_clean_health(), "degraded")[0]

    def test_missing_run_health_refused(self):
        assert not reqcache.cacheable(None, "certified")[0]

    def test_quarantined_case_refused(self):
        h = _clean_health(cases_quarantined=["3"])
        assert not reqcache.cacheable(h, "certified")[0]

    def test_rejected_final_refused(self):
        h = _clean_health()
        h["certification"]["windows"]["rejected_final"] = 1
        assert not reqcache.cacheable(h, "certified")[0]

    def test_rejected_then_recovered_still_cacheable(self):
        # a rejection the escalation ladder RECOVERED ends certified —
        # refusing it would starve the cache for no trust gain
        h = _clean_health()
        h["certification"]["windows"]["rejected"] = 1
        h["certification"]["windows"]["rejected_then_recovered"] = 1
        assert reqcache.cacheable(h, "certified")[0]

    def test_failed_invariant_audit_refused(self):
        h = _clean_health()
        h["invariant_audit"] = {"ok": False, "failing": ["0"]}
        assert not reqcache.cacheable(h, "certified")[0]


# ---------------------------------------------------------------------------
# The on-disk LRU cache
# ---------------------------------------------------------------------------

class _Answer:
    """Minimal picklable stand-in for an in-process Result."""

    def __init__(self, tag="a", run_health=None, fidelity="certified"):
        self.tag = tag
        self.run_health = (_clean_health() if run_health is None
                           else run_health)
        self.fidelity = fidelity

    def __eq__(self, other):
        return isinstance(other, _Answer) and other.tag == self.tag


class TestResultCache:
    def _material(self, salt="x"):
        return {"structure": "s" * 16, "data": f"d-{salt}",
                "tolerance": "default", "cert_policy": "{}",
                "solver_version": "pdhg-test"}

    def test_store_and_hit_roundtrip(self, tmp_path):
        cache = reqcache.RequestResultCache(tmp_path / "rc")
        m = self._material()
        assert cache.store("k1", m, rid="r1", result=_Answer("one"),
                           run_health=_clean_health(),
                           fidelity="certified")
        hit = cache.lookup("k1", m)
        assert hit is not None and hit.rid == "r1"
        assert hit.result == _Answer("one")
        assert cache.snapshot()["hits"] == 1

    def test_collision_never_serves_wrong_answer(self, tmp_path):
        # same 256-bit key, DIFFERENT material (the forced-collision
        # drill): the full material compare must miss, not serve
        cache = reqcache.RequestResultCache(tmp_path / "rc")
        cache.store("k1", self._material("x"), rid="r1",
                    result=_Answer("one"), run_health=_clean_health(),
                    fidelity="certified")
        assert cache.lookup("k1", self._material("y")) is None
        snap = cache.snapshot()
        assert snap["collisions"] == 1 and snap["hits"] == 0

    def test_refused_store_leaves_zero_disk_state(self, tmp_path):
        root = tmp_path / "rc"
        cache = reqcache.RequestResultCache(root)
        h = _clean_health()
        h["certification"]["windows"]["rejected_final"] = 2
        assert not cache.store("k1", self._material(), rid="r1",
                               result=_Answer(), run_health=h,
                               fidelity="certified")
        assert not root.exists()        # lazy mkdir never ran
        assert cache.snapshot()["refused"] == 1

    def test_lru_eviction_removes_disk_entry(self, tmp_path):
        root = tmp_path / "rc"
        cache = reqcache.RequestResultCache(root, max_entries=2)
        for i in range(3):
            cache.store(f"k{i}", self._material(str(i)), rid=f"r{i}",
                        result=_Answer(str(i)),
                        run_health=_clean_health(),
                        fidelity="certified")
        assert len(cache) == 2
        assert cache.lookup("k0", self._material("0")) is None
        assert not (root / "k0").exists()
        assert (root / "k2" / reqcache.ENTRY_FILE).exists()

    def test_adopts_prior_entries_from_disk(self, tmp_path):
        root = tmp_path / "rc"
        m = self._material()
        reqcache.RequestResultCache(root).store(
            "k1", m, rid="r1", result=_Answer("one"),
            run_health=_clean_health(), fidelity="certified")
        reborn = reqcache.RequestResultCache(root)
        hit = reborn.lookup("k1", m)
        assert hit is not None and hit.result == _Answer("one")

    def test_memory_invalidation_clears_live_caches(self, tmp_path):
        # the trust chain: a certificate rejection invalidating a
        # warm-memory entry must clear every live request cache
        cache = reqcache.open_cache(tmp_path / "rc")
        m = self._material()
        cache.store("k1", m, rid="r1", result=_Answer(),
                    run_health=_clean_health(), fidelity="certified")
        assert cache.lookup("k1", m) is not None

        class _Opts:
            eps_abs = 1e-4
            eps_rel = 1e-4
            max_iters = 1000
            inaccurate_factor = 10.0
            dtype = np.float32

        rng = np.random.default_rng(0)
        lp = LP(c=rng.normal(size=6),
                K=sp.csr_matrix(rng.normal(size=(4, 6))),
                q=rng.normal(size=4), n_eq=2, l=np.full(6, -10.0),
                u=np.full(6, 10.0), var_refs={}, row_groups={})
        mem = SolutionMemory(max_entries=16)
        tag = opts_tag(_Opts)
        mem.store("s1", lp, tag, np.ones(lp.n), np.ones(lp.m), 1.0)
        assert mem.invalidate("s1", lp) == 1
        assert len(cache) == 0
        assert cache.lookup("k1", m) is None
        assert cache.snapshot()["invalidations"] == 1


# ---------------------------------------------------------------------------
# Per-window delta digests
# ---------------------------------------------------------------------------

class TestDeltaDigests:
    def test_identical_requests_zero_changed(self):
        base = _cases(window=24)
        diff = reqcache.diff_request(base, copy.deepcopy(base))
        assert diff is not None
        assert diff["windows_changed"] == 0
        assert diff["windows_total"] > 5

    def test_single_window_edit_isolated(self):
        base = _cases(window=24)
        edited = copy.deepcopy(base)
        ts = edited[0].datasets.time_series
        # poke one load value inside the SECOND 24h window only
        col = [c for c in ts.columns if "load" in str(c).lower()][0]
        ts.iloc[30, ts.columns.get_loc(col)] += 1.0
        diff = reqcache.diff_request(base, edited)
        assert diff is not None
        assert diff["windows_changed"] == 1
        per = diff["per_case"]["0"]
        assert per["changed"] == [1]
        assert per["total"] == diff["windows_total"]

    def test_non_timeseries_edit_not_comparable(self):
        # a rating change touches every window's LP: the diff must
        # refuse to claim window-locality (None -> all changed)
        base = _cases(window=24)
        edited = _cases(window=24, variant=3)
        assert reqcache.diff_case(base[0], edited[0]) is None
        assert reqcache.diff_request(base, edited) is None


# ---------------------------------------------------------------------------
# Router-level admission: hit / dedup / kill switch
# ---------------------------------------------------------------------------

class StubReplica(ReplicaHandle):
    """Scripted replica: answers under test control."""

    def __init__(self, name):
        super().__init__(name)
        self.reqs = {}
        self.answers = {}

    def submit(self, cases, rid, *, priority=0, deadline_epoch=None,
               payload=None, trace_ctx=None, extra=None):
        self.reqs[rid] = cases

    def poll(self, rid):
        return self.answers.get(rid)

    def heartbeat(self):
        return {"t": time.time(), "name": self.name}


def _router(reps, tmp_path, **kw):
    kw.setdefault("heartbeat_timeout_s", 2.0)
    kw.setdefault("tick_s", 0.02)
    kw.setdefault("startup_grace_s", 5.0)
    kw.setdefault("fleet_dir", tmp_path / "fleet")
    return FleetRouter(reps, **kw).start()


class TestRouterMemoization:
    def test_hit_serves_with_zero_replica_dispatch(self, tmp_path):
        rep = StubReplica("a")
        r = _router([rep], tmp_path)
        try:
            fut = r.submit(_shared_cases(), request_id="m1")
            rep.answers["m1"] = ("done", _Answer("solved"))
            assert fut.result(timeout=10).result == _Answer("solved")
            _wait(lambda: r.metrics()["request_cache"]["stores"] == 1,
                  msg="answer never stored")
            res = r.submit(_shared_cases(),
                           request_id="m2").result(timeout=10)
            assert res.cached and res.replica == "request_cache"
            assert res.result == _Answer("solved")
            assert "m2" not in rep.reqs       # zero replica dispatches
            c = r.metrics()["routing"]
            assert c["request_cache_hits"] == 1
            assert c["completed"] == 2
            # both rids journaled to completion (exactly-once surface)
            events = [json.loads(ln) for ln in
                      (tmp_path / "fleet" /
                       "fleet_journal.jsonl").read_text().splitlines()]
            done = {e["rid"] for e in events
                    if e["event"] == "completed"}
            assert {"m1", "m2"} <= done
        finally:
            r.close(terminate_replicas=False)

    def test_uncacheable_answer_misses_next_time(self, tmp_path):
        rep = StubReplica("a")
        r = _router([rep], tmp_path)
        try:
            fut = r.submit(_shared_cases(), request_id="u1")
            h = _clean_health()
            h["certification"]["windows"]["rejected_final"] = 1
            rep.answers["u1"] = ("done", _Answer("bad", run_health=h))
            fut.result(timeout=10)
            _wait(lambda: r.metrics()["request_cache"]["refused"] == 1,
                  msg="store was not refused")
            fut2 = r.submit(_shared_cases(), request_id="u2")
            assert "u2" in rep.reqs           # re-dispatched, no hit
            rep.answers["u2"] = ("done", _Answer("bad2", run_health=h))
            assert not fut2.result(timeout=10).cached
        finally:
            r.close(terminate_replicas=False)

    def test_co_pending_identical_requests_coalesce(self, tmp_path):
        rep = StubReplica("a")
        r = _router([rep], tmp_path)
        try:
            f1 = r.submit(_shared_cases(), request_id="d1")
            f2 = r.submit(_shared_cases(), request_id="d2")
            f3 = r.submit(_shared_cases(), request_id="d3")
            # ONE solve for three identical co-pending requests
            assert set(rep.reqs) == {"d1"}
            rep.answers["d1"] = ("done", _Answer("once"))
            r1, r2, r3 = (f.result(timeout=10) for f in (f1, f2, f3))
            assert r1.result == r2.result == r3.result
            assert not r1.coalesced and r2.coalesced and r3.coalesced
            assert r2.rid == "d2" and r3.rid == "d3"
            c = r.metrics()["routing"]
            assert c["duplicates_coalesced"] == 2
            assert c["completed"] == 3
            events = [json.loads(ln) for ln in
                      (tmp_path / "fleet" /
                       "fleet_journal.jsonl").read_text().splitlines()]
            assert {e["rid"] for e in events
                    if e["event"] == "completed"} == {"d1", "d2", "d3"}
            assert {e["rid"] for e in events
                    if e["event"] == "coalesced"} == {"d2", "d3"}
        finally:
            r.close(terminate_replicas=False)

    def test_follower_rid_is_once_only(self, tmp_path):
        rep = StubReplica("a")
        r = _router([rep], tmp_path)
        try:
            r.submit(_shared_cases(), request_id="d1")
            r.submit(_shared_cases(), request_id="d2")
            with pytest.raises(ValueError, match="once-only"):
                r.submit(_shared_cases(), request_id="d2")
        finally:
            r.close(terminate_replicas=False)

    def test_kill_switch_restores_plain_path(self, tmp_path,
                                             monkeypatch):
        monkeypatch.setenv(reqcache.ENV, "0")
        rep = StubReplica("a")
        r = _router([rep], tmp_path)
        try:
            f1 = r.submit(_shared_cases(), request_id="k1")
            rep.answers["k1"] = ("done", _Answer("one"))
            f1.result(timeout=10)
            f2 = r.submit(_shared_cases(), request_id="k2")
            assert "k2" in rep.reqs           # no hit, no dedup
            rep.answers["k2"] = ("done", _Answer("two"))
            assert not f2.result(timeout=10).cached
            c = r.metrics()["routing"]
            assert c["request_cache_hits"] == 0
            assert c["request_cache_misses"] == 0
            # zero cache files OR dirs on disk
            assert not (tmp_path / "fleet" / "result_cache").exists()
        finally:
            r.close(terminate_replicas=False)

    def test_delta_submit_annotates_and_counts(self, tmp_path):
        rep = StubReplica("a")
        r = _router([rep], tmp_path)
        try:
            base = _cases(window=24)
            edited = copy.deepcopy(base)
            ts = edited[0].datasets.time_series
            col = [c for c in ts.columns
                   if "load" in str(c).lower()][0]
            ts.iloc[30, ts.columns.get_loc(col)] += 1.0
            fut = r.submit_delta(base, edited, request_id="dl1")
            assert "dl1" in rep.reqs
            rep.answers["dl1"] = ("done", _Answer("delta"))
            fut.result(timeout=10)
            assert r.metrics()["routing"]["delta_requests"] == 1
            events = [json.loads(ln) for ln in
                      (tmp_path / "fleet" /
                       "fleet_journal.jsonl").read_text().splitlines()]
            note = [e for e in events if e["event"] == "delta"]
            assert note and note[0]["windows_changed"] == 1
            assert note[0]["windows_total"] > 5
        finally:
            r.close(terminate_replicas=False)


# ---------------------------------------------------------------------------
# Client serialize-once (the queue-full retry re-pickling fix)
# ---------------------------------------------------------------------------

class TestClientSerializeOnce:
    def test_blob_and_digest_computed_once_across_retries(
            self, monkeypatch):
        from concurrent.futures import Future
        from dervet_tpu_torch.service import ScenarioClient
        from dervet_tpu_torch.service.queue import QueueFullError
        digests = []
        real = reqcache.request_content_digest
        monkeypatch.setattr(
            reqcache, "request_content_digest",
            lambda cases: digests.append(1) or real(cases))
        submits = []

        class _Svc:
            rejects = 2

            def submit(self, cases, *, request_id=None, priority=0,
                       deadline_s=None, cases_blob=None,
                       content_digest=None):
                submits.append((cases_blob, content_digest))
                if _Svc.rejects:
                    _Svc.rejects -= 1
                    raise QueueFullError("full", retry_after_s=0.0)
                f = Future()
                f.set_result("ok")
                return f

        client = ScenarioClient(_Svc(), max_retries=5, jitter_seed=1)
        assert client.submit(_shared_cases(),
                             request_id="c1").result() == "ok"
        assert len(submits) == 3
        # pickled ONCE before the retry loop: every attempt carries the
        # same bytes object and the digest was computed exactly once
        assert len(digests) == 1
        assert len({id(b) for b, _ in submits}) == 1
        assert all(isinstance(b, bytes) and d for b, d in submits)


# ---------------------------------------------------------------------------
# Real end-to-end: repeat request, byte-identical artifacts, no dispatch
# ---------------------------------------------------------------------------

class TestEndToEndCachedSolve:
    def test_repeat_request_byte_identical_zero_dispatch(self, tmp_path):
        service = ScenarioService(backend="cpu", max_wait_s=0.0)
        service.start()
        rep = LocalReplica("n0", service)
        r = _router([rep], tmp_path, heartbeat_timeout_s=5.0)
        try:
            res1 = r.submit(_cases(), request_id="e1").result(timeout=300)
            assert res1.result is not None and not res1.cached
            res2 = r.submit(_cases(), request_id="e2").result(timeout=300)
            assert res2.cached and res2.replica == "request_cache"
            assert "e2" not in rep._futures   # replica never touched
            d1, d2 = tmp_path / "out1", tmp_path / "out2"
            res1.result.save_as_csv(d1)
            res2.result.save_as_csv(d2)
            s1 = {p.name: p.read_bytes() for p in sorted(d1.glob("*.csv"))}
            s2 = {p.name: p.read_bytes() for p in sorted(d2.glob("*.csv"))}
            assert s1 and s1 == s2            # byte-identical artifacts
            # hit-path latency is microseconds-to-milliseconds, never a
            # solve: three orders of magnitude under the cold solve
            assert res2.latency_s < max(0.5, 0.05 * res1.latency_s)
        finally:
            r.close(terminate_replicas=False)
            service.close()



# ---------------------------------------------------------------------------
# Both packages: the certifier's invalidation reaches every live cache
# ---------------------------------------------------------------------------

PKGS = {"jax": (jax_reqcache, jax_warmstart),
        "torch": (reqcache, warmstart)}


class _LPOpts:
    eps_abs = 1e-4
    eps_rel = 1e-4
    max_iters = 1000
    inaccurate_factor = 10.0
    dtype = np.float32


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_certificate_rejection_clears_every_live_cache(pkg, tmp_path):
    rc, ws = PKGS[pkg]
    caches = [rc.open_cache(tmp_path / f"rc{i}") for i in range(2)]
    m = {"structure": "s", "data": "d", "tolerance": "default",
         "cert_policy": "p", "solver_version": "v"}
    for c in caches:
        c.store("k1", m, rid="r1", result={"answer": 1},
                run_health=_clean_health(), fidelity="certified")
        assert c.lookup("k1", m) is not None
    rng = np.random.default_rng(1)
    lp = LP(c=rng.normal(size=6), K=sp.csr_matrix(rng.normal(size=(4, 6))),
            q=rng.normal(size=4), n_eq=2, l=np.full(6, -10.0),
            u=np.full(6, 10.0), var_refs={}, row_groups={})
    if pkg == "jax":
        from dervet_tpu.ops.lp import LP as JaxLP
        lp = JaxLP(c=lp.c, K=lp.K, q=lp.q, n_eq=lp.n_eq, l=lp.l, u=lp.u,
                   var_refs={}, row_groups={})
    mem = ws.SolutionMemory(max_entries=16)
    mem.store("s1", lp, ws.opts_tag(_LPOpts), np.ones(lp.n),
              np.ones(lp.m), 1.0)
    assert mem.invalidate("s1", lp) == 1
    for c in caches:
        assert len(c) == 0 and c.lookup("k1", m) is None
        assert c.snapshot()["invalidations"] == 1


def test_key_carries_the_ports_solver_version():
    from dervet_tpu_torch.ops.pdhg import SOLVER_VERSION
    assert reqcache.current_solver_version() == str(SOLVER_VERSION)
    assert reqcache.key_material(_shared_cases())["solver_version"] == \
        str(SOLVER_VERSION)
