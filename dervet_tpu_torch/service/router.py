"""FleetRouter: multi-replica serving with exactly-once failover.

The router fronts N :class:`~dervet_tpu_torch.service.fleet.ReplicaHandle`
replicas (separate ``python -m dervet_tpu_torch serve`` processes over
file spools, or in-process services) and owns three jobs:

* **Routing** — requests go to the replica whose solver cache
  and warm-start memory are already hot for their shape:
  :func:`~dervet_tpu_torch.service.fleet.structure_fingerprint` keys a sticky
  affinity map, falling back to the least-loaded healthy replica.  A
  replica whose circuit breaker (``utils/breaker.py``) is open is
  skipped; queue-full rejections redirect to the next replica, and when
  EVERY replica rejects, the typed
  :class:`~dervet_tpu_torch.utils.errors.FleetUnavailableError` carries the
  smallest per-replica ``retry_after_s`` drain-rate hint through the
  routing hop — the hint is never dropped at the redirect.
* **Health** — every monitor tick reads each replica's heartbeat; a
  replica that misses heartbeats past ``heartbeat_timeout_s`` (or whose
  process exited) is declared dead: its breaker force-trips, admissions
  re-route, and its in-flight requests recover.  A *flapping* replica —
  alive but failing its requests — trips the same breaker through the
  sliding window; after the cooldown the router probes it with a
  heartbeat nonce (no solve) and either closes the breaker or re-opens
  it.
* **Exactly-once failover** — a dead replica's requests are reconciled
  against its own crash-safe journal + results artifacts: answers it
  journaled as completed before dying are HARVESTED (results were
  persisted before the journal record, so they exist — no re-solve);
  everything else is retracted from its spool (fencing: the process is
  SIGKILLed first so it cannot wake up and keep writing) and re-routed
  to a healthy replica, together with the dead replica's last
  warm-start memory export so already-converged windows re-solve as
  exact-match substitutions (zero device work, byte-identical bytes).
  Delivery is first-answer-wins: a late answer from a hung-but-revived
  replica or a hedge loser is counted (``duplicates_suppressed``) and
  discarded, so each request is answered exactly once — and, because
  dispatch is deterministic and imported memory serves the exact-match
  grade only, byte-identical to a single-replica run.

**Hedging** — a deadline-pressured request that has waited
``hedge_wait_frac`` of its deadline without an answer is mirrored once
onto a second replica; the first answer wins and the loser is cancelled
at a round boundary (retracted if not yet admitted, discarded if it
answers anyway).
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from pathlib import Path
from typing import Dict, List, Optional

from ..telemetry import registry as telemetry_registry
from ..telemetry import trace as telemetry_trace
from ..utils.breaker import BreakerBoard
from ..utils.errors import (FleetUnavailableError, QueueFullError,
                            ReplicaAnswerError, ServiceClosedError,
                            TellUser)
from . import reqcache
from .fleet import ReplicaHandle, SpoolReplica, structure_fingerprint
from .journal import ServiceJournal
from .server import _REQUEST_ID_RE


@dataclasses.dataclass
class RoutedResult:
    """One delivered fleet answer.  ``result`` is the in-process
    :class:`~dervet_tpu_torch.results.result.Result` for local-transport
    replicas; spool-transport answers are artifact references
    (``results_dir`` — the replica's ``results/<rid>/`` output set,
    run-health slice included)."""

    rid: str
    replica: str
    result: Optional[object] = None
    results_dir: Optional[Path] = None
    latency_s: Optional[float] = None
    recovered: bool = False      # answered by a failover re-route
    harvested: bool = False      # recovered from a dead replica's spool
    hedged: bool = False         # answered by the hedge route
    cached: bool = False         # served from the router's result cache
    coalesced: bool = False      # delivered via in-flight dedup

    def load_run_health(self) -> Optional[Dict]:
        """The request's run-health slice (spool transport reads the
        ``run_health.<rid>.json`` artifact)."""
        if self.result is not None:
            return getattr(self.result, "run_health", None)
        if self.results_dir is None:
            return None
        path = self.results_dir / f"run_health.{self.rid}.json"
        if not path.exists():
            path = self.results_dir / "run_health.json"
        if not path.exists():
            # a coalesced follower (or delta) is delivered the LEADER's
            # artifact set: its files are namespaced by the leader's
            # rid, not this one — unambiguous when the dir holds a
            # single request's artifacts
            named = sorted(self.results_dir.glob("run_health.*.json"))
            if len(named) == 1:
                path = named[0]
        try:
            return json.loads(path.read_text())
        except (OSError, ValueError):
            return None


class _Route:
    __slots__ = ("replica", "t", "kind", "resolved", "span")

    def __init__(self, replica: str, kind: str):
        self.replica = replica
        self.t = time.monotonic()
        self.kind = kind            # "primary" | "hedge" | "failover"
        self.resolved = False
        self.span = None            # telemetry transport span

    def end_span(self, outcome: Optional[str] = None,
                 error=None) -> None:
        if self.span is not None:
            if outcome is not None:
                self.span.set_attr("outcome", outcome)
            self.span.end(error=error)
            self.span = None


class _Pending:
    __slots__ = ("rid", "fp", "cases", "payload", "priority",
                 "deadline_epoch", "deadline_s", "future", "routes",
                 "t_submit", "answered", "answered_at", "recovered",
                 "unplaced_since", "span", "extra", "cache_key",
                 "cache_material", "followers", "cases_blob")

    def __init__(self, rid, fp, cases, priority, deadline_s):
        self.rid = rid
        self.fp = fp
        self.cases = cases
        self.payload: Optional[bytes] = None
        # request-kind extension riding the transport (the
        # portfolio_shard payload); also merged into spool pickles
        self.extra: Optional[Dict] = None
        # request-cache addressing (reqcache.py): set when this request
        # is a cacheable leader; followers are co-pending identical
        # requests coalesced onto this solve (delivered at _deliver)
        self.cache_key: Optional[str] = None
        self.cache_material: Optional[Dict] = None
        self.followers: List["_Pending"] = []
        # client-serialized case bytes (serialize-once: reused across
        # queue-full retries AND spool payload encoding)
        self.cases_blob: Optional[bytes] = None
        self.priority = int(priority)
        self.deadline_s = deadline_s
        self.deadline_epoch = (None if deadline_s is None
                               else time.time() + float(deadline_s))
        self.future: Future = Future()
        self.routes: List[_Route] = []
        self.t_submit = time.monotonic()
        self.answered = False
        self.answered_at: Optional[float] = None
        self.recovered = False
        self.unplaced_since: Optional[float] = None
        self.span = None            # telemetry root span (router side)

    def live_routes(self) -> List[_Route]:
        return [r for r in self.routes if not r.resolved]


class FleetRouter:
    """Router over N replicas — see the module docstring for the model.

    Thread model: ``submit`` routes inline under the router lock; one
    daemon monitor thread polls answers, watches health, fails over,
    and hedges.  All ``metrics()`` counters are lock-protected."""

    def __init__(self, replicas, *, fleet_dir=None,
                 heartbeat_timeout_s: float = 3.0,
                 startup_grace_s: float = 120.0,
                 tick_s: float = 0.05,
                 request_timeout_s: Optional[float] = None,
                 hedging: bool = True,
                 hedge_wait_frac: float = 0.5,
                 hedge_min_wait_s: float = 0.5,
                 max_inflight_per_replica: int = 32,
                 placement_patience_s: float = 60.0,
                 probe_timeout_s: Optional[float] = None,
                 breaker_opts: Optional[Dict] = None,
                 affinity_cap: int = 4096,
                 tolerance_tag: str = "default",
                 result_cache_entries: int = 256):
        handles = (replicas.values() if isinstance(replicas, dict)
                   else replicas)
        self.replicas: Dict[str, ReplicaHandle] = {
            h.name: h for h in handles}
        if len(self.replicas) < len(list(handles)):
            raise ValueError("replica names must be unique")
        self.fleet_dir = Path(fleet_dir) if fleet_dir else None
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.startup_grace_s = float(startup_grace_s)
        self.tick_s = float(tick_s)
        self.request_timeout_s = request_timeout_s
        self.hedging = bool(hedging)
        self.hedge_wait_frac = float(hedge_wait_frac)
        self.hedge_min_wait_s = float(hedge_min_wait_s)
        self.max_inflight_per_replica = int(max_inflight_per_replica)
        self.placement_patience_s = float(placement_patience_s)
        self.probe_timeout_s = (float(probe_timeout_s)
                                if probe_timeout_s is not None
                                else 2.0 * self.heartbeat_timeout_s)
        # per-replica breakers: small window + short cooldown — replica
        # failure evidence is request-level and the probe is cheap
        self.breakers = BreakerBoard(**{
            "window": 8, "min_samples": 2, "failure_threshold": 0.5,
            "cooldown_s": 5.0, **(breaker_opts or {})})
        self.journal: Optional[ServiceJournal] = None
        if self.fleet_dir is not None:
            self.fleet_dir.mkdir(parents=True, exist_ok=True)
            self.journal = ServiceJournal(
                self.fleet_dir / "fleet_journal.jsonl")
        # request-level memoization plane (reqcache.py): the cache key
        # folds in this router's tolerance tag — a deployment whose
        # replicas run non-default solver tolerances must set a
        # distinguishing tag so cross-tolerance hits are impossible.
        # Construction is file-free (lazy mkdir on first store), so the
        # DERVET_TPU_REQUEST_CACHE=0 kill switch leaves zero disk state.
        self.tolerance_tag = str(tolerance_tag)
        self.result_cache: Optional[reqcache.RequestResultCache] = None
        if self.fleet_dir is not None:
            self.result_cache = reqcache.open_cache(
                self.fleet_dir / "result_cache",
                max_entries=result_cache_entries)
        # in-flight dedup: cache key -> leader rid (the one solve N
        # identical co-pending requests coalesce onto)
        self._dedup: Dict[str, str] = {}
        # follower rid -> leader rid (rid once-only bookkeeping for
        # coalesced requests, which never enter _pending)
        self._follower_rids: Dict[str, str] = {}
        self._lock = threading.RLock()
        self._pending: Dict[str, _Pending] = {}
        # retired rids (answered) — bounded memo so a rid can neither be
        # re-used against stale spool artifacts nor double-delivered
        self._retired: "OrderedDict[str, str]" = OrderedDict()
        self._retired_cap = 65536
        self._affinity: "OrderedDict[str, str]" = OrderedDict()
        self._affinity_cap = int(affinity_cap)
        self._inflight: Dict[str, int] = {n: 0 for n in self.replicas}
        # per-replica completion timestamps: the drain-rate estimator
        # behind this router's own retry-after hints (spool transport
        # has no synchronous queue-full signal to borrow)
        self._completions: Dict[str, deque] = {
            n: deque(maxlen=32) for n in self.replicas}
        # monotonic time a FRESH beat (age within the timeout) was first
        # seen per replica: staleness can only kill a replica the router
        # has actually seen alive — a stale heartbeat.json left in a
        # REUSED spool must not get a booting replica fenced before its
        # first beat (startup grace covers that window instead)
        self._first_seen: Dict[str, Optional[float]] = {
            n: None for n in self.replicas}
        # monotonic time a non-None heartbeat was last READ, so a
        # heartbeat that vanishes (local replica killed, spool wiped) is
        # detected just like one whose timestamp goes stale
        self._last_beat: Dict[str, Optional[float]] = {
            n: None for n in self.replicas}
        # monitor-cached heartbeat per replica: the submit path's
        # _eligible() reads this instead of re-parsing heartbeat.json
        # from disk under the router lock on every submit
        self._hb_cache: Dict[str, Optional[Dict]] = {
            n: None for n in self.replicas}
        self._probes: Dict[str, Dict] = {}
        self._memory_handoffs: Dict[str, int] = {}
        # replica-PUBLISHED load signals (telemetry.prom scrape): the
        # least-loaded ranking routes on these — router-side inflight
        # counts go stale across failover — falling back to inflight
        # only for a replica that has never published
        self._pub_load: Dict[str, Optional[Dict]] = {
            n: None for n in self.replicas}
        self._scrape_last = 0.0
        # a published signal whose wall-clock publish time (exposition
        # mtime) is older than this reads as never-published: a frozen
        # telemetry.prom from a dead replica — or one respawned with
        # telemetry off — must not keep ranking it as idle
        self._pub_stale_s = max(10.0, 3.0 * self.heartbeat_timeout_s)
        # router-owned metrics registry (separate from the process
        # default: LocalReplica fleets share the process, and replica
        # metrics must not blur into the fleet view) — published to
        # fleet_dir/fleet_telemetry.prom at ~1s cadence
        self._telemetry = telemetry_registry.MetricsRegistry()
        self._telemetry_last = 0.0
        self._seq = 0
        self._t_start = time.monotonic()
        # when each replica entered THIS router's care: the startup
        # grace window is measured from here, so a replacement the
        # lifecycle supervisor adopts hours into the router's life
        # still gets its full boot grace before staleness can kill it
        self._adopted_at: Dict[str, float] = {
            n: self._t_start for n in self.replicas}
        # lifecycle supervisor hook (service/lifecycle.py): when
        # attached, _declare_dead hands it the corpse after fencing +
        # failover, and it respawns/quarantines per its policy
        self.supervisor = None
        self._counters = {
            "submitted": 0, "completed": 0, "failed": 0,
            "affinity_hits": 0, "affinity_misses": 0, "redirects": 0,
            "rejected_unavailable": 0, "failovers": 0, "harvested": 0,
            "rerouted": 0, "watchdog_reroutes": 0, "hedged": 0,
            "hedge_wins": 0, "duplicates_suppressed": 0,
            "heartbeat_deaths": 0, "probes_sent": 0, "probes_ok": 0,
            "memory_handoffs": 0, "cancels_sent": 0,
            "request_cache_hits": 0, "request_cache_misses": 0,
            "request_cache_stores": 0, "duplicates_coalesced": 0,
            "delta_requests": 0,
        }
        self._latencies = deque(maxlen=4096)
        self._failover_latencies: List[float] = []
        self._closed = False
        self._monitor: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self._monitor is None:
            self._monitor = threading.Thread(
                target=self._monitor_loop, daemon=True,
                name="dervet-fleet-monitor")
            self._monitor.start()
        return self

    def attach_supervisor(self, supervisor) -> None:
        """Register the fleet lifecycle supervisor: ``_declare_dead``
        hands it every corpse (after fencing + exactly-once failover),
        and it respawns/quarantines/autoscales per its policy."""
        self.supervisor = supervisor

    def adopt_replica(self, handle: ReplicaHandle) -> None:
        """Register a replica handle under this router — a supervisor
        respawn replacing a dead handle of the same name, or a
        scale-up adding a new one.  All per-replica routing/health
        bookkeeping is (re)initialized; health state starts clean with
        a fresh startup-grace window.  The breaker is NOT reset: a
        replacement earns routing back through the probe cycle once it
        beats with its fresh epoch."""
        with self._lock:
            name = handle.name
            replacing = name in self.replicas
            self.replicas[name] = handle
            if not replacing:
                self._inflight[name] = 0
                self._completions[name] = deque(maxlen=32)
            # a replacement must re-prove liveness from scratch: its
            # predecessor's last beat/publication is not its own
            self._first_seen[name] = None
            self._last_beat[name] = None
            self._hb_cache[name] = None
            self._pub_load[name] = None
            self._adopted_at[name] = time.monotonic()
        if self.journal is not None:
            self.journal.note("replica_adopted", name,
                              epoch=handle.epoch,
                              replaced=replacing)

    def remove_replica(self, name: str) -> bool:
        """Deregister one replica (supervisor scale-down after a clean
        drain).  Refused while the replica still has live routes —
        the caller must drain first."""
        with self._lock:
            h = self.replicas.get(name)
            if h is None:
                return False
            if any(r.replica == name for p in self._pending.values()
                   for r in p.live_routes()):
                return False
            self.replicas.pop(name, None)
            for d in (self._inflight, self._completions,
                      self._first_seen, self._last_beat, self._hb_cache,
                      self._pub_load, self._adopted_at):
                d.pop(name, None)
            self._probes.pop(name, None)
            # drop stale affinity pins so new requests re-rank instead
            # of chasing a removed name
            for fp in [fp for fp, n in self._affinity.items()
                       if n == name]:
                self._affinity.pop(fp, None)
        if self.journal is not None:
            self.journal.note("replica_removed", name)
        return True

    def load_snapshot(self) -> Dict[str, Dict]:
        """Per-replica load view for the lifecycle supervisor's
        autoscaler: the scraped self-published signal plus this
        router's own inflight count and liveness state."""
        with self._lock:
            return {name: {"state": h.state,
                           "inflight": self._inflight.get(name, 0),
                           "published": self._pub_load.get(name)}
                    for name, h in self.replicas.items()}

    def close(self, terminate_replicas: bool = True) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._monitor is not None:
            self._monitor.join(timeout=10)
            self._monitor = None
        with self._lock:
            for p in list(self._pending.values()):
                if not p.answered and not p.future.done():
                    err = ServiceClosedError(
                        f"request {p.rid!r} unanswered at fleet router "
                        "close — resubmit to a live fleet")
                    if p.span is not None:
                        telemetry_trace.release_request(p.rid)
                        p.span.end(error=err)
                        p.span = None
                    p.future.set_exception(err)
                # coalesced followers ride their leader: fail them too
                for f in p.followers:
                    if not f.future.done():
                        ferr = ServiceClosedError(
                            f"request {f.rid!r} (coalesced onto "
                            f"{p.rid!r}) unanswered at fleet router "
                            "close — resubmit to a live fleet")
                        if f.span is not None:
                            telemetry_trace.release_request(f.rid)
                            f.span.end(error=ferr)
                            f.span = None
                        f.future.set_exception(ferr)
                p.followers = []
            self._pending.clear()
            self._dedup.clear()
            self._follower_rids.clear()
        if terminate_replicas:
            for h in self.replicas.values():
                if isinstance(h, SpoolReplica) and h.process is not None:
                    h.terminate()
        # final exposition (no-op when fleet_dir is unset or the kill
        # switch is on)
        self._telemetry_last = 0.0
        self._publish_fleet_telemetry()
        if self.fleet_dir is not None:
            from ..utils.supervisor import atomic_write
            atomic_write(self.fleet_dir / "fleet_metrics.json",
                         json.dumps(self.metrics(), indent=2))
        if self.journal is not None:
            self.journal.close()

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- admission / routing --------------------------------------------
    def submit(self, cases, *, request_id=None, priority: int = 0,
               deadline_s: Optional[float] = None,
               affinity_key: Optional[str] = None,
               extra: Optional[Dict] = None,
               cases_blob: Optional[bytes] = None,
               content_digest: Optional[str] = None) -> Future:
        """Route one request; returns the future its
        :class:`RoutedResult` (or typed error) is delivered through.
        Raises :class:`FleetUnavailableError` (a ``QueueFullError``,
        ``retry_after_s`` = the smallest hint any replica offered) when
        no replica can take it right now.

        Before any replica is touched, a plain scenario request (no
        ``extra``, default affinity) consults the request-level
        memoization plane (``reqcache.py``): a content-addressed result
        cache HIT answers immediately with the cached byte-identical
        artifact set (zero replica dispatches); a MISS whose exact
        content is already being solved by a co-pending request
        coalesces onto that leader — one solve, N deliveries, each rid
        journaled and trace-exported separately.  The
        ``DERVET_TPU_REQUEST_CACHE=0`` kill switch disables the whole
        plane (bit-for-bit today's path).

        ``affinity_key`` overrides the structure-fingerprint affinity
        key (the fleet-sharded portfolio rounds key each SHARD's
        stickiness separately — one portfolio's structure-identical
        shards must spread over replicas, then stay put); ``extra``
        rides the replica transport as a request-kind extension.
        ``cases_blob`` is the caller's one-time pickle of ``cases``
        (reused for spool payload encoding instead of re-pickling) and
        ``content_digest`` its precomputed request content digest —
        both optional serialize-once fast paths for retry loops."""
        cached = follower = None
        t0 = time.monotonic()
        with self._lock:
            if self._closed:
                raise ServiceClosedError(
                    "fleet router is closed — no new admissions")
            if request_id is None:
                self._seq += 1
                request_id = f"f{self._seq:06d}"
            rid = str(request_id)
            if not _REQUEST_ID_RE.match(rid):
                raise ValueError(
                    f"request id {rid!r} must match [A-Za-z0-9._-]{{1,64}}"
                    " — it names spool payloads and result artifacts")
            if rid in self._pending or rid in self._retired \
                    or rid in self._follower_rids:
                raise ValueError(
                    f"request id {rid!r} was already routed through this "
                    "fleet — ids are once-only (they key the replicas' "
                    "duplicate-suppression journals)")
            if not isinstance(cases, dict):
                cases = dict(enumerate(cases))
            if not cases:
                raise ValueError("a request needs at least one case")
            # -- request-cache admission (plain scenario requests only:
            # shard/extra traffic and custom-affinity requests bypass)
            key = material = None
            if (extra is None and affinity_key is None
                    and self.result_cache is not None
                    and reqcache.enabled()):
                try:
                    material = reqcache.key_material(
                        cases, content_digest=content_digest,
                        tolerance_tag=self.tolerance_tag)
                    key = reqcache.material_key(material)
                except Exception as e:     # keying must never block
                    TellUser.warning(
                        f"fleet: request-cache key for {rid} failed: {e}")
                    key = material = None
            if key is not None:
                hit = self.result_cache.lookup(key, material)
                if hit is not None:
                    cached = self._admit_cached(
                        rid, priority, key, material, hit, t0)
                else:
                    self._counters["request_cache_misses"] += 1
                    leader = self._pending.get(
                        self._dedup.get(key, ""))
                    if leader is not None and not leader.answered \
                            and leader.cache_key == key:
                        follower = self._admit_follower(
                            rid, key, leader, priority, deadline_s)
            if cached is None and follower is None:
                p = _Pending(rid,
                             (str(affinity_key) if affinity_key is not None
                              else structure_fingerprint(cases)),
                             cases, priority, deadline_s)
                p.extra = extra
                p.cases_blob = cases_blob
                # telemetry root span: the trace id derives from the
                # rid, so the replica side (and a post-crash recovery)
                # agrees on it even if the in-band context is lost
                span = telemetry_trace.start_span(
                    "fleet_request",
                    trace_id=telemetry_trace.trace_id_for(rid),
                    attrs={"request_id": rid, "priority": int(priority),
                           "fingerprint": p.fp[:12]})
                if span:
                    p.span = span
                    telemetry_trace.register_request(rid, span)
                try:
                    self._route(p, kind="primary")  # raises if nowhere to go
                except Exception as e:
                    if p.span is not None:
                        telemetry_trace.release_request(rid)
                        p.span.event("rejected", error=type(e).__name__)
                        p.span.end(error=e)
                    raise
                if key is not None:
                    p.cache_key = key
                    p.cache_material = material
                    self._dedup[key] = rid
                self._pending[rid] = p
                self._counters["submitted"] += 1
        if cached is not None:
            fut = cached
            if self.journal is not None:
                self.journal.note(
                    "request_cache", rid, key=key[:16],
                    trace_id=telemetry_trace.trace_id_for(rid))
                self.journal.completed(
                    rid, trace_id=telemetry_trace.trace_id_for(rid))
            self._export_trace_best_effort(rid)
            return fut
        if follower is not None:
            fut, leader_rid = follower
            if self.journal is not None:
                self.journal.note(
                    "coalesced", rid, leader=leader_rid,
                    trace_id=telemetry_trace.trace_id_of(rid))
            return fut
        if self.journal is not None:
            self.journal.note("routed", rid,
                              replica=p.routes[-1].replica,
                              trace_id=telemetry_trace.trace_id_of(rid))
        return p.future

    def _admit_cached(self, rid: str, priority: int, key: str,
                      material: Dict, hit, t0: float) -> Future:
        """Answer one request straight from the result cache (caller
        holds the lock): no replica is touched, the artifact set is the
        stored byte-identical copy, and the rid is retired/journaled/
        trace-exported like any other delivery (exactly-once holds —
        the rid simply never reaches a spool, so ``recover_spool`` has
        nothing to reconcile)."""
        span = telemetry_trace.start_span(
            "fleet_request",
            trace_id=telemetry_trace.trace_id_for(rid),
            attrs={"request_id": rid, "priority": int(priority),
                   "fingerprint": material["structure"][:12]})
        latency = time.monotonic() - t0
        res = RoutedResult(
            rid=rid, replica="request_cache", result=hit.result,
            results_dir=hit.results_dir, latency_s=latency, cached=True)
        self._retire(rid, "request_cache")
        self._counters["submitted"] += 1
        self._counters["completed"] += 1
        self._counters["request_cache_hits"] += 1
        self._latencies.append(latency)
        if telemetry_registry.enabled():
            self._telemetry.histogram(
                "dervet_fleet_request_latency_seconds").observe(latency)
        if span:
            span.event("request_cache", key=key[:16],
                       source_rid=hit.rid)
            span.set_attrs({"replica": "request_cache",
                            "outcome": "done", "cached": True,
                            "latency_s": round(latency, 6)})
            span.end()
        fut: Future = Future()
        fut.set_result(res)
        return fut

    def _admit_follower(self, rid: str, key: str, leader: "_Pending",
                        priority: int, deadline_s) -> tuple:
        """Coalesce one request onto an identical co-pending leader
        (caller holds the lock): no route of its own — the leader's
        first delivery fans out to every follower, each journaled and
        trace-exported under its own rid.  The leader's deadline
        governs the solve; a follower's own deadline is advisory."""
        p = _Pending(rid, leader.fp, None, priority, deadline_s)
        p.cache_key = key
        span = telemetry_trace.start_span(
            "fleet_request",
            trace_id=telemetry_trace.trace_id_for(rid),
            attrs={"request_id": rid, "priority": int(priority),
                   "fingerprint": leader.fp[:12]})
        if span:
            p.span = span
            telemetry_trace.register_request(rid, span)
            span.event("coalesced", leader=leader.rid, key=key[:16])
        leader.followers.append(p)
        self._follower_rids[rid] = leader.rid
        self._counters["submitted"] += 1
        self._counters["duplicates_coalesced"] += 1
        return p.future, leader.rid

    def submit_delta(self, base_cases, edited_cases, *,
                     request_id=None, priority: int = 0,
                     deadline_s: Optional[float] = None) -> Future:
        """Submit ``edited_cases`` as a DELTA against ``base_cases``:
        per-window data digests (``reqcache.diff_request`` — labeled
        with the same ``build_optimization_levels`` the scenario
        windows with) establish exactly which optimization windows the
        edit touched, and the request is annotated with the diff
        (``delta`` journal note + span event, ``delta_requests``
        counter) before routing through :meth:`submit`.

        Device work follows the diff: structure affinity routes the
        edited request to the replica whose warm memory holds the base
        solve, where every UNCHANGED window exact-substitutes from the
        stored solution (re-verified in float64, shipped verbatim —
        zero device work, byte-identical bytes) and each CHANGED window
        re-solves seeded at the near/``dual_iterate`` grade.  The
        merged case re-runs the full invariant audit like any other
        request, and on the cpu backend the merged answer is
        byte-identical to a full cold re-solve (gated in
        tests/smoke).  An edit that changed nothing is answered
        straight from the whole-request result cache."""
        if not isinstance(base_cases, dict):
            base_cases = dict(enumerate(base_cases))
        if not isinstance(edited_cases, dict):
            edited_cases = dict(enumerate(edited_cases))
        try:
            diff = reqcache.diff_request(base_cases, edited_cases)
        except Exception:
            diff = None             # not comparable: all windows changed
        with self._lock:
            if request_id is None:
                self._seq += 1
                request_id = f"f{self._seq:06d}"
        rid = str(request_id)
        fut = self.submit(edited_cases, request_id=rid,
                          priority=priority, deadline_s=deadline_s)
        changed = None if diff is None else diff["windows_changed"]
        total = None if diff is None else diff["windows_total"]
        with self._lock:
            self._counters["delta_requests"] += 1
            p = self._pending.get(rid)
            if p is not None and p.span is not None:
                p.span.event("delta", windows_changed=changed,
                             windows_total=total,
                             comparable=diff is not None)
        if self.journal is not None:
            self.journal.note("delta", rid, windows_changed=changed,
                              windows_total=total,
                              comparable=diff is not None)
        return fut

    def submit_shards(self, shards: List[Dict], *, portfolio_id: str,
                      round_idx: int,
                      deadline_s: Optional[float] = None,
                      priority: int = 0,
                      rid_suffix: str = "") -> Dict[int, Future]:
        """Route one fleet-sharded portfolio round: each entry of
        ``shards`` (a ``portfolio_shard`` payload —
        ``dervet_tpu_torch.portfolio.shard``) becomes one replica request
        whose rid encodes the portfolio/shard/round.  Stickiness: every
        shard keys the affinity map by ``(portfolio, shard idx)``, so
        round k+1's shard i lands on the replica whose cached
        solvers and ``dual_iterate`` hint table shard i warmed in
        round k — and a failover re-route updates the same key, so
        stickiness follows the request to its new home.  Exactly-once
        delivery, SIGKILL failover, and hedging are the ordinary
        pending-request machinery; the returned futures deliver
        :class:`RoutedResult` per shard index.

        A shard payload without ``"sites"`` is a REFERENCE (rounds ≥ 1
        of the case-cache protocol: just the dual-price vector + the
        ``plan_fp`` the target replica resolves against its seeded
        cache); a tiny placeholder rides the ``cases`` slot — the
        shard extra IS the request on every transport.  ``rid_suffix``
        lets the executor's one-shot full-payload resend after a
        :class:`~dervet_tpu_torch.utils.errors.ShardCacheMissError` use a
        fresh rid (ids are once-only)."""
        futs: Dict[int, Future] = {}
        for shard in shards:
            i = int(shard.get("shard", len(futs)))
            rid = (f"{portfolio_id}.s{i:02d}.r{int(round_idx):03d}"
                   f"{rid_suffix}")
            futs[i] = self.submit(
                shard.get("sites") or {"shard_ref": shard.get("plan_fp")},
                request_id=rid, priority=priority,
                deadline_s=deadline_s,
                affinity_key=f"pfshard:{portfolio_id}:{i}",
                extra={"portfolio_shard": shard})
        return futs

    def _retry_hint(self, name: str) -> float:
        """Seconds a rejected caller should wait for ``name`` to drain:
        its current inflight divided by its observed completion rate.
        Caller holds the lock."""
        comp = self._completions[name]
        if len(comp) >= 2 and comp[-1] > comp[0]:
            rate = (len(comp) - 1) / (comp[-1] - comp[0])
            hint = (self._inflight[name] + 1) / max(rate, 1e-6)
            return float(min(600.0, max(0.05, hint)))
        return 1.0

    def _eligible(self, exclude=()) -> List[str]:
        """Routable replica names: up, not draining, breaker not open.
        Caller holds the lock."""
        out = []
        for name, h in list(self.replicas.items()):
            if name in exclude or h.state == "dead":
                continue
            # lifecycle scale-down: the supervisor marks the victim
            # draining BEFORE its process is told to drain, so no new
            # route can land in the SIGTERM window
            if getattr(h, "draining", False):
                continue
            if self.breakers.is_open(name):
                continue
            # monitor-cached beat: good enough for the draining flag,
            # and keeps disk I/O out of the locked submit path
            hb = self._hb_cache.get(name)
            if hb is not None and hb.get("draining"):
                continue
            out.append(name)
        return out

    def _route(self, p: _Pending, kind: str, exclude=()) -> Optional[str]:
        """Pick a replica for ``p`` and hand the request over.  Caller
        holds the lock.  Local-transport queue-full rejections redirect
        down the candidate list; if every candidate rejects, the typed
        error carries the smallest retry hint (primary routes raise it
        to the submitter; failover/hedge routes return None and the
        monitor retries placement)."""
        eligible = self._eligible(exclude=exclude)
        # affinity first: the replica already warm for this structure
        ordered: List[str] = []
        aff = self._affinity.get(p.fp)
        aff_available = (aff in eligible
                         and self._inflight[aff]
                         < self.max_inflight_per_replica)
        if aff_available:
            ordered.append(aff)
        # then least-loaded, ranked on the replica-PUBLISHED load signal
        # (queue depth / drain rate from the scraped telemetry
        # exposition) — router-side inflight counts go stale across
        # failover; inflight is only the fallback for a replica that has
        # never published, and the tie-break within a rank
        ordered += sorted(
            (n for n in eligible
             if n not in ordered
             and self._inflight[n] < self.max_inflight_per_replica),
            key=lambda n: (*self._load_score(n), n))
        hints = []
        for i, name in enumerate(ordered):
            h = self.replicas[name]
            try:
                h.submit(p.cases, p.rid, priority=p.priority,
                         deadline_epoch=p.deadline_epoch,
                         payload=self._payload_for(p, h),
                         trace_ctx=(p.span.ctx()
                                    if p.span is not None else None),
                         **({"extra": p.extra} if p.extra else {}))
            except QueueFullError as e:
                # the replica's own drain-rate hint: keep it, try the
                # next replica (the router redirect), surface the MIN
                hints.append(float(e.retry_after_s))
                self._counters["redirects"] += 1
                if p.span is not None:
                    p.span.event("redirect", replica=name,
                                 retry_after_s=float(e.retry_after_s))
                continue
            if kind == "primary":
                if aff_available and name == aff:
                    self._counters["affinity_hits"] += 1
                else:
                    self._counters["affinity_misses"] += 1
            self._affinity[p.fp] = name
            self._affinity.move_to_end(p.fp)
            while len(self._affinity) > self._affinity_cap:
                self._affinity.popitem(last=False)
            route = _Route(name, kind)
            if p.span is not None:
                pub = self._pub_load.get(name)
                p.span.event("routed", replica=name, kind=kind,
                             affinity=bool(aff_available and name == aff),
                             published_load=(None if pub is None else
                                             pub.get("queue_depth")))
                route.span = telemetry_trace.start_span(
                    "transport", parent=p.span,
                    attrs={"replica": name, "kind": kind})
            p.routes.append(route)
            p.unplaced_since = None
            self._inflight[name] += 1
            return name
        # nowhere to go
        if not hints and not ordered and eligible:
            # every healthy replica is at its inflight bound: this
            # router-side backpressure gets the same drain-rate hint a
            # replica queue would compute
            hints = [self._retry_hint(n) for n in eligible]
        if not hints:
            hint = min((self.breakers.get(n).probe_in_s() or 1.0
                        for n in self.replicas
                        if self.replicas[n].state != "dead"),
                       default=1.0)
            msg = ("no healthy fleet replica available (dead/draining/"
                   "breaker-open)")
        else:
            hint = min(hints)
            msg = (f"all {len(hints)} routable replica(s) rejected the "
                   "request (queue full / inflight bound)")
        if kind == "primary":
            self._counters["rejected_unavailable"] += 1
            raise FleetUnavailableError(
                f"request {p.rid!r} not routed: {msg}; retry after "
                f"{hint:.2f}s", retry_after_s=hint)
        if p.unplaced_since is None:
            p.unplaced_since = time.monotonic()
        return None

    def _payload_for(self, p: _Pending, h: ReplicaHandle
                     ) -> Optional[bytes]:
        """Pickle a spool payload once and reuse it for every re-route /
        hedge of the same request (local transport needs none).  The
        telemetry trace context embedded is the request's ROOT span —
        stable across re-routes, so the cache stays valid and every
        replica's span tree parents under the same router span."""
        if not isinstance(h, SpoolReplica):
            return None
        if p.payload is None:
            p.payload = SpoolReplica.encode_payload(
                p.cases, priority=p.priority,
                deadline_epoch=p.deadline_epoch,
                trace=(p.span.ctx() if p.span is not None else None),
                extra=p.extra, cases_blob=p.cases_blob)
        return p.payload

    def _load_score(self, name: str) -> tuple:
        """Least-loaded rank for one replica: ``(0, est_backlog_s,
        inflight)`` from its published queue depth + drain rate, or
        ``(1, inflight, inflight)`` when it has never published or its
        publication went stale (the inflight fallback).  Lower sorts
        first; fresh published signals outrank the rest.  Caller holds
        the lock.

        Router-side inflight is FOLDED INTO the backlog estimate, not
        only a tie-break: the published depth is a scrape old, so a
        burst between scrapes would otherwise herd onto whichever
        replica last published the lowest depth (double-counting a
        request that has since appeared in the published depth only
        overweights load uniformly — the ranking stays honest)."""
        pub = self._pub_load.get(name)
        inflight = float(self._inflight[name])
        if pub is not None:
            t_pub = pub.get("t_published")
            if (t_pub is not None
                    and time.time() - float(t_pub) > self._pub_stale_s):
                pub = None      # frozen exposition — fall back
        if pub is None:
            return (1, inflight, inflight)
        backlog = (float(pub.get("queue_depth") or 0.0)
                   + float(pub.get("pending") or 0.0)
                   + inflight)
        rate = float(pub.get("drain_rate_rps") or 0.0)
        est_s = backlog / rate if rate > 0 else backlog
        return (0, est_s, inflight)

    # -- the monitor ----------------------------------------------------
    def _monitor_loop(self) -> None:
        while True:
            with self._lock:
                if self._closed:
                    return
            try:
                self._tick()
            except Exception as e:      # the monitor must never die
                TellUser.error(f"fleet: monitor tick errored: {e}")
            time.sleep(self.tick_s)

    def _tick(self) -> None:
        self._poll_answers()
        self._scrape_published_load()
        self._check_health()
        self._watchdogs()
        self._publish_fleet_telemetry()
        # answered entries linger only to count late duplicates from
        # hedge/failover losers; prune them after a bounded window so a
        # loser that never answers cannot pin memory
        now = time.monotonic()
        with self._lock:
            for rid in [p.rid for p in self._pending.values()
                        if p.answered and p.answered_at is not None
                        and now - p.answered_at > 60.0]:
                self._pending.pop(rid, None)

    def _scrape_published_load(self) -> None:
        """Refresh the replica-published load signals (bounded cadence —
        each scrape is a file read + exposition parse per replica).  A
        replica whose exposition vanishes or goes unreadable keeps its
        last signal; one that never published stays None (the inflight
        fallback)."""
        now = time.monotonic()
        if now - self._scrape_last < 0.25:
            return
        self._scrape_last = now
        for name, h in list(self.replicas.items()):
            if h.state == "dead":
                continue
            try:
                pub = h.published_load()
            except Exception:
                pub = None
            if pub is not None:
                pub["t_scraped"] = now
                with self._lock:
                    self._pub_load[name] = pub

    def _publish_fleet_telemetry(self) -> None:
        """Write the router's own exposition (``fleet_telemetry.prom``)
        next to the fleet journal at ~1s cadence: replica liveness /
        inflight / scraped load as gauges, the routing counters, and the
        fleet request-latency histogram (same fixed bucket layout as the
        replicas', so `status` merges them exactly)."""
        if self.fleet_dir is None or not telemetry_registry.enabled():
            return
        now = time.monotonic()
        if now - self._telemetry_last < 1.0:
            return
        self._telemetry_last = now
        reg = self._telemetry
        with self._lock:
            counters = dict(self._counters)
            inflight = dict(self._inflight)
            pub_load = dict(self._pub_load)
        for k, v in counters.items():
            reg.gauge(f"dervet_fleet_{k}").set(float(v))
        for name, h in list(self.replicas.items()):
            reg.gauge("dervet_fleet_replica_up", replica=name).set(
                0.0 if h.state == "dead" else 1.0)
            reg.gauge("dervet_fleet_inflight", replica=name).set(
                float(inflight.get(name, 0)))
            pub = pub_load.get(name)
            if pub is not None:
                reg.gauge("dervet_fleet_published_queue_depth",
                          replica=name).set(
                    float(pub.get("queue_depth") or 0.0))
                reg.gauge("dervet_fleet_published_drain_rate_rps",
                          replica=name).set(
                    float(pub.get("drain_rate_rps") or 0.0))
        if self.result_cache is not None:
            # cache-hygiene counters (reqcache TTL/LRU eviction knobs)
            # ride the same exposition the autoscaler and `status` read
            snap = self.result_cache.snapshot()
            reg.gauge("dervet_request_cache_entries").set(
                float(snap["entries"]))
            for k in ("hits", "misses", "stores", "evictions",
                      "expired"):
                reg.gauge(f"dervet_request_cache_{k}_total").set(
                    float(snap[k]))
        reg.sample()
        try:
            from ..telemetry.ops import FLEET_PROM_FILE
            reg.write_prom(self.fleet_dir / FLEET_PROM_FILE)
        except OSError as e:
            TellUser.warning(f"fleet: telemetry exposition write "
                             f"failed: {e}")

    def _poll_answers(self) -> None:
        with self._lock:
            items = [(p, r) for p in self._pending.values()
                     for r in p.live_routes()]
        for p, route in items:
            h = self.replicas[route.replica]
            try:
                outcome = h.poll(p.rid)
            except Exception:
                continue
            if outcome is None:
                continue
            self._deliver(p, route, outcome)

    def _deliver(self, p: _Pending, route: _Route, outcome,
                 harvested: bool = False) -> None:
        kind, answer = outcome
        with self._lock:
            if route.resolved:
                return
            route.resolved = True
            route.end_span(outcome=kind, error=(
                None if kind == "done" else "replica reported failure"))
            self._inflight[route.replica] = max(
                0, self._inflight[route.replica] - 1)
            first = not p.answered
            if first:
                p.answered = True
                p.answered_at = time.monotonic()
                self._retire(p.rid, route.replica)
            else:
                self._counters["duplicates_suppressed"] += 1
            self._gc_pending(p)
            if first:
                latency = time.monotonic() - p.t_submit
                self._latencies.append(latency)
                self._completions[route.replica].append(time.monotonic())
                if route.kind == "hedge":
                    self._counters["hedge_wins"] += 1
                if route.kind == "failover" or harvested:
                    self._failover_latencies.append(latency)
                losers = p.live_routes()
                followers = self._detach_followers(p, route.replica)
        if not first:
            # the loser's just-ended transport span re-entered the
            # collector under an already-exported trace id — merge it
            # into the export so its timing survives and the orphan
            # collector slot is freed
            self._export_late_trace(p.rid)
            return
        # answering at all is evidence the replica works — typed request
        # failures (bad inputs) are the request's fault, not the path's
        self.breakers.record(route.replica, True)
        # hedge/failover losers: cancel at the next round boundary; a
        # result that lands anyway is suppressed above
        for loser in losers:
            try:
                self.replicas[loser.replica].cancel(p.rid)
                self._counters["cancels_sent"] += 1
            except Exception:
                pass
        if kind == "done":
            res = RoutedResult(
                rid=p.rid, replica=route.replica,
                result=None if isinstance(answer, Path) else answer,
                results_dir=answer if isinstance(answer, Path) else None,
                latency_s=latency,
                recovered=(route.kind == "failover" or harvested),
                harvested=harvested,
                hedged=(route.kind == "hedge"))
            with self._lock:
                self._counters["completed"] += 1
            if self.journal is not None:
                self.journal.completed(
                    p.rid, trace_id=telemetry_trace.trace_id_of(p.rid))
            self._maybe_store(p, answer)
            self._finish_trace(p, route, "done", harvested, latency)
            p.future.set_result(res)
            self._deliver_followers(followers, res=res)
        else:
            err = (answer if isinstance(answer, BaseException)
                   else ReplicaAnswerError(
                       f"request {p.rid!r} failed on replica "
                       f"{route.replica!r}: "
                       f"{(answer or {}).get('message', 'unknown')}",
                       payload=answer, replica=route.replica))
            with self._lock:
                self._counters["failed"] += 1
            if self.journal is not None:
                self.journal.failed(p.rid, getattr(err, "payload", None)
                                    or {"message": str(err)},
                                    trace_id=telemetry_trace
                                    .trace_id_of(p.rid))
            self._finish_trace(p, route, "failed", harvested, latency,
                               error=err)
            p.future.set_exception(err)
            self._deliver_followers(followers, err=err,
                                    replica=route.replica)

    def _detach_followers(self, p: _Pending, replica: str
                          ) -> List[_Pending]:
        """First-delivery bookkeeping for the dedup plane (caller holds
        the lock): drop the in-flight dedup key, retire every coalesced
        follower rid, and hand the followers back for delivery."""
        if p.cache_key is not None and \
                self._dedup.get(p.cache_key) == p.rid:
            self._dedup.pop(p.cache_key, None)
        followers, p.followers = p.followers, []
        for f in followers:
            self._follower_rids.pop(f.rid, None)
            self._retire(f.rid, replica)
        return followers

    def _deliver_followers(self, followers: List[_Pending], *,
                           res: Optional[RoutedResult] = None,
                           err=None, replica: str = "") -> None:
        """Fan the leader's answer out to its coalesced followers: one
        solve, N deliveries — each follower journaled, trace-exported,
        and counted under its OWN rid."""
        for f in followers:
            latency = time.monotonic() - f.t_submit
            if self.journal is not None:
                if err is None:
                    self.journal.completed(
                        f.rid,
                        trace_id=telemetry_trace.trace_id_of(f.rid))
                else:
                    self.journal.failed(
                        f.rid, getattr(err, "payload", None)
                        or {"message": str(err)},
                        trace_id=telemetry_trace.trace_id_of(f.rid))
            with self._lock:
                if err is None:
                    self._counters["completed"] += 1
                    self._latencies.append(latency)
                else:
                    self._counters["failed"] += 1
            if telemetry_registry.enabled() and err is None:
                self._telemetry.histogram(
                    "dervet_fleet_request_latency_seconds"
                ).observe(latency)
            if f.span is not None:
                telemetry_trace.release_request(f.rid)
                f.span.set_attrs({
                    "replica": res.replica if res is not None else replica,
                    "outcome": "done" if err is None else "failed",
                    "coalesced": True, "latency_s": round(latency, 6)})
                f.span.end(error=err)
                f.span = None
            self._export_trace_best_effort(f.rid)
            if err is None:
                f.future.set_result(RoutedResult(
                    rid=f.rid, replica=res.replica, result=res.result,
                    results_dir=res.results_dir, latency_s=latency,
                    coalesced=True))
            else:
                f.future.set_exception(err)

    def _maybe_store(self, p: _Pending, answer) -> None:
        """Persist a just-delivered answer into the result cache (the
        certificate contract — certified, audit-clean, no quarantines —
        is enforced inside ``RequestResultCache.store``).  Store
        failures are logged, never raised: the cache must not block
        delivery."""
        if p.cache_key is None or self.result_cache is None \
                or not reqcache.enabled():
            return
        try:
            if isinstance(answer, Path):
                run_health = None
                rh = answer / f"run_health.{p.rid}.json"
                if not rh.exists():
                    rh = answer / "run_health.json"
                try:
                    run_health = json.loads(rh.read_text())
                except (OSError, ValueError):
                    run_health = None
                # serve_main writes fidelity.json only for degraded
                # (load-shed screening) answers
                fidelity = ("degraded"
                            if (answer / "fidelity.json").exists()
                            else "certified")
                stored = self.result_cache.store(
                    p.cache_key, p.cache_material, rid=p.rid,
                    results_dir=answer, run_health=run_health,
                    fidelity=fidelity)
            else:
                stored = self.result_cache.store(
                    p.cache_key, p.cache_material, rid=p.rid,
                    result=answer,
                    run_health=getattr(answer, "run_health", None),
                    fidelity=getattr(answer, "fidelity", None))
            if stored:
                with self._lock:
                    self._counters["request_cache_stores"] += 1
                if p.span is not None:
                    p.span.event("request_cache_store",
                                 key=p.cache_key[:16])
        except Exception as e:
            TellUser.warning(
                f"fleet: request-cache store for {p.rid} failed: {e}")

    def _export_trace_best_effort(self, rid: str) -> None:
        if self.fleet_dir is None or not telemetry_trace.enabled():
            return
        try:
            telemetry_trace.export_request_trace(
                rid, self.fleet_dir / "traces", chrome=True)
        except Exception as e:      # observability must never block
            TellUser.warning(f"fleet: trace export for {rid} "
                             f"failed: {e}")

    def _finish_trace(self, p: _Pending, route: _Route, outcome: str,
                      harvested: bool, latency: float,
                      error=None) -> None:
        """First-delivery telemetry tail: close the request's router-
        side root span, export the router's slice of the trace
        (``fleet_dir/traces/trace.<rid>.json`` + Chrome timeline — the
        ``trace`` CLI stitches it with the replicas' exports), and feed
        the fleet latency histogram."""
        if telemetry_registry.enabled():
            self._telemetry.histogram(
                "dervet_fleet_request_latency_seconds").observe(latency)
        if p.span is None:
            return
        telemetry_trace.release_request(p.rid)
        p.span.set_attrs({"replica": route.replica, "outcome": outcome,
                          "harvested": harvested,
                          "hedged": route.kind == "hedge",
                          "recovered": (route.kind == "failover"
                                        or harvested),
                          "latency_s": round(latency, 6)})
        p.span.end(error=error)
        if self.fleet_dir is None or not telemetry_trace.enabled():
            return
        try:
            telemetry_trace.export_request_trace(
                p.rid, self.fleet_dir / "traces", chrome=True)
        except Exception as e:      # observability must never block
            TellUser.warning(f"fleet: trace export for {p.rid} "
                             f"failed: {e}")

    def _export_late_trace(self, rid) -> None:
        """Late-answer telemetry tail: a hedge/failover loser answered
        after the request's trace was exported.  Merge its span into
        the on-disk export (popping the orphan collector entry).  With
        no fleet_dir the first delivery never popped either — the
        loser's span joined the live collector entry and there is
        nothing to do."""
        if self.fleet_dir is None or not telemetry_trace.enabled():
            return
        try:
            telemetry_trace.export_request_trace(
                rid, self.fleet_dir / "traces", chrome=True, merge=True)
        except Exception as e:      # observability must never block
            TellUser.warning(f"fleet: late trace export for {rid} "
                             f"failed: {e}")

    def _retire(self, rid: str, replica: str) -> None:
        """Caller holds the lock."""
        self._retired[rid] = replica
        while len(self._retired) > self._retired_cap:
            self._retired.popitem(last=False)

    def _gc_pending(self, p: _Pending) -> None:
        """Drop an answered entry once no live route could still answer
        (so late duplicates in flight are still counted).  Caller holds
        the lock."""
        if p.answered and not any(
                not r.resolved
                and self.replicas[r.replica].state != "dead"
                for r in p.routes):
            self._pending.pop(p.rid, None)

    # -- health / failover ----------------------------------------------
    def _check_health(self) -> None:
        now = time.time()
        for name, h in list(self.replicas.items()):
            hb = h.heartbeat()
            # heartbeat-epoch fence: a beat carrying an epoch BELOW the
            # handle's own incarnation — or at/below an armed fence —
            # is a fenced zombie's late write over the shared spool:
            # discredit it entirely (it must neither count as liveness
            # nor echo probes nor resurrect the name)
            hb_epoch = None if hb is None else hb.get("epoch")
            if hb_epoch is not None and (
                    (h.epoch is not None
                     and int(hb_epoch) < int(h.epoch))
                    or (h.fence_epoch is not None
                        and int(hb_epoch) <= int(h.fence_epoch))):
                hb = None
            self._hb_cache[name] = hb
            fresh = (hb is not None
                     and now - float(hb.get("t", 0))
                     <= self.heartbeat_timeout_s)
            if hb is not None:
                self._last_beat[name] = time.monotonic()
            if fresh and self._first_seen[name] is None:
                self._first_seen[name] = time.monotonic()
            if h.state == "dead":
                # a restarted replica announces itself with FRESH
                # heartbeats: resurrect the routing state (the breaker's
                # probe cycle still gates traffic).  For a router-owned
                # process that died, a fresh beat can only come from a
                # NEW process over the same spool — its pid differs, and
                # the handle stops owning (fencing a process we did not
                # spawn would be wrong).  When a fence epoch was
                # recorded at declare-dead, only a STRICTLY HIGHER
                # epoch resurrects: the corpse's own late beats (same
                # epoch) can never re-open routing to a zombie.
                new_pid = (hb is not None
                           and getattr(h, "process", None) is not None
                           and hb.get("pid") not in
                           (None, h.process.pid))
                epoch_ok = (h.fence_epoch is None
                            or (hb_epoch is not None
                                and int(hb_epoch) > int(h.fence_epoch)))
                if fresh and epoch_ok \
                        and (h.alive() is not False or new_pid):
                    if new_pid:
                        h.process = None
                    h.state = "up"
                    h.fence_epoch = None
                    TellUser.warning(
                        f"fleet: replica {name!r} is heartbeating again "
                        "— resurrected (breaker still gates routing)")
                else:
                    continue
            dead_reason = None
            if h.alive() is False:
                dead_reason = "process exited"
            elif self._first_seen[name] is None:
                # never seen a fresh beat: a stale heartbeat.json in a
                # REUSED spool must not fence a still-booting replica —
                # only the startup grace can expire it (measured from
                # when THIS handle entered the router's care, so a
                # supervisor-adopted replacement gets its full boot
                # window)
                if time.monotonic() - self._adopted_at.get(
                        name, self._t_start) > self.startup_grace_s:
                    dead_reason = ("no fresh heartbeat within the "
                                   f"{self.startup_grace_s:g}s startup "
                                   "grace")
            elif hb is None:
                last = self._last_beat[name]
                if last is not None and \
                        time.monotonic() - last > self.heartbeat_timeout_s:
                    dead_reason = "heartbeat disappeared"
            elif not fresh:
                age = now - float(hb.get("t", 0))
                dead_reason = (f"heartbeats stopped "
                               f"({age:.1f}s > "
                               f"{self.heartbeat_timeout_s:g}s)")
            if dead_reason is not None:
                self._declare_dead(name, dead_reason)
            else:
                self._probe_cycle(name, hb)

    def _probe_cycle(self, name: str, hb: Optional[Dict]) -> None:
        """Half-open probing for a breaker-opened (flapping) replica:
        send a heartbeat nonce, close the breaker when it echoes."""
        br = self.breakers.get(name)
        pr = self._probes.get(name)
        if pr is not None:
            if hb is not None and \
                    str(hb.get("probe_nonce")) == pr["nonce"]:
                self._probes.pop(name, None)
                with self._lock:
                    self._counters["probes_ok"] += 1
                span = pr.get("span")
                if span is not None:
                    # the heartbeat carried the probe's trace context
                    # back (fleet.py writes it, the serve loop echoes
                    # it): the probe round-trip closes as one span
                    span.event("echo", pid=hb.get("pid"),
                               echoed_trace=bool(hb.get("probe_trace")))
                    span.end()
                    self._drain_probe_trace(name)
                # counter first: record(True) closes the breaker, which
                # is what callers wait on — the count must already be
                # there when they look
                br.record(True)
                return
            if time.monotonic() - pr["t"] > self.probe_timeout_s:
                self._probes.pop(name, None)
                span = pr.get("span")
                if span is not None:
                    span.end(error="probe timeout — no echo within "
                                   f"{self.probe_timeout_s:g}s")
                    self._drain_probe_trace(name)
                br.record(False)
            return
        if br.state != br.CLOSED and br.allow():
            nonce = f"{name}-{time.time_ns()}"
            # probe spans live on a per-replica probe trace (rid
            # ``probe.<name>``), exported to ``fleet/traces`` at each
            # round-trip (`python -m dervet_tpu_torch trace probe.<name>
            # FLEET_DIR`)
            span = telemetry_trace.start_span(
                "probe",
                trace_id=telemetry_trace.trace_id_for(f"probe.{name}"),
                attrs={"replica": name, "nonce": nonce})
            try:
                self.replicas[name].probe(
                    nonce, trace=(span.ctx() if span else None))
            except Exception:
                if span:
                    span.end(error="probe write failed")
                    self._drain_probe_trace(name)
                br.record(False)
                return
            self._probes[name] = {"nonce": nonce, "t": time.monotonic(),
                                  "span": (span if span else None)}
            with self._lock:
                self._counters["probes_sent"] += 1

    def _drain_probe_trace(self, name: str) -> None:
        """Export (or discard) the per-replica ``probe.<name>`` trace
        after each probe round-trip: probe traces are never delivered
        through the request path, so without this a long-lived router
        pins every probe span in the collector until the per-trace cap
        silently drops new ones."""
        prid = f"probe.{name}"
        exported = None
        if self.fleet_dir is not None:
            try:
                exported = telemetry_trace.export_request_trace(
                    prid, self.fleet_dir / "traces")
            except Exception:       # observability must never block
                exported = None
        if exported is None:
            telemetry_trace.COLLECTOR.pop(
                telemetry_trace.trace_id_for(prid))

    def _declare_dead(self, name: str, reason: str) -> None:
        h = self.replicas[name]
        h.state = "dead"
        # arm the epoch fence: the corpse's incarnation (its spawn
        # epoch, or the last epoch it beat with) is now STALE — only a
        # replacement beating with a higher epoch resurrects this name
        last_hb = self._hb_cache.get(name)
        last_epoch = (last_hb or {}).get("epoch")
        if last_epoch is None:
            last_epoch = h.epoch
        if last_epoch is not None:
            h.fence_epoch = int(last_epoch)
        with self._lock:
            self._counters["heartbeat_deaths"] += 1
        TellUser.error(f"fleet: replica {name!r} declared DEAD "
                       f"({reason}) — failing over its in-flight "
                       "requests")
        self.breakers.trip(name, reason)
        if self.journal is not None:
            self.journal.note("replica_dead", name, reason=reason,
                              fence_epoch=h.fence_epoch)
        self._failover(name)
        # hand the corpse to the lifecycle supervisor AFTER fencing +
        # exactly-once failover: its in-flight work is already re-homed,
        # so the supervisor only owes the fleet a replacement
        if self.supervisor is not None:
            try:
                self.supervisor.on_replica_dead(name, reason)
            except Exception as e:      # supervision must never break
                TellUser.warning(       # the router's own failover
                    f"fleet: supervisor death hook for {name!r} "
                    f"failed: {e}")

    def _failover(self, name: str) -> None:
        h = self.replicas[name]
        h.kill()                        # fence before re-routing
        with self._lock:
            self._counters["failovers"] += 1
            victims = [(p, r) for p in self._pending.values()
                       for r in p.live_routes() if r.replica == name]
        blob = h.read_memory_export()
        handed_off: set = set()
        for p, route in victims:
            if p.span is not None:
                # the failover-drill trace contract: fence, then either
                # harvest or re-route, visible on the stitched timeline
                p.span.event("fence", replica=name,
                             reason="replica declared dead — SIGKILL "
                                    "fenced before recovery")
            state = h.request_state(p.rid)
            if state in ("completed", "failed"):
                # the replica finished this one before dying: harvest —
                # results were persisted BEFORE its journal's terminal
                # record, so the answer exists on disk; no re-solve,
                # no double answer
                outcome = h.poll(p.rid)
                if outcome is None and state == "completed":
                    outcome = ("done", getattr(h, "results_root",
                                               Path(".")) / p.rid)
                if outcome is not None:
                    # only a FIRST delivery is a genuine recovery; an
                    # already-answered request (hedge winner landed
                    # earlier) is just a suppressed duplicate and must
                    # not inflate the harvested metric the smoke/bench
                    # gates read.  No race: delivery happens only on
                    # this monitor thread.
                    if not p.answered:
                        with self._lock:
                            self._counters["harvested"] += 1
                        if self.journal is not None:
                            self.journal.note(
                                "harvested", p.rid, replica=name,
                                trace_id=telemetry_trace
                                .trace_id_of(p.rid))
                        if p.span is not None:
                            p.span.event("harvest", replica=name)
                    self._deliver(p, route, outcome, harvested=True)
                    continue
            # unanswered: fence its spool entry, then re-route with the
            # dead replica's warm-start memory riding along
            with self._lock:
                route.resolved = True
                route.end_span(outcome="dead",
                               error="replica died before answering")
                self._inflight[name] = max(0, self._inflight[name] - 1)
                if p.answered:
                    self._gc_pending(p)
                    continue
            try:
                h.retract(p.rid)
            except Exception:
                pass
            target = self._reroute(p, exclude={name},
                                   counter="rerouted")
            if blob and target is not None and target not in handed_off:
                try:
                    self.replicas[target].import_memory(blob)
                    handed_off.add(target)
                    with self._lock:
                        self._counters["memory_handoffs"] += 1
                        self._memory_handoffs[target] = \
                            self._memory_handoffs.get(target, 0) + 1
                except Exception as e:
                    TellUser.warning(
                        f"fleet: warm-start handoff to {target!r} "
                        f"failed: {e}")

    def _reroute(self, p: _Pending, exclude, counter: str
                 ) -> Optional[str]:
        with self._lock:
            if p.answered:
                return None
            p.recovered = True
            target = self._route(p, kind="failover", exclude=exclude)
            if target is not None:
                self._counters[counter] += 1
        if target is not None:
            if self.journal is not None:
                self.journal.note("rerouted", p.rid, to=target,
                                  trace_id=telemetry_trace
                                  .trace_id_of(p.rid))
            if p.span is not None:
                p.span.event("reroute", to=target, kind=counter)
        return target

    # -- watchdog + hedging ---------------------------------------------
    def _watchdogs(self) -> None:
        now = time.monotonic()
        with self._lock:
            entries = [p for p in self._pending.values()
                       if not p.answered]
        for p in entries:
            live = p.live_routes()
            if not live:
                # unplaced (failover found no healthy target): retry
                # placement; give up loudly after the patience window
                # or the deadline, whichever lands first
                expired = (p.deadline_epoch is not None
                           and time.time() > p.deadline_epoch)
                patience_over = (
                    p.unplaced_since is not None
                    and now - p.unplaced_since
                    > self.placement_patience_s)
                if expired or patience_over:
                    err = FleetUnavailableError(
                        f"request {p.rid!r} could not be re-placed "
                        "on any healthy replica"
                        + (" before its deadline" if expired else
                           f" within {self.placement_patience_s:g}s"),
                        retry_after_s=1.0)
                    if not p.future.done():
                        if p.span is not None:
                            telemetry_trace.release_request(p.rid)
                            p.span.event("unplaceable",
                                         expired=bool(expired))
                            p.span.end(error=err)
                        p.future.set_exception(err)
                    with self._lock:
                        self._counters["failed"] += 1
                        self._retire(p.rid, "")
                        p.answered = True
                        self._pending.pop(p.rid, None)
                        followers = self._detach_followers(p, "")
                    self._deliver_followers(followers, err=err)
                    continue
                self._reroute(p, exclude=(), counter="rerouted")
                continue
            # per-request watchdog: the replica heartbeats but this
            # request has sat beyond the bound (batcher wedged, round
            # starving) — count it against the breaker and mirror the
            # request elsewhere; first answer still wins
            if self.request_timeout_s is not None and \
                    not any(r.kind == "failover" for r in p.routes):
                for route in live:
                    if now - route.t > self.request_timeout_s:
                        self.breakers.record(route.replica, False)
                        with self._lock:
                            self._counters["watchdog_reroutes"] += 1
                        self._reroute(p, exclude={route.replica},
                                      counter="rerouted")
                        break
            # hedging: deadline-pressured and slow -> mirror once
            if self.hedging and p.deadline_s is not None and \
                    not any(r.kind == "hedge" for r in p.routes) and \
                    len(self.replicas) > 1:
                hedge_at = p.t_submit + max(
                    self.hedge_min_wait_s,
                    self.hedge_wait_frac * float(p.deadline_s))
                if now >= hedge_at:
                    with self._lock:
                        exclude = {r.replica for r in p.routes}
                        target = self._route(p, kind="hedge",
                                             exclude=exclude)
                        if target is not None:
                            self._counters["hedged"] += 1
                    if target is not None:
                        if self.journal is not None:
                            self.journal.note(
                                "hedged", p.rid, to=target,
                                trace_id=telemetry_trace
                                .trace_id_of(p.rid))
                        if p.span is not None:
                            p.span.event("hedged", to=target)

    # -- observability --------------------------------------------------
    def metrics(self) -> Dict:
        import numpy as np
        with self._lock:
            lat = np.asarray(self._latencies, dtype=float)
            fol = np.asarray(self._failover_latencies, dtype=float)
            counters = dict(self._counters)
            inflight = dict(self._inflight)
            pub_load = dict(self._pub_load)
            pending = len(self._pending)
        aff_total = counters["affinity_hits"] + counters["affinity_misses"]
        replicas = {}
        now = time.time()
        for name, h in list(self.replicas.items()):
            hb = h.heartbeat()
            replicas[name] = {
                **h.snapshot(),
                "breaker": self.breakers.get(name).snapshot(),
                "inflight": inflight.get(name, 0),
                "heartbeat_age_s": (round(now - float(hb["t"]), 3)
                                    if hb and "t" in hb else None),
                "heartbeat": hb,
                "memory_handoffs_received":
                    self._memory_handoffs.get(name, 0),
                # the scraped self-published load signal this replica is
                # currently ranked by (None = never published: the
                # router falls back to its inflight count)
                "published_load": pub_load.get(name),
            }
        pct = (lambda a, q: round(float(np.percentile(a, q)), 4)
               if a.size else None)
        supervisor = None
        if self.supervisor is not None:
            try:
                supervisor = self.supervisor.snapshot()
            except Exception:
                supervisor = None
        return {
            "replicas": replicas,
            "supervisor": supervisor,
            "routing": {**counters,
                        "pending": pending,
                        "affinity_hit_rate": (
                            round(counters["affinity_hits"] / aff_total, 4)
                            if aff_total else None)},
            "request_cache": (self.result_cache.snapshot()
                              if self.result_cache is not None else None),
            "latency_s": {"n": int(lat.size), "p50": pct(lat, 50),
                          "p99": pct(lat, 99),
                          "max": (round(float(lat.max()), 4)
                                  if lat.size else None)},
            "failover_latency_s": {
                "n": int(fol.size), "p50": pct(fol, 50),
                "p99": pct(fol, 99),
                "max": (round(float(fol.max()), 4)
                        if fol.size else None)},
        }
