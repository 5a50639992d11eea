"""ScenarioService: the long-lived serving layer.

``DERVET.solve`` is a cold one-shot batch run — every caller pays device
warm-up (the CUDA context, the chunk kernels' nvcc build), solver builds
(Ruiz preconditioning, the ||K|| power iteration, the compact K forms),
and a full sweep even for a single case.  The service amortizes all of
it across requests:

* **Persistent solver cache** — one :class:`~dervet_tpu_torch.scenario.
  scenario.SolverCache` lives across rounds, so a structure seen once
  never re-preconditions; a hot service's steady state is zero solver
  builds and zero compile events (a program's first launch on a new
  solver) per round, and the bucket grid keeps its batch widths few.
* **Cross-request continuous batching** — each round coalesces every
  pending request's window LPs through ONE ``run_dispatch``, whose
  structure-key grouping batches them across request boundaries into the
  existing compaction buckets; ``max_wait_s`` / ``max_batch_requests``
  are the usual continuous-batching knobs.
* **Bounded admission with backpressure** — a full queue rejects with a
  typed retry-after error (never unbounded buffering); priorities and
  per-request deadlines ride the queue.
* **Graceful drain** — SIGTERM stops admissions immediately, lets the
  in-flight round finish (or checkpoint, via the run supervisor), and
  flushes per-request ``run_manifest.<rid>.json`` slices; the serve CLI
  then exits 0.
* **Per-request observability** — every request gets its own namespaced
  run-health report and solve-ledger slice; the service aggregates queue
  depth, admission rejects, batch occupancy, request latency p50/p99,
  and compile-cache hits under :meth:`ScenarioService.metrics`.

``python -m dervet_tpu_torch serve SPOOL_DIR`` runs the file-spool front
end: model-parameter files dropped into ``SPOOL_DIR/incoming/`` become
requests (request id = file stem), results land in
``SPOOL_DIR/results/<rid>/``.

This package drives ONE device (``device=None`` -> ``cuda:0``, raising
at construction when no GPU is visible; ``device="cpu"`` only by name).
Several serve-loop replicas may share one card behind the fleet router
(``service.router``), each process with a CUDA context of its own.
"""
from __future__ import annotations

import collections
import re
import threading
import time
from concurrent.futures import Future
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..scenario.scenario import SolverCache
from ..telemetry import ops as telemetry_ops
from ..telemetry import registry as telemetry_registry
from ..telemetry import trace as telemetry_trace
from ..utils.breaker import BreakerBoard
from ..utils.errors import (BackendLostError, BreakerOpenError,
                            PoisonRequestError, PreemptedError,
                            ShardCacheMissError, TellUser)
from ..utils.supervisor import RunSupervisor
from . import resilience
from .batcher import BatchRound
from .queue import (AdmissionQueue, QueuedRequest, QueueFullError,
                    ServiceClosedError, ServiceError)

# request ids name files (checkpoints, manifests, health reports): the
# admission boundary rejects anything that could escape the artifact
# directories or collide after sanitization
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

# the serve loop's exit status after its backend was lost for good (a
# sticky CUDA fault outlived the re-init budget): EX_UNAVAILABLE.  The
# round's requests stay "admitted" in the journal, so the fleet router
# re-routes them to a live replica and the supervisor respawns this one.
EXIT_BACKEND_LOST = 69


class ScenarioService:
    """Persistent scenario-solving service (in-process).

    Lifecycle: construct -> :meth:`start` (or drive :meth:`run_once`
    manually, e.g. in tests) -> :meth:`submit` from any thread ->
    :meth:`drain`/:meth:`close`.  Thread model: one batcher thread runs
    the rounds; ``submit`` only touches the admission queue."""

    def __init__(self, backend: str = "torch", solver_opts=None,
                 max_queue_depth: int = 64, max_wait_s: float = 0.25,
                 max_batch_requests: int = 32, checkpoint_dir=None,
                 max_cached_structures: int = 64,
                 gc_checkpoints: bool = True,
                 load_shedding: bool = True,
                 shed_threshold_frac: float = 0.75,
                 shed_sustain_rounds: int = 2,
                 shed_priority_max: int = 0,
                 breaker_opts: Optional[Dict] = None,
                 backend_max_reinits: int = 2,
                 fairness_after_s: float = 30.0, device=None):
        if backend not in ("torch", "cpu"):
            raise ValueError(f"backend must be 'torch' or 'cpu', got "
                             f"{backend!r}")
        self.backend = backend
        # the one device every cache and round of this service solves on,
        # resolved HERE: without a GPU, device=None raises before the
        # batcher thread exists or anything is admitted.  The exact 'cpu'
        # backend solves on HiGHS and takes no device.
        if backend != "cpu":
            from ..device import resolve_device
            device = resolve_device(device)
        self.device = device
        self.solver_opts = solver_opts
        self.max_wait_s = float(max_wait_s)
        self.max_batch_requests = int(max_batch_requests)
        self.checkpoint_dir = checkpoint_dir
        self.max_cached_structures = int(max_cached_structures)
        # delivered requests' checkpoints/manifest slices are reclaimed
        # by default (unbounded disk otherwise); failed/preempted
        # requests always keep theirs for resume
        self.gc_checkpoints = bool(gc_checkpoints)
        self.queue = AdmissionQueue(max_queue_depth,
                                    fairness_after_s=fairness_after_s)
        # the hot-service core: compiled solvers + preconditioning live
        # across rounds (see run_dispatch's solver_cache hook), and
        # pad_grid snaps every coalesced batch onto the pdhg compaction
        # bucket widths so varying request mixes reuse compiled shapes
        # warm_start: the cache carries a SolutionMemory across rounds,
        # so repeat/nearby requests seed PDHG from stored converged
        # iterates (exact repeats re-verify + ship the stored solution
        # with zero device work) — see ops/warmstart.py; every seeded
        # window still runs full convergence criteria + certification
        self.solver_cache = SolverCache(pad_grid=(backend != "cpu"),
                                        warm_start=True, device=device)
        # -- self-healing layer (see service/resilience.py) ------------
        # circuit breakers around the escalation-ladder rungs, the
        # certification path, and the backend as a whole; thresholds are
        # overridable via breaker_opts (window/min_samples/
        # failure_threshold/cooldown_s)
        self.breakers = BreakerBoard(**(breaker_opts or {}))
        # the backend breaker trips only on TOTAL round failures (post
        # recovery), so it needs consecutive hard evidence
        self.breakers.configure(
            "backend", min_samples=2, failure_threshold=1.0,
            **{k: v for k, v in (breaker_opts or {}).items()
               if k in ("window", "cooldown_s")})
        # load shedding: sustained overload answers low-priority
        # requests with an explicit degraded-fidelity screening solve
        # instead of rejecting them (None = shedding disabled)
        self.shedder = (resilience.LoadShedder(
            threshold_frac=shed_threshold_frac,
            sustain_rounds=shed_sustain_rounds,
            shed_priority_max=shed_priority_max)
            if load_shedding else None)
        # the degraded tier gets its OWN compiled-solver cache: a
        # screening solver (loose tolerance, short budget) must never be
        # handed to a certified-tier round sharing the structure key
        # the degraded tier SHARES the warm-start memory (its screening
        # answers make fine seeds and vice versa — the tolerance tag
        # keeps a loose answer from ever substituting for a certified
        # one) while keeping its own compiled-solver cache
        self.degraded_cache = SolverCache(pad_grid=(backend != "cpu"),
                                          memory=self.solver_cache.memory,
                                          device=device)
        # design requests (BOOST sizing): persistent per-tier screening
        # caches — a warm service screens a repeat population with zero
        # solver builds; finalists ride the certified solver_cache above.
        # One SHARED solution memory across the tiers and the certified
        # cache: tier i+1 re-screens the same candidates seeded from
        # tier i's iterates, and finalists seed from the tightest
        # screening iterates (near-grade only — substitution needs an
        # exact tolerance-tag match)
        from ..design.screen import ScreeningCaches
        self.design_caches = ScreeningCaches(
            pad_grid=(backend != "cpu"),
            memory=self.solver_cache.memory, device=device)
        self._design = {"requests": 0, "candidates": 0, "screen_rounds": 0,
                        "screen_s": 0.0, "finalists": 0,
                        "degraded_answers": 0, "screen_dispatches": 0,
                        "screen_compile_events": 0}
        # the last design screening's per-round stats (the zero-compile
        # warm observable the design smoke gates on)
        self.last_screen_stats: Optional[Dict] = None
        # portfolio-request counters (dervet_tpu_torch/portfolio): coupled
        # fleets solved through the dual-decomposed outer loop
        self._portfolio = {"requests": 0, "outer_rounds": 0,
                           "windows": 0, "dual_iterate_seeds": 0,
                           "degraded_answers": 0, "infeasible": 0,
                           "failed": 0, "portfolio_s": 0.0,
                           # fleet-sharded rounds served FOR other
                           # nodes' dual loops (portfolio/shard.py)
                           "shard_requests": 0, "shard_windows": 0,
                           "shard_failed": 0, "shard_s": 0.0}
        # the last portfolio solve's observability section (gap, rounds,
        # certificate) — the smoke/bench gates' surface
        self.last_portfolio: Optional[Dict] = None
        # monte-carlo request counters (dervet_tpu_torch/stochastic): batched
        # uncertainty valuations — the sample mass screens through the
        # design_caches tiers, the quantile-pinning samples certify
        # through the main solver_cache
        self._montecarlo = {"requests": 0, "samples": 0,
                            "certified_samples": 0, "quarantined": 0,
                            "degraded_answers": 0, "mc_s": 0.0,
                            "dispatches": 0, "compile_events": 0}
        # the last MC run's tier mix + per-round dispatch stats (the
        # zero-compile warm observable the mc smoke gates on)
        self.last_mc_stats: Optional[Dict] = None
        # backend-loss recovery policy + poison-request registry
        self.recovery = resilience.BackendRecovery(
            max_reinits=backend_max_reinits, device=device)
        self.poison_registry = resilience.PoisonRegistry()
        # drain flag is set from signal context (on_stop must stay
        # lock-free); the queue is closed later, on a normal thread.
        # Handlers install only when the OWNER enters the supervisor
        # (serve loop / tests, main thread); library embedders who never
        # enter it still get programmatic drain via request_stop().
        self._draining = threading.Event()
        self.supervisor = RunSupervisor(install_signals=True,
                                        on_stop=self._draining.set)
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        self._seq_lock = threading.Lock()
        # ids with an unresolved future: a resubmission of a live id
        # would cross-wire results (scenario maps / checkpoints /
        # manifests key on it), so it is rejected at admission; the id
        # frees the moment its future resolves
        self._active_ids: set = set()
        # replica-side portfolio shard case cache: the full site
        # payload arrives ONCE per (seed_tag, plan_fp); every
        # later dual round ships just the price vector + the plan
        # fingerprint and resolves the cases here at admission.  A
        # reference that misses (failover moved the shard, eviction,
        # restart) raises the typed ShardCacheMissError, and the shard
        # executor re-sends the full payload once.  Bounded LRU — a
        # replica serving many portfolios must not pin every site set.
        self._shard_cases: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._shard_cases_cap = 32
        self._shard_cases_lock = threading.Lock()
        self._metrics_lock = threading.Lock()
        # bounded: the percentile surface only needs a recent window,
        # and a service that never dies must not grow per-request state
        self._latencies = collections.deque(maxlen=4096)
        self._rounds = {"count": 0, "requests": 0, "cases": 0,
                        "windows": 0, "device_groups": 0,
                        "cross_request_groups": 0, "batch_sum": 0.0,
                        "compile_events": 0, "round_s": 0.0,
                        "preempted": 0, "degraded_rounds": 0,
                        "seeded_windows": 0, "substituted_windows": 0}
        # elastic-scheduler aggregates (parallel/elastic.py): rounds
        # that rode the multi-device scheduler, total steals, worst
        # per-device occupancy seen
        self._elastic = {"rounds": 0, "steals": 0,
                         "min_occupancy": None}
        self._requests = {"completed": 0, "failed": 0}
        self.last_round_ledger: Optional[Dict] = None
        self.device_info: Optional[Dict] = None
        self._started = False

    # -- admission ------------------------------------------------------
    def submit(self, cases, *, request_id=None, priority: int = 0,
               deadline_s: Optional[float] = None,
               trace_ctx: Optional[Dict] = None) -> Future:
        """Admit one request (a dict of case key -> ``CaseParams``, or an
        iterable of cases) and return the future its
        :class:`~dervet_tpu_torch.results.result.Result` is delivered through.

        ``trace_ctx`` is an upstream telemetry trace context (the fleet
        router's ``{"trace_id", "span_id"}`` riding the transport
        payload) — the request's span tree parents under it, so one
        stitched trace follows the request across processes.

        Raises :class:`~dervet_tpu_torch.service.queue.QueueFullError` (with a
        ``retry_after_s`` hint) under backpressure and
        :class:`~dervet_tpu_torch.service.queue.ServiceClosedError` once the
        service is draining."""
        if self._draining.is_set():
            raise ServiceClosedError(
                "service is draining — no new admissions")
        if not isinstance(cases, dict):
            cases = dict(enumerate(cases))
        if not cases:
            raise ValueError("a request needs at least one case")
        fingerprint = resilience.request_fingerprint(cases)
        return self._admit(request_id, fingerprint, priority, deadline_s,
                           cases=cases, trace_ctx=trace_ctx)

    def submit_design(self, case, spec=None, *, request_id=None,
                      priority: int = 0,
                      deadline_s: Optional[float] = None,
                      trace_ctx: Optional[Dict] = None,
                      **spec_kwargs) -> Future:
        """Admit one DESIGN request (BOOST sizing): screen a candidate
        population over ``spec``'s bounds, certify the top-k, deliver a
        :class:`~dervet_tpu_torch.design.frontier.DesignFrontier` through the
        returned future.  Admission semantics (priority, deadline,
        backpressure, poison blocklist, draining) are identical to
        :meth:`submit` — a design request is just another request type.

        ``spec`` is a :class:`~dervet_tpu_torch.design.population.DesignSpec`;
        alternatively pass its fields as keyword arguments."""
        from ..design.population import DesignSpec
        from ..design.service import design_fingerprint
        if self._draining.is_set():
            raise ServiceClosedError(
                "service is draining — no new admissions")
        if spec is None:
            spec = DesignSpec(**spec_kwargs)
        spec.validate()       # spec errors raise HERE, at admission
        fingerprint = design_fingerprint(case, spec)
        return self._admit(request_id, fingerprint, priority, deadline_s,
                           kind="design", design_case=case,
                           design_spec=spec, trace_ctx=trace_ctx)

    def submit_montecarlo(self, case, spec=None, *, request_id=None,
                          priority: int = 0,
                          deadline_s: Optional[float] = None,
                          trace_ctx: Optional[Dict] = None,
                          **spec_kwargs) -> Future:
        """Admit one MONTE-CARLO request (uncertainty valuation): sample
        ``spec.n_samples`` seeded perturbations of ``case``, solve them
        as one batch (screening mass + certified quantile-pinning
        re-solves), deliver an
        :class:`~dervet_tpu_torch.stochastic.distribution.MCDistribution`
        through the returned future.  Admission semantics (priority,
        deadline, backpressure, poison blocklist, draining) are
        identical to :meth:`submit` — an MC request is just another
        request type.

        ``spec`` is a :class:`~dervet_tpu_torch.stochastic.sampler.MCSpec`;
        alternatively pass its fields as keyword arguments."""
        from ..stochastic.sampler import MCSpec
        from ..stochastic.service import montecarlo_fingerprint
        if self._draining.is_set():
            raise ServiceClosedError(
                "service is draining — no new admissions")
        if spec is None:
            spec = MCSpec(**spec_kwargs)
        spec.validate()       # spec errors raise HERE, at admission
        fingerprint = montecarlo_fingerprint(case, spec)
        return self._admit(request_id, fingerprint, priority, deadline_s,
                           kind="montecarlo", mc_case=case, mc_spec=spec,
                           trace_ctx=trace_ctx)

    def submit_portfolio(self, spec, *, request_id=None,
                         priority: int = 0,
                         deadline_s: Optional[float] = None,
                         trace_ctx: Optional[Dict] = None) -> Future:
        """Admit one PORTFOLIO request (coupled-fleet co-optimization):
        solve ``spec``'s member sites as one LP under the shared
        coupling constraints via the dual-decomposed outer loop
        (``dervet_tpu_torch.portfolio``), deliver a
        :class:`~dervet_tpu_torch.portfolio.solve.PortfolioResult` through
        the returned future.  Admission semantics (priority, deadline,
        backpressure, poison blocklist, draining) are identical to
        :meth:`submit`.  The dual loop dispatches through the
        service's persistent solver cache, so repeat portfolios reuse
        its solvers AND the warm-start memory."""
        from ..portfolio.service import portfolio_fingerprint
        if self._draining.is_set():
            raise ServiceClosedError(
                "service is draining — no new admissions")
        spec.validate()       # spec errors raise HERE, at admission
        fingerprint = portfolio_fingerprint(spec)
        return self._admit(request_id, fingerprint, priority, deadline_s,
                           kind="portfolio", portfolio_spec=spec,
                           trace_ctx=trace_ctx)

    def submit_portfolio_shard(self, shard: Dict, *, request_id=None,
                               priority: int = 0,
                               deadline_s: Optional[float] = None,
                               trace_ctx: Optional[Dict] = None) -> Future:
        """Admit one PORTFOLIO SHARD request: a slice of another node's
        dual round (site cases + the round's dual-price vector — see
        ``dervet_tpu_torch.portfolio.shard``), solved against THIS replica's
        persistent solver cache and answered as a
        :class:`~dervet_tpu_torch.portfolio.shard.PortfolioShardResult`.  The
        router keeps shard→replica assignment sticky, so round k+1's
        shard finds the ``dual_iterate`` hints round k stored here."""
        import hashlib
        if self._draining.is_set():
            raise ServiceClosedError(
                "service is draining — no new admissions")
        if not isinstance(shard, dict):
            raise ValueError("a portfolio shard needs a payload dict")
        shard = self._resolve_shard_cases(shard)
        h = hashlib.sha256()
        h.update(str(shard.get("seed_tag")).encode())
        h.update(repr(sorted(str(k) for k in shard["sites"])).encode())
        return self._admit(request_id, h.hexdigest(), priority,
                           deadline_s, kind="portfolio_shard",
                           shard_payload=shard, trace_ctx=trace_ctx)

    def _resolve_shard_cases(self, shard: Dict) -> Dict:
        """Shard case cache admission hook: a FULL payload ("sites"
        present) seeds the ``(seed_tag, plan_fp)`` entry; a REFERENCE
        payload (no "sites", a "plan_fp") resolves against it or raises
        the typed :class:`ShardCacheMissError` so the executor re-sends
        the full payload once.  The returned shard always carries
        resolved sites."""
        sites = shard.get("sites")
        seed_tag = str(shard.get("seed_tag"))
        plan_fp = shard.get("plan_fp")
        if sites:
            if plan_fp:
                key = (seed_tag, str(plan_fp))
                with self._shard_cases_lock:
                    self._shard_cases[key] = sites
                    self._shard_cases.move_to_end(key)
                    while len(self._shard_cases) > self._shard_cases_cap:
                        self._shard_cases.popitem(last=False)
            return shard
        if not plan_fp:
            raise ValueError("a portfolio shard needs a non-empty "
                             "'sites' dict (or a 'plan_fp' reference "
                             "to a previously shipped one)")
        key = (seed_tag, str(plan_fp))
        with self._shard_cases_lock:
            cached = self._shard_cases.get(key)
            if cached is not None:
                self._shard_cases.move_to_end(key)
        if cached is None:
            raise ShardCacheMissError(
                f"shard {seed_tag!r} arrived in reference mode but this "
                f"replica holds no cached site payload for plan "
                f"{str(plan_fp)[:12]!r} — re-dispatch with the full "
                "'sites' payload to re-seed the cache")
        return {**shard, "sites": cached}

    def _admit(self, request_id, fingerprint, priority, deadline_s, *,
               cases=None, kind: str = "scenario", design_case=None,
               design_spec=None, portfolio_spec=None, shard_payload=None,
               mc_case=None, mc_spec=None,
               trace_ctx: Optional[Dict] = None) -> Future:
        """Shared admission tail: backend breaker, poison blocklist,
        id allocation/validation, queue put with typed rejection."""
        if self.breakers.is_open("backend"):
            # the service is alive but cannot currently solve (backend
            # re-init failed): fail fast with the probe schedule instead
            # of queueing work that will die
            raise BreakerOpenError(
                "service backend breaker is open — recent rounds failed "
                "even after re-init; retry after the probe window",
                probe_in_s=self.breakers.get("backend").probe_in_s())
        # poison blocklist: a request whose content fingerprint crashed
        # the dispatch twice is rejected in microseconds here, instead
        # of re-crashing a round it would share with innocents
        diagnosis = self.poison_registry.blocked(fingerprint)
        if diagnosis is not None:
            raise PoisonRequestError(
                f"request {request_id!r} rejected: its content is "
                "quarantined (crashed the dispatch "
                f"{self.poison_registry.threshold} times) — fix the "
                f"inputs before resubmitting", diagnosis=diagnosis)
        with self._seq_lock:
            if request_id is None:
                self._seq += 1
                request_id = f"r{self._seq:06d}"
            if not _REQUEST_ID_RE.match(str(request_id)):
                raise ValueError(
                    f"request id {request_id!r} must match "
                    "[A-Za-z0-9._-]{1,64} — it names checkpoint/"
                    "manifest/health files")
            if str(request_id) in self._active_ids:
                raise ValueError(
                    f"request id {request_id!r} is still in flight — "
                    "wait for its future (or pick a new id) before "
                    "resubmitting")
            self._active_ids.add(str(request_id))
        req = QueuedRequest(request_id, cases if cases is not None else {},
                            priority=priority, deadline_s=deadline_s,
                            kind=kind)
        req.fingerprint = fingerprint
        req.design_case = design_case
        req.design_spec = design_spec
        req.portfolio_spec = portfolio_spec
        req.shard_payload = shard_payload
        req.mc_case = mc_case
        req.mc_spec = mc_spec
        # telemetry: the request's root span on this process — a child
        # of the upstream (router) context when one rode the transport,
        # else a fresh root whose trace id derives from the request id
        # (so cross-process stitching never depends on in-band context)
        req.trace_ctx = trace_ctx
        span = telemetry_trace.start_span(
            "request", parent=trace_ctx, rid=str(request_id),
            attrs={"request_id": str(request_id), "kind": kind,
                   "priority": int(priority)})
        if span:
            req.span = span
            telemetry_trace.register_request(str(request_id), span)
        # capture rid + span only — a closure over the QueuedRequest
        # would pin the full case payload for the future's lifetime
        # (futures keep their callback list after resolution)
        req.future.add_done_callback(
            lambda f, rid=str(request_id), s=span or None:
            self._request_done(rid, s, f))
        try:
            self.queue.put(req)
        except ServiceError as e:
            self._release_id(str(request_id))
            if span:
                telemetry_trace.release_request(str(request_id))
                span.event("admission_rejected",
                           error=type(e).__name__).end(error=e)
            raise
        return req.future

    def _request_done(self, rid: str, span, fut) -> None:
        """Future-resolution callback (added FIRST, at admission, so it
        runs before the serve loop's trace export): free the id and end
        the request's telemetry span with the delivery outcome."""
        self._release_id(rid)
        if span is not None:
            telemetry_trace.release_request(rid)
            try:
                err = fut.exception()
            except Exception:
                err = None
            span.end(error=err)

    def _release_id(self, rid: str) -> None:
        with self._seq_lock:
            self._active_ids.discard(rid)

    def submit_params(self, path, base_path=None, **kwargs) -> Future:
        """Admit a model-parameters FILE (CSV/JSON/XML) as one request —
        the serve-loop front end; parsing errors raise here, at
        admission, not inside the batch."""
        from ..io.params import Params
        cases = Params.initialize(path, base_path=base_path)
        return self.submit(cases, **kwargs)

    def submit_pickle(self, path, **kwargs) -> Future:
        """Admit a fleet-transport request payload: a pickle of
        ``{"cases": {...}, "priority": int, "deadline_epoch": float}``
        (see :meth:`~dervet_tpu_torch.service.fleet.SpoolReplica.
        encode_payload`).  A same-trust-domain transport — the payload
        was written by our own router process on our own host/cluster,
        never by an external client.  The deadline rides as an absolute
        epoch so time spent in transit between router and replica
        counts against it."""
        import pickle
        with open(path, "rb") as f:
            payload = pickle.load(f)
        deadline_epoch = payload.get("deadline_epoch")
        kwargs.setdefault("priority", int(payload.get("priority", 0)))
        if deadline_epoch is not None:
            kwargs.setdefault("deadline_s",
                              max(0.0, float(deadline_epoch) - time.time()))
        # trace context rides the transport payload: the replica-side
        # span tree parents under the router's transport span
        kwargs.setdefault("trace_ctx", payload.get("trace"))
        if payload.get("portfolio_shard") is not None:
            # fleet-sharded portfolio round: one shard of another
            # node's dual loop (dervet_tpu_torch/portfolio/shard.py)
            return self.submit_portfolio_shard(
                payload["portfolio_shard"], **kwargs)
        cases = payload.get("cases")
        if cases is None and payload.get("cases_pickle") is not None:
            # serialize-once client path: the cases dict rides as its
            # own pre-pickled bytes inside the transport record
            cases = pickle.loads(payload["cases_pickle"])
        return self.submit(cases, **kwargs)

    def submit_design_file(self, path, base_path=None, **kwargs) -> Future:
        """Admit a spool ``design.json`` request file (see
        ``design.service.parse_design_request`` for the shape); parse
        errors raise here, at admission."""
        import json
        from ..design.service import parse_design_request
        with open(path) as f:
            payload = json.load(f)
        case, spec = parse_design_request(payload, base_path=base_path)
        return self.submit_design(case, spec, **kwargs)

    def submit_montecarlo_file(self, path, base_path=None,
                               **kwargs) -> Future:
        """Admit a spool ``montecarlo.json`` request file (see
        ``stochastic.service.parse_montecarlo_request`` for the shape);
        parse errors raise here, at admission."""
        import json
        from ..stochastic.service import parse_montecarlo_request
        with open(path) as f:
            payload = json.load(f)
        case, spec = parse_montecarlo_request(payload,
                                              base_path=base_path)
        return self.submit_montecarlo(case, spec, **kwargs)

    def submit_portfolio_file(self, path, base_path=None,
                              **kwargs) -> Future:
        """Admit a spool ``portfolio.json`` request file (see
        ``portfolio.service.parse_portfolio_request`` for the shape);
        parse errors raise here, at admission."""
        import json
        from ..portfolio.service import parse_portfolio_request
        with open(path) as f:
            payload = json.load(f)
        spec = parse_portfolio_request(payload, base_path=base_path)
        return self.submit_portfolio(spec, **kwargs)

    # -- batching loop --------------------------------------------------
    def start(self) -> "ScenarioService":
        """Warm the device and start the batcher thread."""
        if self._started:
            return self
        if self.backend != "cpu":
            from ..parallel import elastic
            from ..parallel.mesh import warmup_devices
            # the CUDA context, the kernels' nvcc build and one
            # bucket-shaped warm solve on every device the elastic
            # scheduler will place groups on (the service's device alone
            # without it), before the batcher thread launches anything
            elastic_devs = elastic.elastic_devices(self.backend, self.device)
            self.device_info = warmup_devices(
                devices=elastic_devs or [self.device])
            TellUser.info(
                f"service: device warm ({self.device_info['n_devices']}x "
                f"{self.device_info['platform']}:"
                f"{self.device_info['device_kind']}, "
                f"warm-up {self.device_info['warmup_total_s']}s)")
        self._started = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dervet-service-batcher")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._draining.is_set():
            try:
                self.run_once(block=True, timeout=0.5)
            except PreemptedError:
                break            # drain signal landed mid-round
            except Exception as e:   # a round crash must not kill serving
                TellUser.error(f"service: batch round errored: {e}")
        self._fail_pending()

    def run_once(self, block: bool = False,
                 timeout: Optional[float] = None) -> int:
        """Run one batch cycle synchronously; returns the number of
        requests served.  The manual drive used by tests and by callers
        embedding the service without the batcher thread.

        Under SUSTAINED overload (queue pressure / deadline misses for
        ``shed_sustain_rounds`` consecutive cycles) the cycle splits in
        two rounds: low-priority requests are answered by the DEGRADED
        tier first (loose-tolerance short-budget screening solve, its
        own solver cache, certification off, results explicitly marked)
        and the rest get the normal certified round — explicit
        degradation instead of rejection or silent death."""
        requests = self.queue.take(max_batch=self.max_batch_requests,
                                   max_wait_s=self.max_wait_s,
                                   block=block, timeout=timeout)
        if not requests:
            return 0
        shed = False
        if self.shedder is not None:
            depth_at_start = self.queue.depth() + len(requests)
            shed = self.shedder.observe(depth_at_start,
                                        self.queue.max_depth,
                                        self.queue.counters["expired"])
        if shed:
            certified, degraded = self.shedder.partition(requests)
            if degraded:
                TellUser.warning(
                    f"service: overload sustained — shedding "
                    f"{len(degraded)} low-priority request(s) to the "
                    "degraded screening tier "
                    f"({len(certified)} stay certified)")
        else:
            certified, degraded = requests, []
        # design requests take the BOOST path: their populations screen
        # NOW (one DesignRound, the service's persistent per-tier caches)
        # and the survivors' finalist cases join the certified round
        # below, co-batching with ordinary scenario requests.  A design
        # request the shedder picked is answered from the screen alone
        # (degraded frontier) — it never reaches the certified round.
        design_shed_ids = {r.request_id for r in degraded
                           if r.kind == "design"}
        design_reqs = [r for r in certified + degraded
                       if r.kind == "design"]
        certified = [r for r in certified if r.kind != "design"]
        degraded = [r for r in degraded if r.kind != "design"]
        # monte-carlo requests run their own round (the engine drives
        # both tiers' dispatches itself); a load-SHED MC request runs
        # the screening tier only over a reduced sample count and is
        # answered degraded — never certificate-stamped
        mc_shed_ids = {r.request_id for r in degraded
                       if r.kind == "montecarlo"}
        mc_reqs = [r for r in certified + degraded
                   if r.kind == "montecarlo"]
        certified = [r for r in certified if r.kind != "montecarlo"]
        degraded = [r for r in degraded if r.kind != "montecarlo"]
        # portfolio requests run their own dual-loop round against the
        # service's persistent caches; a load-SHED portfolio runs the
        # degraded tier (screening inner solves, certification off,
        # answer marked — never certificate-stamped)
        portfolio_shed_ids = {r.request_id for r in degraded
                              if r.kind == "portfolio"}
        portfolio_reqs = [r for r in certified + degraded
                          if r.kind == "portfolio"]
        certified = [r for r in certified if r.kind != "portfolio"]
        degraded = [r for r in degraded if r.kind != "portfolio"]
        # portfolio SHARD requests (one slice of another node's dual
        # round): latency-critical sub-steps of a loop already in
        # flight elsewhere — served first, never shed (the owning
        # loop's degraded decision was made at ITS admission)
        shard_reqs = [r for r in certified + degraded
                      if r.kind == "portfolio_shard"]
        certified = [r for r in certified if r.kind != "portfolio_shard"]
        degraded = [r for r in degraded if r.kind != "portfolio_shard"]
        served = 0
        if shard_reqs:
            from ..portfolio.shard import PortfolioShardRound
            sr = PortfolioShardRound(shard_reqs, backend=self.backend,
                                     solver_opts=self.solver_opts,
                                     solver_cache=self.solver_cache,
                                     supervisor=self.supervisor,
                                     board=self.breakers,
                                     device=self.device)
            try:
                sr.run()
            except BaseException as e:
                for req in portfolio_reqs + design_reqs + mc_reqs \
                        + degraded + certified:
                    if not req.future.done():
                        req.future.set_exception(ServiceClosedError(
                            f"request {req.request_id!r} not "
                            "dispatched: the portfolio shard round "
                            f"failed ({e}) — resubmit"))
                        with self._metrics_lock:
                            self._requests["failed"] += 1
                self._absorb_shard_stats(sr)
                raise
            self._absorb_shard_stats(sr)
            served += len(sr.answered)
        if portfolio_reqs:
            from ..portfolio.service import PortfolioRound
            pr = PortfolioRound(portfolio_reqs, backend=self.backend,
                                solver_opts=self.solver_opts,
                                solver_cache=self.solver_cache,
                                degraded_cache=self.degraded_cache,
                                degraded_ids=portfolio_shed_ids,
                                supervisor=self.supervisor,
                                board=self.breakers,
                                device=self.device)
            try:
                pr.run()
            except BaseException as e:
                # the portfolio round answers its own requests (incl.
                # preemption); every OTHER request this cycle already
                # popped from the queue must be answered here or its
                # client hangs forever
                for req in design_reqs + mc_reqs + degraded + certified:
                    if not req.future.done():
                        req.future.set_exception(ServiceClosedError(
                            f"request {req.request_id!r} not "
                            "dispatched: the portfolio round failed "
                            f"({e}) — resubmit"))
                        with self._metrics_lock:
                            self._requests["failed"] += 1
                self._absorb_portfolio_stats(pr)
                raise
            self._absorb_portfolio_stats(pr)
            served += len(pr.answered)
        if design_reqs:
            from ..design.service import DesignRound
            dr = DesignRound(design_reqs, backend=self.backend,
                             solver_opts=self.solver_opts,
                             caches=self.design_caches,
                             degraded_ids=design_shed_ids,
                             supervisor=self.supervisor,
                             device=self.device)
            try:
                dr.run()
            except BaseException as e:
                # the screening phase answers its own requests (incl.
                # preemption); every OTHER request this cycle already
                # popped from the queue must be answered here or its
                # client hangs forever
                for req in design_reqs + mc_reqs + degraded + certified:
                    if not req.future.done():
                        req.future.set_exception(ServiceClosedError(
                            f"request {req.request_id!r} not dispatched: "
                            "the design screening phase failed "
                            f"({e}) — resubmit"))
                        with self._metrics_lock:
                            self._requests["failed"] += 1
                self._absorb_design_stats(dr)
                raise
            self._absorb_design_stats(dr)
            served += len(dr.answered)
            certified = certified + dr.finalist_requests
        if mc_reqs:
            from ..stochastic.service import MonteCarloRound
            mr = MonteCarloRound(mc_reqs, backend=self.backend,
                                 solver_opts=self.solver_opts,
                                 caches=self.design_caches,
                                 final_cache=self.solver_cache,
                                 degraded_ids=mc_shed_ids,
                                 supervisor=self.supervisor,
                                 device=self.device)
            try:
                mr.run()
            except BaseException as e:
                # the MC round answers its own requests (incl.
                # preemption); the scenario tiers below were already
                # popped from the queue and must be answered here or
                # their clients hang forever
                for req in mc_reqs + degraded + certified:
                    if not req.future.done():
                        req.future.set_exception(ServiceClosedError(
                            f"request {req.request_id!r} not "
                            "dispatched: the monte-carlo round failed "
                            f"({e}) — resubmit"))
                        with self._metrics_lock:
                            self._requests["failed"] += 1
                self._absorb_mc_stats(mr)
                raise
            self._absorb_mc_stats(mr)
            served += len(mr.answered)
        tiers = [(reqs, is_degraded)
                 for reqs, is_degraded in ((degraded, True),
                                           (certified, False)) if reqs]
        for t_idx, (reqs, is_degraded) in enumerate(tiers):
            rnd = BatchRound(
                reqs, backend=self.backend,
                solver_opts=self.solver_opts,
                # the degraded tier's compiled screening solvers must
                # never leak into a certified round (shared structure
                # keys, different budgets) — separate cache
                solver_cache=(self.degraded_cache if is_degraded
                              else self.solver_cache),
                supervisor=self.supervisor,
                checkpoint_dir=self.checkpoint_dir,
                on_stats=self._absorb_round_stats,
                gc_checkpoints=self.gc_checkpoints,
                board=self.breakers, recovery=self.recovery,
                poison_registry=self.poison_registry,
                degraded=is_degraded, device=self.device)
            try:
                rnd.run()
            except BaseException as e:
                # the raising round answered ITS OWN requests, but any
                # LATER tier was already popped from the queue — its
                # futures must be answered here or clients blocked on
                # them hang forever (neither a round nor _fail_pending
                # would ever see them again)
                for later_reqs, _ in tiers[t_idx + 1:]:
                    for req in later_reqs:
                        if not req.future.done():
                            req.future.set_exception(ServiceClosedError(
                                f"request {req.request_id!r} not "
                                "dispatched: an earlier round of this "
                                f"batch cycle failed ({e}) — resubmit"))
                            with self._metrics_lock:
                                self._requests["failed"] += 1
                if not isinstance(e, PreemptedError):
                    # a round that died even after backend recovery +
                    # poison isolation: hard evidence against
                    # the backend breaker (admissions fail fast when it
                    # trips), then propagate for the loop to log
                    self.breakers.record("backend", False)
                self._absorb_request_outcomes(rnd)
                raise
            else:
                if rnd.requests:
                    self.breakers.record("backend", True)
                self._absorb_request_outcomes(rnd)
            served += len(rnd.requests)
        return served

    def _absorb_design_stats(self, dr) -> None:
        """Design screening bookkeeping: screening-load counters (kept
        separate from scenario round counters so the two workloads are
        distinguishable in ``metrics()``), plus request accounting for
        the design requests the screening phase answered itself
        (degraded frontiers, screen failures, expiries)."""
        st = dr.stats
        with self._metrics_lock:
            self._design["requests"] += int(st.get("requests", 0))
            self._design["candidates"] += int(st.get("candidates", 0))
            self._design["screen_rounds"] += int(st.get("screen_rounds",
                                                        0))
            self._design["screen_s"] += float(st.get("screen_s", 0.0))
            self._design["finalists"] += int(st.get("finalists", 0))
            self._design["degraded_answers"] += int(st.get("degraded", 0))
            self._design["screen_dispatches"] += int(
                st.get("dispatches", 0))
            self._design["screen_compile_events"] += int(
                st.get("compile_events", 0))
            for req in dr.answered:
                fut = req.future
                if fut.done() and fut.exception() is None:
                    self._requests["completed"] += 1
                    self._latencies.append(
                        time.monotonic() - req.t_submit)
                    self._note_request_telemetry(req, True)
                elif fut.done():
                    self._requests["failed"] += 1
                    self._note_request_telemetry(req, False)
        if dr.last_screen is not None:
            self.last_screen_stats = dr.last_screen

    def _absorb_mc_stats(self, mr) -> None:
        """Monte-carlo round bookkeeping + request accounting (the round
        answers every future itself)."""
        st = mr.stats
        with self._metrics_lock:
            self._montecarlo["requests"] += int(st.get("requests", 0))
            self._montecarlo["samples"] += int(st.get("samples", 0))
            self._montecarlo["certified_samples"] += int(
                st.get("certified_samples", 0))
            self._montecarlo["quarantined"] += int(
                st.get("quarantined", 0))
            self._montecarlo["degraded_answers"] += int(
                st.get("degraded", 0))
            self._montecarlo["mc_s"] += float(st.get("mc_s", 0.0))
            self._montecarlo["dispatches"] += int(st.get("dispatches", 0))
            self._montecarlo["compile_events"] += int(
                st.get("compile_events", 0))
            for req in mr.answered:
                fut = req.future
                if fut.done() and fut.exception() is None:
                    self._requests["completed"] += 1
                    self._latencies.append(
                        time.monotonic() - req.t_submit)
                    self._note_request_telemetry(req, True)
                elif fut.done():
                    self._requests["failed"] += 1
                    self._note_request_telemetry(req, False)
        if mr.last_mc is not None:
            self.last_mc_stats = mr.last_mc

    def _absorb_shard_stats(self, sr) -> None:
        """Portfolio-shard-round bookkeeping + request accounting (the
        round answers every future itself)."""
        st = sr.stats
        with self._metrics_lock:
            for k in ("shard_requests", "shard_windows", "shard_failed"):
                self._portfolio[k] += int(st.get(k, 0))
            self._portfolio["shard_s"] += float(st.get("shard_s", 0.0))
            for req in sr.answered:
                fut = req.future
                if fut.done() and fut.exception() is None:
                    self._requests["completed"] += 1
                    self._latencies.append(
                        time.monotonic() - req.t_submit)
                    self._note_request_telemetry(req, True)
                elif fut.done():
                    self._requests["failed"] += 1
                    self._note_request_telemetry(req, False)

    def _absorb_portfolio_stats(self, pr) -> None:
        """Portfolio-round bookkeeping + request accounting (the round
        answers every future itself)."""
        st = pr.stats
        with self._metrics_lock:
            for k in ("requests", "outer_rounds", "windows",
                      "dual_iterate_seeds", "infeasible", "failed"):
                self._portfolio[k] += int(st.get(k, 0))
            self._portfolio["degraded_answers"] += int(
                st.get("degraded", 0))
            self._portfolio["portfolio_s"] += float(
                st.get("portfolio_s", 0.0))
            for req in pr.answered:
                fut = req.future
                if fut.done() and fut.exception() is None:
                    self._requests["completed"] += 1
                    self._latencies.append(
                        time.monotonic() - req.t_submit)
                    self._note_request_telemetry(req, True)
                elif fut.done():
                    self._requests["failed"] += 1
                    self._note_request_telemetry(req, False)
        if pr.last_portfolio is not None:
            self.last_portfolio = pr.last_portfolio

    def _absorb_round_stats(self, rnd: BatchRound) -> None:
        """Round-level bookkeeping, fired by the batcher BEFORE any
        request future resolves — so metrics()/last_round_ledger are
        current the moment a client wakes on its result."""
        st = rnd.stats
        with self._metrics_lock:
            self._rounds["count"] += 1
            if rnd.preempted:
                self._rounds["preempted"] += 1
            if rnd.degraded:
                self._rounds["degraded_rounds"] += 1
            for k in ("requests", "cases", "windows", "device_groups",
                      "cross_request_groups", "compile_events",
                      "seeded_windows", "substituted_windows"):
                self._rounds[k] += int(st.get(k, 0))
            self._rounds["batch_sum"] += float(
                st.get("mean_batch", 0.0)) * int(st.get("device_groups", 0))
            self._rounds["round_s"] += float(st.get("round_s", 0.0))
            el = st.get("elastic")
            if el:
                self._elastic["rounds"] += 1
                self._elastic["steals"] += int(el.get("steals", 0))
                mo = el.get("min_occupancy")
                if mo is not None:
                    prev = self._elastic["min_occupancy"]
                    self._elastic["min_occupancy"] = (
                        mo if prev is None else min(prev, mo))
        if rnd.ledger is not None:
            self.last_round_ledger = rnd.ledger
        self._telemetry_round(
            st, rnd.ledger,
            {(rid, key): getattr(s, "certification", None)
             for rid, scens in rnd.scenarios.items()
             for key, s in scens.items()})
        if st.get("round_s"):
            # the backpressure retry-after hint derives from the
            # OBSERVED drain rate: feed the queue this round's sample
            self.queue.note_round(int(st.get("requests", 0)),
                                  float(st["round_s"]))
        # bound the structure cache: a service fed unbounded distinct
        # structures must not grow device/host memory forever — clearing
        # trades a re-precondition for boundedness (same policy as the
        # structure-key memo)
        if self.solver_cache.structures_cached() > \
                self.max_cached_structures:
            TellUser.warning(
                f"service: solver cache at "
                f"{self.solver_cache.structures_cached()} structures "
                f"(bound {self.max_cached_structures}) — clearing")
            self.solver_cache.clear()

    def _telemetry_round(self, st: Dict, ledger: Optional[Dict],
                         cert_by_case: Optional[Dict] = None) -> None:
        """Feed the round's observables into the process metrics
        registry (dervet_tpu_torch/telemetry) — the numbers already exist in
        the stats/ledger; this just makes them survive as time series
        and cross-replica-mergeable histograms.  No-op under the
        telemetry kill switch."""
        if not telemetry_registry.enabled():
            return
        reg = telemetry_registry.get_registry()
        reg.counter("dervet_rounds_total").inc()
        reg.counter(telemetry_ops.M_WINDOWS).inc(
            int(st.get("windows", 0)))
        reg.counter("dervet_compile_events_total").inc(
            int(st.get("compile_events", 0)))
        el = st.get("elastic")
        if el:
            reg.counter(telemetry_ops.M_STEALS).inc(
                int(el.get("steals", 0)))
        warm = (ledger or {}).get("warm_start")
        if warm:
            for grade in ("exact", "near", "predicted", "dual_iterate",
                          "cold"):
                n = int(warm.get(grade, 0))
                if n:
                    reg.counter(telemetry_ops.M_WARM,
                                grade=grade).inc(n)
        accepted = rejected = 0
        for cert in (cert_by_case or {}).values():
            if not cert or not cert.get("enabled"):
                continue
            accepted += (int(cert.get("certified", 0))
                         + int(cert.get("certified_loose", 0)))
            rejected += int(cert.get("rejected", 0))
        if accepted:
            reg.counter(telemetry_ops.M_CERT, verdict="accepted").inc(
                accepted)
        if rejected:
            reg.counter(telemetry_ops.M_CERT, verdict="rejected").inc(
                rejected)
        reg.gauge(telemetry_ops.M_QUEUE_DEPTH).set(self.queue.depth())
        reg.gauge(telemetry_ops.M_DRAIN_RATE).set(
            self.queue.drain_rate() or 0.0)

    def _note_request_telemetry(self, req, ok: bool) -> None:
        """Per-delivery registry counters (caller may hold the metrics
        lock; the registry has its own)."""
        if not telemetry_registry.enabled():
            return
        reg = telemetry_registry.get_registry()
        reg.counter(telemetry_ops.M_REQUESTS,
                    outcome=("completed" if ok else "failed")).inc()
        if ok:
            reg.histogram(telemetry_ops.M_REQ_LATENCY).observe(
                time.monotonic() - req.t_submit)

    def _absorb_request_outcomes(self, rnd: BatchRound) -> None:
        """Per-request accounting after delivery — including requests
        answered during batch assembly (expiry, duplicate id, assembly
        failure), so admitted == completed + failed + pending always
        reconciles."""
        with self._metrics_lock:
            for req in list(rnd.requests) + list(rnd.answered_early):
                fut = req.future
                if fut.done() and fut.exception() is None:
                    self._requests["completed"] += 1
                    self._latencies.append(
                        time.monotonic() - req.t_submit)
                    self._note_request_telemetry(req, True)
                elif fut.done():
                    self._requests["failed"] += 1
                    self._note_request_telemetry(req, False)

    # -- shutdown -------------------------------------------------------
    def _fail_pending(self) -> None:
        """Answer everything still queued with the typed draining error
        (they never started; there is nothing to resume)."""
        self.queue.close()
        for req in self.queue.drain_pending():
            if not req.future.done():
                req.future.set_exception(ServiceClosedError(
                    f"request {req.request_id!r} not started before "
                    "service drain — resubmit to a live service"))

    def request_stop(self, signum=None) -> None:
        """Programmatic drain trigger (what SIGTERM does in the serve
        loop): admissions close immediately, the in-flight round finishes
        or checkpoints, queued requests are answered as not-started."""
        self.supervisor.request_stop(signum)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Stop admissions and wait for the batcher to go quiet.  Waits
        for the in-flight round by default — abandoning it would break
        the resumable-drain contract (futures unanswered, manifests
        unflushed); a second SIGTERM is the documented escape hatch.
        With a ``timeout``, a still-running round is reported loudly and
        the thread handle kept so a later drain can finish the job."""
        self.request_stop()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                TellUser.warning(
                    f"service: batcher still mid-round after {timeout:g}s "
                    "drain timeout — in-flight requests are NOT yet "
                    "answered; drain again (or send a second signal to "
                    "abort)")
                return
            self._thread = None
        else:
            self._fail_pending()

    def close(self) -> None:
        self.drain()

    def __enter__(self) -> "ScenarioService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- observability --------------------------------------------------
    def request_counters(self) -> Dict:
        """Cheap request counters for the replica heartbeat (the full
        :meth:`metrics` walks percentile arrays — too heavy to run every
        heartbeat tick)."""
        with self._metrics_lock:
            return {"completed": self._requests["completed"],
                    "failed": self._requests["failed"]}

    def _peak_memory(self) -> Optional[int]:
        """The caching allocator's peak on this service's CUDA device
        since the process started (None off the card)."""
        dev = self.device
        if dev is None or getattr(dev, "type", None) != "cuda":
            return None
        import torch
        return int(torch.cuda.max_memory_allocated(dev))

    def metrics(self) -> Dict:
        """Service-level metrics: queue depth/rejects, request counts,
        latency percentiles, batch occupancy, compile-cache hits."""
        with self._metrics_lock:
            lat = np.asarray(self._latencies, dtype=float)
            rounds = dict(self._rounds)
            requests = dict(self._requests)
            design = dict(self._design)
            portfolio = dict(self._portfolio)
            montecarlo = dict(self._montecarlo)
            elastic = dict(self._elastic)
        design["screen_s"] = round(design["screen_s"], 3)
        design["screen_candidates_per_s"] = round(
            design["candidates"] / design["screen_s"], 2) \
            if design["screen_s"] else None
        design["caches"] = self.design_caches.snapshot()
        montecarlo["mc_s"] = round(montecarlo["mc_s"], 3)
        montecarlo["samples_per_s"] = round(
            montecarlo["samples"] / montecarlo["mc_s"], 2) \
            if montecarlo["mc_s"] else None
        groups = rounds.pop("batch_sum"), rounds["device_groups"]
        cache = self.solver_cache
        lookups = cache.builds + cache.hits
        return {
            "queue": {"depth": self.queue.depth(),
                      "max_depth": self.queue.max_depth,
                      "closed": self.queue.closed,
                      **self.queue.counters},
            "requests": {**requests,
                         "pending": self.queue.depth()},
            "rounds": rounds,
            # design-service load, separate from scenario rounds so the
            # two request types are distinguishable under pressure
            "design": design,
            # portfolio co-optimization load (dervet_tpu_torch/portfolio):
            # request/round counters plus the last dual loop's full
            # observability section (gap, per-round seeding, cert)
            "portfolio": {**{k: (round(v, 3)
                                 if k in ("portfolio_s", "shard_s")
                                 else v)
                             for k, v in portfolio.items()},
                          "last": self.last_portfolio},
            # monte-carlo uncertainty valuations (dervet_tpu_torch/stochastic):
            # sample volume, tier mix, and the last run's per-round
            # dispatch stats (the zero-compile warm observable)
            "monte_carlo": {**montecarlo, "last": self.last_mc_stats},
            "batch_occupancy": {
                "mean_windows_per_device_batch":
                    round(groups[0] / groups[1], 2) if groups[1] else 0.0,
                "cross_request_groups": rounds["cross_request_groups"],
            },
            "latency_s": {
                "n": int(lat.size),
                "p50": round(float(np.percentile(lat, 50)), 4)
                if lat.size else None,
                "p99": round(float(np.percentile(lat, 99)), 4)
                if lat.size else None,
                "max": round(float(lat.max()), 4) if lat.size else None,
            },
            "compile_cache": {
                "solver_builds": cache.builds,
                "solver_hits": cache.hits,
                "hit_rate": round(cache.hits / lookups, 4)
                if lookups else None,
                "structures_cached": cache.structures_cached(),
                "compile_events_total": rounds["compile_events"],
            },
            # warm-start solution memory (ops/warmstart.py): entry
            # counts, hit grades (incl. the learned-predictor grade),
            # substitutions, stale-seed drills, predictor model stats
            "warm_start": (cache.memory.snapshot()
                           if cache.memory is not None else None),
            # solver core (ops/pdhg.py variants + adaptive cadence):
            # the last round's variant mix, restart/anchor-reset volume,
            # and realized check cadence — the per-group detail lives in
            # the round ledger's entries
            "solver_core": (self.last_round_ledger or {}
                            ).get("solver_core"),
            "service": {"backend": self.backend,
                        "started": self._started,
                        "draining": self._draining.is_set(),
                        "device": self.device_info,
                        "peak_memory_bytes": self._peak_memory()},
            # multi-device elastic scheduler (parallel/elastic.py):
            # round/steal counts plus the last round's per-device slice
            "elastic": {**elastic,
                        "last_round": (self.last_round_ledger or {}
                                       ).get("elastic")},
            # self-healing layer: breaker states, shed/degraded counts,
            # backend-loss recovery counters, poison quarantine
            "resilience": {
                "breakers": self.breakers.snapshot(),
                "load_shedding": (self.shedder.snapshot()
                                  if self.shedder is not None else None),
                "backend_recovery": self.recovery.snapshot(),
                "poison_quarantine": self.poison_registry.snapshot(),
            },
        }


# ---------------------------------------------------------------------------
# `python -m dervet_tpu_torch serve`: the file-spool serving loop
# ---------------------------------------------------------------------------

def serve_main(argv=None) -> int:
    """CLI loop: watch ``SPOOL/incoming/`` for model-parameter files,
    serve each as a request, write results to ``SPOOL/results/<rid>/``.
    SIGTERM/SIGINT drains gracefully and exits 0 (resumable per-request
    manifests under ``--checkpoint-dir``); a second signal aborts.  A
    request lost with the backend (a sticky device fault past the re-init
    budget) stops the loop: no drain, no terminal marker for the
    unanswered requests, exit :data:`EXIT_BACKEND_LOST` — a replica's
    death for the fleet router to fail over and the supervisor to
    respawn."""
    import argparse
    import json
    import os
    import sys

    from ..utils.supervisor import atomic_write

    parser = argparse.ArgumentParser(
        prog="dervet_tpu_torch serve",
        description="persistent scenario service: cross-request "
                    "continuous batching over a file spool")
    parser.add_argument("spool_dir",
                        help="spool root (incoming/, results/, done/, "
                             "failed/ are created under it)")
    parser.add_argument("--backend", default="torch",
                        choices=["torch", "cpu"],
                        help="dispatch backend for every request "
                             "(default torch — a hot service amortizes "
                             "the solver builds the auto heuristic "
                             "exists to avoid)")
    parser.add_argument("--device", default=None,
                        help="device of the torch backend (default: the "
                             "first GPU, and no GPU is an error; 'cpu' "
                             "runs the kernels' plain versions)")
    parser.add_argument("--base-path", default=None,
                        help="root for relative referenced-data paths")
    parser.add_argument("--max-queue-depth", type=int, default=64)
    parser.add_argument("--max-wait-ms", type=float, default=250.0,
                        help="continuous-batching window: how long a "
                             "round holds for stragglers to coalesce")
    parser.add_argument("--max-batch-requests", type=int, default=32)
    parser.add_argument("--poll-s", type=float, default=0.5,
                        help="incoming-directory scan interval")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="resume checkpoints + per-request manifests "
                             "(default: SPOOL/checkpoints)")
    parser.add_argument("--once", action="store_true",
                        help="serve the files already in incoming/, "
                             "then drain and exit (smoke/CI mode)")
    # fleet-replica surface (service/fleet.py + router.py): heartbeats,
    # probe echo, hedge-cancel markers, warm-start memory handoff
    parser.add_argument("--heartbeat-s", type=float, default=0.5,
                        help="rewrite heartbeat.json at this cadence "
                             "(the fleet router's liveness signal; "
                             "0 disables)")
    parser.add_argument("--replica-name", default=None,
                        help="name this replica reports in heartbeats")
    parser.add_argument("--heartbeat-epoch", type=int, default=None,
                        help="incarnation epoch stamped into every "
                             "heartbeat (the lifecycle supervisor bumps "
                             "it on each respawn, so the router can "
                             "tell a replacement's beats from a fenced "
                             "zombie's late writes over the same spool)")
    parser.add_argument("--memory-export-s", type=float, default=2.0,
                        help="publish the warm-start memory export at "
                             "this cadence when it changed (failover "
                             "handoff; 0 disables)")
    parser.add_argument("--telemetry-port", type=int, default=0,
                        help="also serve the Prometheus exposition on "
                             "localhost:<port>/metrics (0 = file "
                             "exposition only)")
    args = parser.parse_args(argv)

    # the device first: without a GPU (and no --device cpu) this raises
    # before the spool is touched or anything is admitted
    if args.backend != "cpu":
        from ..device import resolve_device
        resolve_device(args.device)
    from . import fleet as fleet_mod

    spool = Path(args.spool_dir)
    incoming = spool / "incoming"
    results_root = spool / "results"
    done_dir = spool / "done"
    failed_dir = spool / "failed"
    cancel_dir = spool / fleet_mod.CANCEL_DIR
    memory_in = spool / fleet_mod.MEMORY_IN_DIR
    for d in (incoming, results_root, done_dir, failed_dir, cancel_dir,
              memory_in):
        d.mkdir(parents=True, exist_ok=True)

    # crash-safe journal: every admission/completion is an fsync'd
    # append, so a HARD kill (SIGKILL — no drain path) loses nothing:
    # the restarted loop replays the journal, re-serves unanswered
    # requests idempotently, and finishes interrupted file moves
    from .journal import ServiceJournal
    journal = ServiceJournal(spool / "service_journal.jsonl")
    journal.recover_spool(incoming, done_dir, failed_dir)

    service = ScenarioService(
        backend=args.backend, device=args.device,
        max_queue_depth=args.max_queue_depth,
        max_wait_s=args.max_wait_ms / 1000.0,
        max_batch_requests=args.max_batch_requests,
        checkpoint_dir=args.checkpoint_dir or spool / "checkpoints")
    service.start()
    if args.telemetry_port and telemetry_registry.enabled():
        port = telemetry_registry.get_registry().serve_http(
            args.telemetry_port)
        TellUser.info(f"serve: telemetry exposition on "
                      f"http://127.0.0.1:{port}/metrics")
    pending: Dict[str, Future] = {}
    # set (on the batcher thread) when a request fails because the
    # backend is gone for good: the loop then stops admitting, leaves
    # every unanswered request "admitted" and exits EXIT_BACKEND_LOST
    backend_lost = threading.Event()

    # -- fleet-replica machinery (no-ops for a solo serve loop) ---------
    import pickle

    from ..utils import faultinject

    admissions = 0              # spool admissions this process has made
    hb_state = {"last": 0.0, "mem_last": 0.0, "mem_stores": -1}

    def write_heartbeat() -> None:
        """Liveness signal for the fleet router: rewritten atomically on
        the SCAN thread, so it keeps beating while the batcher solves —
        a wedged scan loop (or a dead process) is exactly what stops it.
        Echoes the router's probe nonce (breaker half-open probes cost a
        file read, not a solve)."""
        nonce = probe_trace = None
        try:
            probe_doc = json.loads(
                (spool / fleet_mod.PROBE_FILE).read_text())
            nonce = probe_doc.get("nonce")
            # echo the router's probe telemetry context verbatim: the
            # probe span's round-trip closes on the router side when
            # this heartbeat lands (trace context rides the echo)
            probe_trace = probe_doc.get("trace")
        except (OSError, ValueError):
            pass
        mem = service.solver_cache.memory
        atomic_write(spool / fleet_mod.HEARTBEAT_FILE, json.dumps({
            "t": round(time.time(), 3),
            "pid": os.getpid(),
            "name": args.replica_name,
            # incarnation fence: a respawned replacement beats with a
            # HIGHER epoch, so the router can refuse a SIGKILL-survivor
            # zombie's stale writes over the shared spool
            **({"epoch": int(args.heartbeat_epoch)}
               if args.heartbeat_epoch is not None else {}),
            "draining": service.supervisor.stop_requested(),
            "pending": len(pending),
            "queue_depth": service.queue.depth(),
            **service.request_counters(),
            # lock-free approximate reads on purpose: structures_cached
            # wants the solver-cache lock, which get() holds through a
            # multi-second preconditioning build — a heartbeat that
            # blocks on a cold round reads as a dead replica
            "structures": len(service.solver_cache.solvers),
            "memory_entries": (len(mem._entries)
                               if mem is not None else 0),
            "probe_nonce": nonce,
            **({"probe_trace": probe_trace} if probe_trace else {}),
        }))

    def write_telemetry() -> None:
        """Publish the metrics-registry exposition next to the heartbeat
        (``telemetry.prom``, atomic) — the load signal the fleet router
        scrapes so routing follows PUBLISHED queue depth + drain rate
        instead of router-side inflight guesses.  Gated on the kill
        switch: with telemetry off, no file is ever written."""
        if not telemetry_registry.enabled():
            return
        reg = telemetry_registry.get_registry()
        reg.gauge(telemetry_ops.M_QUEUE_DEPTH).set(service.queue.depth())
        reg.gauge(telemetry_ops.M_DRAIN_RATE).set(
            service.queue.drain_rate() or 0.0)
        reg.gauge(telemetry_ops.M_PENDING).set(len(pending))
        for bname, snap in service.breakers.snapshot().items():
            reg.gauge(telemetry_ops.M_BREAKER_OPEN, breaker=bname).set(
                1.0 if snap.get("state") == "open" else 0.0)
        reg.sample()            # ring-buffer time-series tick
        reg.write_prom(spool / telemetry_ops.PROM_FILE)

    def sync_memory() -> None:
        """Warm-start memory handoff, both directions: install exports
        the router dropped into ``memory_in/`` (a dead sibling's
        converged iterates — imported exact-only, so the failover
        re-solve ships verbatim bytes or runs cold, never a bit-shifting
        near seed), and publish this replica's own export when it
        changed since the last publish."""
        mem = service.solver_cache.memory
        if mem is None:
            return
        for f in sorted(memory_in.glob("*.pkl")):
            try:
                n = mem.import_payload(pickle.loads(f.read_bytes()))
                TellUser.info(f"serve: imported {n} warm-start entr"
                              f"{'y' if n == 1 else 'ies'} from "
                              f"{f.name} (exact-only, + seed models)")
            except Exception as e:
                TellUser.warning(
                    f"serve: warm-start import {f.name} unreadable "
                    f"({e}) — discarded")
            f.unlink(missing_ok=True)
        now = time.monotonic()
        if args.memory_export_s and \
                now - hb_state["mem_last"] >= args.memory_export_s:
            hb_state["mem_last"] = now
            stores = mem.snapshot()["stores"]
            if stores != hb_state["mem_stores"]:
                hb_state["mem_stores"] = stores
                atomic_write(spool / fleet_mod.MEMORY_EXPORT_FILE,
                             pickle.dumps(
                                 mem.export_payload(),
                                 protocol=pickle.HIGHEST_PROTOCOL))

    def replica_tick() -> None:
        nonlocal admissions
        # replica_hang drill: the sleep lands HERE, on the heartbeat
        # thread — the process stays alive, heartbeats stop
        faultinject.maybe_replica_hang(admissions)
        now = time.monotonic()
        if args.heartbeat_s and \
                now - hb_state["last"] >= args.heartbeat_s:
            hb_state["last"] = now
            write_heartbeat()
            write_telemetry()
        sync_memory()

    def _error_payload(err: BaseException) -> dict:
        """Uniform machine-readable error record (the typed-error
        family's as_dict; non-typed errors get the same shape)."""
        from ..utils.errors import TypedError
        if isinstance(err, TypedError):
            return err.as_dict()
        return {"error": type(err).__name__, "kind": "error",
                "message": str(err), "retry_hint": None}

    def _export_traces(rid: str) -> None:
        """Per-request trace export into the spool results dir: the span
        tree as ``trace.<rid>.json`` plus the Chrome trace-event
        timeline.  Gated on the kill switch — with telemetry off this
        writes NOTHING (the zero-telemetry-files contract)."""
        if not telemetry_trace.enabled():
            return
        try:
            telemetry_trace.export_request_trace(
                rid, results_root / rid, chrome=True)
        except Exception as e:      # observability must never block
            TellUser.warning(f"serve: trace export for {rid} failed: "
                             f"{e}")

    def _finish(path: Path, rid: str, fut: Future) -> None:
        """Done-callback: persist the request's outputs (or its error),
        journal the outcome, then move the input file out of incoming/
        — in THAT order, so a hard kill at any point either re-serves
        idempotently or replays only the file move (see journal.py)."""
        try:
            err = fut.exception()
            if err is not None and (isinstance(err, BackendLostError)
                                    or resilience.is_backend_loss(err)):
                # no terminal marker and no journal record: the request
                # stays admitted and its input stays in incoming/, for
                # the fleet router's exactly-once failover to re-route
                backend_lost.set()
                service.request_stop()
                TellUser.error(f"serve: request {rid} lost with the "
                               f"backend ({err}) — exiting")
                return
            if err is None:
                res = fut.result()
                res.save_as_csv(results_root / rid)
                if res.fidelity != "certified":
                    # the degraded-answer contract: the mark must be
                    # visible in the spool output, not only in-process
                    atomic_write(results_root / rid / "fidelity.json",
                                 json.dumps({
                                     "fidelity": res.fidelity,
                                     "resubmit_hint": res.resubmit_hint,
                                 }, indent=2))
                _export_traces(rid)
                journal.completed(rid, trace_id=telemetry_trace
                                  .trace_id_for(rid)
                                  if telemetry_trace.enabled() else None)
                path.replace(done_dir / path.name)
                TellUser.info(f"serve: request {rid} done -> "
                              f"{results_root / rid}")
            else:
                payload = _error_payload(err)
                atomic_write(failed_dir / f"{path.name}.error.txt",
                             f"{type(err).__name__}: {err}\n")
                atomic_write(failed_dir / f"{path.name}.error.json",
                             json.dumps(payload, indent=2))
                _export_traces(rid)
                journal.failed(rid, payload,
                               trace_id=telemetry_trace.trace_id_for(rid)
                               if telemetry_trace.enabled() else None)
                path.replace(failed_dir / path.name)
                TellUser.error(f"serve: request {rid} failed: {err}")
        except Exception as e:          # never kill the batcher thread
            TellUser.error(f"serve: could not finalize request {rid}: {e}")
        finally:
            # release the id so a new same-named drop is a new request
            pending.pop(rid, None)

    # the serve loop owns the signal handlers (main thread): first
    # SIGTERM/SIGINT -> graceful drain + exit 0, second -> abort
    with service.supervisor:
        while not service.supervisor.stop_requested():
            replica_tick()
            submitted_any = False
            deferred = False
            for path in sorted(incoming.glob("*")):
                if backend_lost.is_set():
                    break
                if path.suffix.lower() not in (".csv", ".json", ".xml",
                                               ".pkl"):
                    continue
                # file stems become request ids, which name artifact
                # files — sanitize to the admission-safe alphabet (two
                # stems colliding post-sanitization: the second is
                # rejected as a duplicate and parked in failed/)
                rid = re.sub(r"[^A-Za-z0-9._-]", "_",
                             path.stem)[:64] or "req"
                if rid in pending:
                    continue
                # hedge-loser cancellation (fleet router): a cancel
                # marker retracts the input BEFORE admission — the
                # round-boundary contract; once admitted, the round
                # finishes and the router discards the answer
                if (cancel_dir / rid).exists():
                    journal.note("cancelled", rid)
                    path.unlink(missing_ok=True)
                    (cancel_dir / rid).unlink(missing_ok=True)
                    TellUser.info(f"serve: {rid} retracted by cancel "
                                  "marker before admission")
                    continue
                try:
                    if path.suffix.lower() == ".pkl":
                        # fleet transport: pickled cases payload from
                        # the router (same trust domain)
                        fut = service.submit_pickle(path, request_id=rid)
                        pending[rid] = fut
                        journal.admitted(
                            rid, path.name,
                            trace_id=telemetry_trace.trace_id_of(rid))
                        admissions += 1
                        fut.add_done_callback(
                            lambda f, p=path, r=rid: _finish(p, r, f))
                        submitted_any = True
                        # replica_crash drill: hard-exit (SIGKILL-like)
                        # right after the journal recorded the admission
                        # — the batch this request joined is in flight
                        faultinject.maybe_replica_crash(admissions)
                        continue
                    # a JSON file with a top-level "design" object is a
                    # BOOST design request; "portfolio" a coupled-fleet
                    # request; "montecarlo" an uncertainty valuation —
                    # anything else is a model-parameters file
                    is_design = is_portfolio = is_mc = False
                    if path.suffix.lower() == ".json":
                        from ..design.service import is_design_payload
                        from ..portfolio.service import \
                            is_portfolio_payload
                        from ..stochastic.service import \
                            is_montecarlo_payload
                        try:
                            with open(path) as fh:
                                payload = json.load(fh)
                            is_design = is_design_payload(payload)
                            is_portfolio = is_portfolio_payload(payload)
                            is_mc = is_montecarlo_payload(payload)
                        except Exception:
                            is_design = is_portfolio = is_mc = False
                    if is_mc:
                        fut = service.submit_montecarlo_file(
                            path, base_path=args.base_path,
                            request_id=rid)
                    elif is_portfolio:
                        fut = service.submit_portfolio_file(
                            path, base_path=args.base_path,
                            request_id=rid)
                    elif is_design:
                        fut = service.submit_design_file(
                            path, base_path=args.base_path,
                            request_id=rid)
                    else:
                        fut = service.submit_params(
                            path, base_path=args.base_path,
                            request_id=rid)
                except QueueFullError as e:
                    TellUser.warning(
                        f"serve: {rid} deferred (queue full), retrying "
                        f"in {e.retry_after_s:.1f}s")
                    deferred = True
                    break               # leave in incoming/, rescan later
                except ServiceClosedError:
                    break
                except Exception as e:  # unparseable input: park it
                    if backend_lost.is_set():
                        break           # refused by the open breaker
                    atomic_write(failed_dir / f"{path.name}.error.txt",
                                 f"{type(e).__name__}: {e}\n")
                    # the machine-readable form too: typed admission
                    # rejections (shard_cache_miss above all) must keep
                    # their kind/retry_hint across the spool hop — the
                    # shard executor switches on the kind to re-send a
                    # full payload
                    atomic_write(failed_dir / f"{path.name}.error.json",
                                 json.dumps(_error_payload(e)))
                    path.replace(failed_dir / path.name)
                    TellUser.error(f"serve: {rid} rejected at admission: "
                                   f"{e}")
                    continue
                pending[rid] = fut
                journal.admitted(rid, path.name,
                                 trace_id=telemetry_trace.trace_id_of(rid))
                admissions += 1
                fut.add_done_callback(
                    lambda f, p=path, r=rid: _finish(p, r, f))
                submitted_any = True
                faultinject.maybe_replica_crash(admissions)
            if args.once:
                if deferred and not service.supervisor.stop_requested():
                    # --once must still serve EVERY input: rescan the
                    # deferred leftovers once backpressure eases instead
                    # of silently exiting 0 with files unprocessed
                    service.supervisor.wait_stop(min(args.poll_s, 1.0))
                    continue
                for fut in list(pending.values()):
                    while not fut.done() and \
                            not service.supervisor.stop_requested():
                        replica_tick()
                        time.sleep(0.05)
                break
            if not submitted_any:
                service.supervisor.wait_stop(
                    min(args.poll_s, args.heartbeat_s or args.poll_s))
        if backend_lost.is_set():
            # no drain (every round would fail on the dead context) and
            # no interpreter teardown: after a device-side assert, atexit
            # handlers that touch CUDA raise again
            journal.close()
            TellUser.error("serve: backend lost — unanswered requests "
                           "stay admitted for the fleet router; exit "
                           f"{EXIT_BACKEND_LOST}")
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(EXIT_BACKEND_LOST)
        service.drain()
        if args.heartbeat_s:
            write_heartbeat()   # final beat advertises draining=True
        write_telemetry()       # final exposition (no-op when disabled)
    journal.close()
    metrics = service.metrics()
    atomic_write(spool / "service_metrics.json",
                 json.dumps(metrics, indent=2))
    TellUser.info(
        f"serve: drained; {metrics['requests']['completed']} request(s) "
        f"completed, {metrics['requests']['failed']} failed, "
        f"{metrics['queue']['rejected_full'] + metrics['queue']['rejected_overload']} "
        "rejected — metrics in service_metrics.json")
    return 0
