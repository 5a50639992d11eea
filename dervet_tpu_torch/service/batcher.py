"""Continuous batcher: coalesce queued requests into one dispatch round.

One round takes every request the admission queue handed over, builds all
their cases' scenarios, and runs a SINGLE ``run_dispatch`` over the union
— the existing structure-key grouping then batches windows ACROSS
requests exactly as it batches sensitivity cases, so a 1-case request
arriving next to a 32-case request rides the big request's device batches
for free.  Everything downstream is the existing stack, reused rather
than forked: solves go through the overlapped dispatch pipeline, failures
climb the escalation ladder, every window is float64-certified, and a
SIGTERM lands in the run supervisor's graceful-drain path with per-case
checkpoints plus per-request manifests flushed.

Per-request isolation: case ids are namespaced ``<request_id>.<key>`` so
checkpoints/manifest entries cannot collide across requests, each request
gets its own run-health report and solve-ledger slice, and one request's
total failure (all cases quarantined) answers THAT request with a typed
error while the round's other requests complete normally.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from ..io.summary import run_health_report
from ..ops.certify import aggregate_audits
from ..ops.pdhg import DRIVER_FIELDS
from ..results.result import Result
from ..scenario.scenario import PIPELINE_KEYS, MicrogridScenario, run_dispatch
from ..telemetry import trace as telemetry_trace
from ..utils.errors import (AggregatedSolverError, BackendLostError,
                            BreakerOpenError, PoisonRequestError,
                            PreemptedError, TellUser)
from . import resilience
from .queue import (DeadlineExpiredError, QueuedRequest,
                    RequestFailedError, RequestPreemptedError,
                    ServiceError)

# per-request ledger slices aggregate these numeric fields over the
# request's groups (a subset of the full ledger's totals: only what is
# attributable to a single request — shared round-level walls stay under
# ``round`` below)
# with the solve driver's fields (chunks, check windows, their CUDA graphs
# and status reads)
_SLICE_SUM_KEYS = ("solve_s", "stack_s", "h2d_s", "result_fetch_s",
                   "h2d_bytes", "result_bytes", "dispatches",
                   "compile_events") + DRIVER_FIELDS


def slice_request_ledger(ledger: Optional[Dict], request_id: str,
                         n_windows: Optional[int] = None
                         ) -> Optional[Dict]:
    """A request's view of the round's solve ledger: the per-group
    entries whose batch carried this request's windows (tagged by
    ``resolve_group`` via ``meta['requests']``), their summed line items,
    and the shared round totals for context.  Escalation-rung entries
    (retry / cpu_fallback) carry no request tag and stay round-level.
    The summed line items cover the SHARED groups the request rode —
    ``totals.batched_windows`` is that co-batched total, ``windows`` the
    request's own count."""
    if ledger is None:
        return None
    rid = str(request_id)
    groups = [g for g in ledger.get("groups", ())
              if rid in (g.get("requests") or ())]
    totals = {k: round(sum(float(g.get(k, 0)) for g in groups), 4)
              for k in _SLICE_SUM_KEYS}
    totals["batched_windows"] = sum(int(g.get("batch", 0)) for g in groups
                                    if g.get("rung") in (None, "initial"))
    if n_windows is not None:
        totals["windows"] = int(n_windows)
    return {
        "request_id": rid,
        "groups": groups,
        "totals": totals,
        # groups whose batch mixed several requests: the cross-request
        # coalescing observable (windows this request amortized against
        # other requests' batches)
        "coalesced_groups": sum(1 for g in groups
                                if len(g.get("requests") or ()) > 1),
        "round": {k: ledger.get(k) for k in
                  ("dispatch_solve_s",) + PIPELINE_KEYS},
        "round_totals": ledger.get("totals"),
    }


def build_request_result(req: QueuedRequest,
                         scenarios: Dict[object, MicrogridScenario],
                         ledger: Optional[Dict],
                         fidelity: str = resilience.FIDELITY_FULL,
                         breakers: Optional[Dict] = None) -> Result:
    """Assemble one request's :class:`Result` from its solved scenarios —
    the same collection path as ``api.DERVET.solve``'s tail (results
    registry, run-health report, invariant audit, sensitivity summary),
    scoped to the request.  Raises :class:`RequestFailedError` when every
    case quarantined.

    ``fidelity`` marks the answer tier: a load-shed ``"degraded"``
    screening answer carries the mark in the Result AND its run-health
    report, plus a resubmit hint — and is never certificate-stamped
    (certification is disabled for the degraded dispatch).  ``breakers``
    (the service board's snapshot) rides the run-health report so a
    request served during a tripped-breaker episode says so."""
    results = Result.initialize(req.cases)
    results.request_id = req.request_id
    report = run_health_report(
        {key: getattr(s, "health", {}) for key, s in scenarios.items()},
        {key: s.quarantine for key, s in scenarios.items()
         if s.quarantine is not None},
        certification_by_case={key: getattr(s, "certification", None)
                               for key, s in scenarios.items()})
    report["fidelity"] = fidelity
    if breakers:
        report["breakers"] = breakers
    results.fidelity = fidelity
    if fidelity == resilience.FIDELITY_DEGRADED:
        results.resubmit_hint = (
            "degraded-fidelity screening answer (service was shedding "
            "load): no certificate was issued — resubmit with a higher "
            "priority for a certified answer")
    results.run_health = report
    if all(s.quarantine is not None for s in scenarios.values()):
        raise RequestFailedError(
            {key: s.quarantine["reason"] for key, s in scenarios.items()})
    for key, s in scenarios.items():
        if s.quarantine is not None:
            TellUser.error(
                f"request {req.request_id}: case {key} excluded from "
                f"results (quarantined): {s.quarantine['reason']}")
            continue
        results.add_instance(key, s)
    audit = aggregate_audits(
        {key: getattr(inst, "invariant_audit", None)
         for key, inst in results.instances.items()})
    report["invariant_audit"] = audit
    if not audit["ok"]:
        TellUser.warning(
            f"request {req.request_id}: invariant audit FAILED for "
            f"case(s) {sorted(audit['failing'])}")
    results.sensitivity_summary()
    results.solve_ledger = slice_request_ledger(
        ledger, req.request_id,
        n_windows=sum(len(s.windows) for s in scenarios.values()))
    return results


class BatchRound:
    """One coalesced dispatch round over a list of admitted requests.

    ``on_stats(round)`` fires once per round, after the ledger/stats are
    final but BEFORE any request future resolves — so a client that
    wakes on ``fut.result()`` can immediately read service metrics and
    ``last_round_ledger`` without racing the bookkeeping."""

    def __init__(self, requests: List[QueuedRequest], *, backend: str,
                 solver_opts=None, solver_cache=None, supervisor=None,
                 checkpoint_dir=None, on_stats=None,
                 gc_checkpoints: bool = True, board=None, recovery=None,
                 poison_registry=None, degraded: bool = False,
                 device=None):
        self.requests = requests
        self.backend = backend
        # where the 'torch' backend solves (the service's resolved
        # device; None -> run_dispatch resolves it, raising without a GPU)
        self.device = device
        self.solver_opts = solver_opts
        self.solver_cache = solver_cache
        self.supervisor = supervisor
        # degraded rounds get NO checkpoint namespace: a checkpoint only
        # records case content (not solver fidelity), so a loose
        # screening solution persisted here would be reloaded verbatim
        # by a later CERTIFIED resume of the same request id and shipped
        # with a certified stamp — the exact integrity hole the
        # degraded tier must never open.  Screening solves are cheap;
        # they replay from scratch instead of resuming.
        self.checkpoint_dir = None if degraded else checkpoint_dir
        self.on_stats = on_stats
        # a persistent service must not grow one checkpoint set per
        # request served forever: a successfully DELIVERED request's
        # npz checkpoints + manifest slice are garbage-collected (their
        # resume value is spent); failed/preempted requests keep theirs
        self.gc_checkpoints = bool(gc_checkpoints)
        # resilience layer (all optional — a bare BatchRound behaves
        # exactly like the pre-resilience one):
        # breaker board gating the escalation-ladder rungs + the round's
        # certify-storm backend override
        self.board = board
        # backend-loss recovery policy (teardown/re-init)
        self.recovery = recovery
        # two-strike poison-request registry for crash attribution
        self.poison_registry = poison_registry
        # degraded tier: loose-tolerance short-budget screening solve,
        # certification off, results explicitly marked
        self.degraded = bool(degraded)
        # per-request scenario maps, built in run(); round observables
        self.scenarios: Dict[str, Dict[object, MicrogridScenario]] = {}
        self.ledger: Optional[Dict] = None
        self.stats: Dict[str, object] = {}
        self.preempted = False
        # requests answered during batch assembly (expired / duplicate
        # id / assembly failure) — kept so the service's request
        # accounting still covers them
        self.answered_early: List[QueuedRequest] = []
        # telemetry: per-request batch_round spans (ended in
        # _finish_stats, which every exit path reaches exactly once)
        self._round_spans: Dict[str, object] = {}

    # ------------------------------------------------------------------
    def _build_scenarios(self) -> List[MicrogridScenario]:
        """Construct every live request's scenarios (namespaced case
        ids); a request whose assembly raises is answered with that
        error and dropped from the round — it cannot poison the batch."""
        all_scens: List[MicrogridScenario] = []
        live: List[QueuedRequest] = []
        for req in self.requests:
            if req.expired():
                req.future.set_exception(DeadlineExpiredError(
                    f"request {req.request_id!r} expired before its "
                    "batch was assembled"))
                self.answered_early.append(req)
                continue
            if req.request_id in self.scenarios:
                # same-id requests in one round would cross-wire results
                # (scenario maps, checkpoints, manifests are all keyed by
                # request id) — the service rejects duplicates at
                # admission; this guards direct queue users too
                req.future.set_exception(ServiceError(
                    f"duplicate request id {req.request_id!r} in one "
                    "batch round"))
                self.answered_early.append(req)
                continue
            try:
                scens: Dict[object, MicrogridScenario] = {}
                for key, case in req.cases.items():
                    namespaced = dataclasses.replace(
                        case, case_id=f"{req.request_id}.{key}")
                    s = MicrogridScenario(namespaced)
                    s.request_id = req.request_id
                    scens[key] = s
            except Exception as e:      # bad inputs fail only this request
                TellUser.error(f"request {req.request_id}: scenario "
                               f"assembly failed: {e}")
                req.future.set_exception(e)
                self.answered_early.append(req)
                continue
            self.scenarios[req.request_id] = scens
            all_scens.extend(scens.values())
            live.append(req)
        self.requests = live
        return all_scens

    def _write_one_manifest(self, req: QueuedRequest) -> None:
        if not self.checkpoint_dir:
            return
        from ..utils import supervisor as _sup
        scens = self.scenarios.get(req.request_id)
        if scens:
            _sup.write_manifest(self.checkpoint_dir,
                                list(scens.values()), self.backend,
                                request_id=req.request_id)

    def _write_request_manifests(self) -> None:
        """Flush one namespaced resume manifest per live request (the
        drain path: preserved so resubmission resumes)."""
        for req in self.requests:
            self._write_one_manifest(req)

    def _gc_request_artifacts(self, req: QueuedRequest) -> None:
        """Drop a successfully delivered request's on-disk resume
        material — its value is spent, and a hot service would otherwise
        accumulate one checkpoint set per request forever."""
        if not (self.checkpoint_dir and self.gc_checkpoints):
            return
        import contextlib
        from ..utils.supervisor import manifest_path
        for s in self.scenarios.get(req.request_id, {}).values():
            with contextlib.suppress(OSError):
                s._checkpoint_path(self.checkpoint_dir).unlink(
                    missing_ok=True)
        with contextlib.suppress(OSError):
            manifest_path(self.checkpoint_dir,
                          req.request_id).unlink(missing_ok=True)

    def _emit_stats(self) -> None:
        if self.on_stats is not None:
            try:
                self.on_stats(self)
            except Exception:
                pass    # bookkeeping must never break delivery

    # ------------------------------------------------------------------
    def _opts(self):
        """The round's solver options — the BOOST-style loose-tolerance
        short-budget screening options when this is a degraded round."""
        if not self.degraded:
            return self.solver_opts
        from ..ops.pdhg import PDHGOptions
        return PDHGOptions.screening(self.solver_opts)

    def _dispatch(self, all_scens, backend: str) -> None:
        """One dispatch attempt.  Degraded rounds run with the float64
        certification layer disabled — their screening solutions are
        honest best-effort estimates, and a certificate would reject
        every one and climb the full ladder, defeating the shed."""
        import contextlib
        ctx = (resilience.certification_disabled() if self.degraded
               else contextlib.nullcontext())
        with ctx:
            run_dispatch(all_scens, backend=backend,
                         solver_opts=self._opts(),
                         checkpoint_dir=self.checkpoint_dir,
                         supervisor=self.supervisor,
                         solver_cache=self.solver_cache,
                         breaker_board=self.board, device=self.device)

    def _rebuild_scenarios(self) -> List[MicrogridScenario]:
        """Fresh scenario objects for the live requests (a replay after
        backend loss must not reuse state a dying dispatch half-mutated;
        already-solved windows reload from their checkpoints)."""
        self.scenarios = {}
        return self._build_scenarios()

    def run(self) -> None:
        """Dispatch the round and deliver every request's future.

        Raises :class:`~dervet_tpu_torch.utils.errors.PreemptedError` after
        answering the in-flight requests with
        :class:`RequestPreemptedError` (manifests flushed) — the server
        loop treats that as the drain signal.

        Failure handling beyond the plain round: a dispatch crash
        classified as BACKEND LOSS tears down and re-initializes the
        backend and replays the round from checkpoints; after N
        consecutive re-init failures the round's requests fail with the
        typed :class:`BackendLostError` (raised on to the service loop).
        While the certify breaker is open the round's requests fail fast
        with :class:`BreakerOpenError`.  Neither reroutes to the CPU: an
        answer from HiGHS would hide a faulty card or kernel behind a
        round that still answers certified.  Any other unexpected crash with a poison registry attached runs the
        ISOLATION protocol — each request re-dispatched alone, crashes
        attributed and struck, two strikes = typed PoisonRequestError +
        fingerprint blocklist — so one poisonous request never takes its
        co-batched innocents down with it."""
        t0 = time.monotonic()
        backend = self.backend
        if self.board is not None and backend != "cpu" and \
                self.board.is_open("certify"):
            # certification-rejection storm: the card's answers are
            # suspect — the round's requests fail fast until a half-open
            # probe round heals the breaker
            self._refuse_certify_open(t0)
            return
        all_scens = self._build_scenarios()
        memory = getattr(self.solver_cache, "memory", None)
        if memory is not None:
            # the solution memory holds one entry per WINDOW: keep this
            # round's windows resident with room for the last round's,
            # so a repeat request substitutes every window (at the
            # memory's 512-entry default a full-year round of 96 cases
            # evicts its own entries mid-round)
            memory.ensure_capacity(
                2 * sum(len(s.windows) for s in all_scens) + 64)
        self._start_round_spans()
        if not all_scens:
            self._finish_stats(all_scens, t0)
            self._emit_stats()
            return
        try:
            # replay loop: backend losses re-init + replay (bounded by
            # the recovery policy's re-init budget); other errors fall
            # through to the except arms below on the LAST attempt
            replays = 0
            max_replays = 0
            if self.recovery is not None:
                self.recovery.begin_round()
                max_replays = self.recovery.max_reinits + 1
            while True:
                try:
                    self._dispatch(all_scens, backend)
                    break
                except Exception as e:
                    if self.recovery is None or replays >= max_replays \
                            or not resilience.is_backend_loss(e):
                        raise
                    replays += 1
                    self.recovery.note_loss()
                    TellUser.error(
                        f"service: backend loss mid-round ({e}) — "
                        "tearing down and re-initializing")
                    reinited = False
                    while not reinited and not self.recovery.exhausted():
                        reinited = self.recovery.reinit(self.solver_cache)
                    if not reinited:
                        self.recovery.rounds_lost += 1
                        raise BackendLostError(
                            f"the {backend!r} backend did not come back "
                            f"after {self.recovery.max_reinits} re-init "
                            f"attempts ({e}); a sticky device fault needs "
                            "a process restart — resubmit to a live "
                            "service") from e
                    # fresh scenario objects; solved windows reload from
                    # the per-window checkpoints, so replay work is bounded
                    all_scens = self._rebuild_scenarios()
                    if not all_scens:
                        self._finish_stats(all_scens, t0)
                        self._emit_stats()
                        return
        except PreemptedError as e:
            # run_dispatch already flushed per-case checkpoints + the
            # shared sweep manifest; add the per-request slices, then
            # answer every in-flight future with the typed, resumable
            # preemption error
            self.preempted = True
            self._write_request_manifests()
            self._finish_stats(all_scens, t0)
            self._emit_stats()
            from ..utils.supervisor import manifest_path
            for req in self.requests:
                if not req.future.done():
                    req.future.set_exception(RequestPreemptedError(
                        f"request {req.request_id!r} preempted mid-"
                        f"dispatch ({e}); resubmit with the same request "
                        "id and checkpoint directory to resume",
                        manifest_path=(manifest_path(self.checkpoint_dir,
                                                     req.request_id)
                                       if self.checkpoint_dir else None)))
            raise
        except BackendLostError as e:
            # recovery exhausted: answer every in-flight future with the
            # typed error (never a CPU answer), then raise to the service
            # loop, which records it against the backend breaker
            self._finish_stats(all_scens, t0)
            self._emit_stats()
            for req in self.requests:
                if not req.future.done():
                    req.future.set_exception(e)
            TellUser.error(f"service: {e}")
            raise
        except AggregatedSolverError:
            # every case of every request quarantined: answer each
            # request with ITS slice of the diagnoses; the service stays
            # up (the error is data-shaped, not service-shaped)
            self.ledger = all_scens[0].solve_metadata.get("solve_ledger")
            self._finish_stats(all_scens, t0)
            self._emit_stats()
            for req in self.requests:
                self._write_one_manifest(req)   # keep resume material
                scens = self.scenarios[req.request_id]
                req.future.set_exception(RequestFailedError(
                    {key: (s.quarantine or {}).get("reason")
                     for key, s in scens.items()}))
            return
        except Exception as e:
            if self.poison_registry is not None:
                # unexpected crash with attribution machinery attached:
                # run the isolation protocol — each request re-dispatched
                # ALONE so innocents complete and the poisonous request
                # is struck, quarantined, and blocklisted
                self._finish_stats(all_scens, t0)
                self._emit_stats()
                self._isolate_poison(e, backend)
                return
            # an unexpected dispatch error (device OOM, driver bug) must
            # still ANSWER every in-flight future — a leaked unresolved
            # future hangs its client forever — before propagating to
            # the service loop for logging
            self._finish_stats(all_scens, t0)
            self._emit_stats()
            for req in self.requests:
                if not req.future.done():
                    req.future.set_exception(e)
            raise
        self.ledger = all_scens[0].solve_metadata.get("solve_ledger")
        self._finish_stats(all_scens, t0)
        self._emit_stats()
        for req in self.requests:
            self._deliver(req, self.scenarios[req.request_id], self.ledger)

    def _deliver(self, req: QueuedRequest, scens, ledger) -> None:
        """Build and deliver one request's result (or its typed
        failure), with the round's fidelity mark and breaker states.

        Design requests deliver a
        :class:`~dervet_tpu_torch.design.frontier.DesignFrontier` instead of a
        scenario :class:`Result`: their ``scens`` are the screened
        finalists' certified solves, and the screening state carried on
        the request supplies the population surface and ordinal ranks."""
        try:
            if req.kind == "design" and req.design_state is not None:
                from ..design.service import finalize_service_request
                frontier = finalize_service_request(
                    req, scens, ledger,
                    breakers=(self.board.snapshot()
                              if self.board is not None else None))
                frontier.request_latency_s = \
                    time.monotonic() - req.t_submit
                req.future.set_result(frontier)
                self._gc_request_artifacts(req)
                return
            results = build_request_result(
                req, scens, ledger,
                fidelity=(resilience.FIDELITY_DEGRADED if self.degraded
                          else resilience.FIDELITY_FULL),
                breakers=(self.board.snapshot()
                          if self.board is not None else None))
            results.request_latency_s = time.monotonic() - req.t_submit
            req.future.set_result(results)
            self._gc_request_artifacts(req)
        except Exception as e:      # post failure stays per-request
            if not isinstance(e, RequestFailedError):
                TellUser.error(f"request {req.request_id}: result "
                               f"collection failed: {e}")
            self._write_one_manifest(req)   # keep resume material
            req.future.set_exception(e)

    # ------------------------------------------------------------------
    # Poison-request isolation
    # ------------------------------------------------------------------
    def _isolate_poison(self, batch_exc: Exception, backend: str) -> None:
        """Attribution protocol after an unexpected round crash: each
        live request re-dispatches ALONE (fresh scenarios; solved windows
        reload from checkpoints).  Innocent requests complete normally;
        a request whose solo dispatch crashes is STRUCK in the registry
        — at two strikes it is quarantined with a typed
        :class:`PoisonRequestError` (diagnosis attached) and its
        fingerprint blocklisted, so resubmission is rejected fast at
        admission instead of re-crashing another co-batched round."""
        registry = self.poison_registry
        TellUser.error(
            f"service: round with {len(self.requests)} request(s) "
            f"crashed unexpectedly ({batch_exc}) — isolating: each "
            "request re-dispatches alone for crash attribution")
        for req in self.requests:
            if req.future.done():
                continue
            fp = req.fingerprint or resilience.request_fingerprint(
                req.cases)
            delivered = False
            while not delivered:
                try:
                    self._solo_dispatch(req, backend)
                    delivered = True
                except PreemptedError as pe:
                    # drain signal mid-isolation: every still-unanswered
                    # request (this one AND the not-yet-isolated rest)
                    # gets the typed resumable answer before the signal
                    # propagates — a leaked unresolved future hangs its
                    # client forever
                    self.preempted = True
                    self._write_request_manifests()
                    from ..utils.supervisor import manifest_path
                    for r in self.requests:
                        if not r.future.done():
                            r.future.set_exception(RequestPreemptedError(
                                f"request {r.request_id!r} preempted "
                                f"during crash isolation ({pe}); "
                                "resubmit with the same request id and "
                                "checkpoint directory to resume",
                                manifest_path=(
                                    manifest_path(self.checkpoint_dir,
                                                  r.request_id)
                                    if self.checkpoint_dir else None)))
                    raise
                except AggregatedSolverError as e:
                    # data-shaped total failure: the existing typed
                    # answer, not a poison strike
                    self._write_one_manifest(req)
                    req.future.set_exception(RequestFailedError(
                        {key: (s.quarantine or {}).get("reason")
                         for key, s in
                         self.scenarios[req.request_id].items()}))
                    delivered = True
                except Exception as e:
                    diag = f"{type(e).__name__}: {e}"
                    count = registry.strike(fp, req.request_id, diag)
                    if count >= registry.threshold:
                        req.future.set_exception(PoisonRequestError(
                            f"request {req.request_id!r} crashed the "
                            f"dispatch {count} times and is quarantined; "
                            "its content fingerprint is blocklisted — "
                            "fix the inputs before resubmitting",
                            diagnosis=diag))
                        delivered = True
                    else:
                        TellUser.warning(
                            f"service: request {req.request_id!r} crashed "
                            f"alone (strike {count}/{registry.threshold})"
                            " — retrying once")

    def _solo_dispatch(self, req: QueuedRequest, backend: str) -> None:
        """Dispatch ONE request by itself and deliver its result.
        Raises on crash (the caller attributes it)."""
        scens: Dict[object, MicrogridScenario] = {}
        for key, case in req.cases.items():
            namespaced = dataclasses.replace(
                case, case_id=f"{req.request_id}.{key}")
            s = MicrogridScenario(namespaced)
            s.request_id = req.request_id
            scens[key] = s
        self.scenarios[req.request_id] = scens
        self._dispatch(list(scens.values()), backend)
        ledger = next(iter(scens.values())).solve_metadata.get(
            "solve_ledger")
        self._deliver(req, scens, ledger)

    def _refuse_certify_open(self, t0) -> None:
        """Answer every request of the round with the typed
        :class:`BreakerOpenError` (retry at the breaker's next half-open
        probe) — nothing is dispatched."""
        probe_in_s = self.board.get("certify").probe_in_s()
        TellUser.warning(
            "service: certify breaker OPEN — refusing this round's "
            f"{len(self.requests)} request(s) until its probe")
        self._finish_stats([], t0)
        self._emit_stats()
        for req in self.requests:
            if not req.future.done():
                req.future.set_exception(BreakerOpenError(
                    f"request {req.request_id!r} not dispatched: the "
                    "certify breaker is open (a certification-rejection "
                    "storm on this backend) — retry after the probe "
                    "window", probe_in_s=probe_in_s))

    def _start_round_spans(self) -> None:
        """Per-request telemetry for this round: a retro ``admission``
        span covering the queue wait (submit -> round start) plus a live
        ``batch_round`` span that dispatch-group spans parent under (the
        rid registration is re-pointed here so ``resolve_group`` on any
        worker thread finds the right parent without plumbing)."""
        if not telemetry_trace.enabled():
            return
        now_mono = time.monotonic()
        for req in self.requests:
            parent = req.span
            if parent is None:
                continue
            wait_s = max(0.0, now_mono - req.t_submit)
            telemetry_trace.start_span(
                "admission", parent=parent, t_start=parent.t_start,
                duration_s=wait_s,
                attrs={"queue_wait_s": round(wait_s, 6),
                       "priority": req.priority})
            rs = telemetry_trace.start_span(
                "batch_round", parent=parent,
                attrs={"fidelity": (resilience.FIDELITY_DEGRADED
                                    if self.degraded
                                    else resilience.FIDELITY_FULL),
                       "backend": self.backend,
                       "requests_in_round": len(self.requests)})
            if self.degraded:
                # the degraded-fidelity marker must ride the TRACE, not
                # only the Result — an operator reading a shed request's
                # timeline sees why it was fast
                parent.set_attr("fidelity", resilience.FIDELITY_DEGRADED)
                rs.event("load_shed",
                         reason="sustained overload — answered by the "
                                "degraded screening tier")
            self._round_spans[req.request_id] = rs
            telemetry_trace.register_request(req.request_id, rs)

    def _end_round_spans(self, led: Dict) -> None:
        """Close every live ``batch_round`` span with the round's ledger
        summary attributes and re-point the rid registration back to the
        request root (delivery-time spans parent under the request, not
        a finished round)."""
        if not self._round_spans:
            return
        warm = led.get("warm_start") or {}
        for req in self.requests:
            rs = self._round_spans.pop(req.request_id, None)
            if rs is None:
                continue
            rs.set_attrs({
                "backend": self.backend,
                "windows": sum(len(s.windows)
                               for s in self.scenarios.get(
                                   req.request_id, {}).values()),
                "compile_events": int(
                    (led.get("totals") or {}).get("compile_events", 0)),
                "warm_seeded": int(warm.get("seeded", 0)),
                "warm_substituted": int(warm.get("substituted", 0)),
                "preempted": self.preempted,
            })
            rs.end()
            if req.span is not None:
                telemetry_trace.register_request(req.request_id, req.span)
        # requests that left the round early (expiry/duplicate) still
        # hold a round span — end those too
        for rid, rs in list(self._round_spans.items()):
            rs.end()
        self._round_spans.clear()

    def _finish_stats(self, all_scens, t0) -> None:
        led = self.ledger or {}
        self._end_round_spans(led)
        initial = [g for g in led.get("groups", ())
                   if g.get("rung") in (None, "initial")]
        self.stats = {
            "round_s": time.monotonic() - t0,
            "fidelity": (resilience.FIDELITY_DEGRADED if self.degraded
                         else resilience.FIDELITY_FULL),
            "backend_used": self.backend,
            "requests": len(self.requests),
            "cases": len(all_scens),
            "windows": sum(len(s.windows) for s in all_scens),
            "device_groups": len(initial),
            # continuous-batching occupancy: windows per device batch
            # (the whole point — small requests riding big batches)
            "mean_batch": (sum(g.get("batch", 0) for g in initial)
                           / len(initial)) if initial else 0.0,
            "cross_request_groups": sum(
                1 for g in initial if len(g.get("requests") or ()) > 1),
            "compile_events": int(
                (led.get("totals") or {}).get("compile_events", 0)),
            # warm-start observables (ops/warmstart.py): how many of the
            # round's windows rode a seed, and how many repeat windows
            # shipped a re-verified stored solution with zero device work
            "seeded_windows": int(
                (led.get("warm_start") or {}).get("seeded", 0)),
            "substituted_windows": int(
                (led.get("warm_start") or {}).get("substituted", 0)),
        }
        # elastic-scheduler observables (parallel/elastic.py; a plain
        # one-device round's ledger carries no such key): which
        # devices this round's groups landed on, how many steals the
        # stragglers cost, and the worst per-device occupancy — the
        # serving-bench gate's raw material
        el = led.get("elastic")
        if el:
            occ = [d["occupancy"] for d in el["devices"].values()
                   if d["groups"]]
            self.stats["elastic"] = {
                "n_devices": el["n_devices"],
                "devices_with_groups": el["devices_with_groups"],
                "steals": el["n_steals"],
                "min_occupancy": min(occ) if occ else None,
                "round_wall_s": el["round_wall_s"],
            }
