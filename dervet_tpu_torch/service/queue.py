"""Bounded admission queue for the scenario service.

The serving layer's front door: submissions are admitted into a bounded
priority queue (backpressure by REJECTION, never by unbounded buffering —
a saturated service must shed load with a typed, retryable error instead
of growing until the host OOMs mid-solve), ordered by priority then
strict FIFO, each carrying an optional deadline after which the request
is answered with a typed expiry error instead of wasting a device batch.

The continuous batcher drains the queue with :meth:`AdmissionQueue.take`:
block until at least one request is pending, then hold the batch open for
``max_wait_s`` (or until ``max_batch`` requests) so small requests
arriving close together coalesce into one device dispatch — the
cross-request continuous-batching discipline MPAX-style batched LP
solving assumes (arxiv 2412.09734) but never provides a
serving harness for.

The ``overload`` fault kind (``DERVET_TPU_FAULT_OVERLOAD[_N]``) forces
admissions down the queue-full rejection path deterministically, so
backpressure and client retry-after handling are drillable like every
other failure mode.
"""
from __future__ import annotations

import collections
import heapq
import itertools
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

from ..utils import faultinject
# the typed-error family lives in utils.errors (one base, machine-
# readable kind + retry_hint); re-exported here for the JAX package's
# service import path
from ..utils.errors import (BackendLostError,  # noqa: F401
                            BreakerOpenError, DeadlineExpiredError,
                            PoisonRequestError, QueueFullError,
                            RequestFailedError, RequestPreemptedError,
                            ServiceClosedError, ServiceError,
                            ShardCacheMissError, TypedError)


class QueuedRequest:
    """One admitted submission: the cases to solve, admission metadata,
    and the future the result is delivered through.

    ``kind`` distinguishes the request types the service serves:
    ``"scenario"`` (solve these cases), ``"design"`` (BOOST sizing —
    ``design_case``/``design_spec`` carry the base case + spec, the
    screening phase fills ``cases`` with the finalist candidate cases,
    and ``design_state`` carries the screening results to frontier
    assembly at delivery), and ``"portfolio"`` (coupled-fleet
    co-optimization — ``portfolio_spec`` carries the member cases +
    coupling constraints; the dual loop runs in its own round).  A
    ``"portfolio_shard"`` request is one shard of ANOTHER node's dual
    round (``shard_payload``: site cases + the round's dual-price
    vector), dispatched against this replica's persistent caches — see
    ``dervet_tpu_torch.portfolio.shard``.  A ``"montecarlo"`` request is a
    batched uncertainty valuation (``mc_case``/``mc_spec`` carry the
    base case + sampler spec; the MC round answers it directly — see
    ``dervet_tpu_torch.stochastic``)."""

    __slots__ = ("request_id", "cases", "priority", "deadline", "future",
                 "seq", "t_submit", "fingerprint", "kind", "design_case",
                 "design_spec", "design_state", "portfolio_spec",
                 "shard_payload", "mc_case", "mc_spec", "span",
                 "trace_ctx")

    def __init__(self, request_id: str, cases: Dict, priority: int = 0,
                 deadline_s: Optional[float] = None, seq: int = 0,
                 kind: str = "scenario"):
        self.request_id = str(request_id)
        self.cases = cases
        self.priority = int(priority)
        now = time.monotonic()
        self.deadline = None if deadline_s is None else now + float(deadline_s)
        self.future: Future = Future()
        self.seq = seq
        self.t_submit = now
        # content fingerprint (poison-quarantine registry key), set by
        # the service at admission; None for direct queue users
        self.fingerprint: Optional[str] = None
        self.kind = str(kind)
        self.design_case = None
        self.design_spec = None
        self.design_state = None
        self.portfolio_spec = None
        self.shard_payload = None
        self.mc_case = None
        self.mc_spec = None
        # telemetry (dervet_tpu_torch/telemetry): the request's root span
        # on THIS process (ends when the future resolves) and the upstream
        # trace context it was propagated under (fleet transport)
        self.span = None
        self.trace_ctx = None

    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline


class AdmissionQueue:
    """Bounded, priority-then-FIFO admission queue with typed rejection.

    Higher ``priority`` pops first; within a priority level the order is
    strict FIFO (a monotone sequence number breaks ties, so two equal-
    priority requests can never reorder).  ``put`` never blocks: a full
    queue — or an active ``overload`` fault — rejects with
    :class:`QueueFullError` carrying a retry-after hint, which is the
    whole backpressure contract (callers retry or shed; the service's
    memory stays bounded)."""

    def __init__(self, max_depth: int = 64,
                 fairness_after_s: float = 30.0):
        self.max_depth = int(max_depth)
        self._cond = threading.Condition()
        self._heap: List[tuple] = []
        self._seq = itertools.count()
        self.closed = False
        # static retry-after fallback, used until round history exists
        # (note_round) lets the hint track the OBSERVED drain rate
        self.retry_after_s = 1.0
        # recent completed rounds: (requests served, round wall seconds)
        # — the drain-rate sample the retry-after hint is derived from
        self._rounds = collections.deque(maxlen=16)
        # fairness floor: a request that has waited longer than this is
        # served ahead of higher priorities — sustained high-priority
        # load can delay low-priority work but never starve it
        self.fairness_after_s = float(fairness_after_s)
        self.counters = {"admitted": 0, "rejected_full": 0,
                         "rejected_overload": 0, "rejected_closed": 0,
                         "expired": 0, "fairness_promotions": 0}

    # ------------------------------------------------------------------
    def note_round(self, requests_served: int, round_s: float) -> None:
        """Record one completed batch round — the drain-rate sample the
        retry-after hint is computed from (called by the server)."""
        if requests_served > 0 and round_s > 0:
            with self._cond:
                self._rounds.append((int(requests_served), float(round_s)))

    def _drain_rate_locked(self) -> Optional[float]:
        """Requests/sec over the recorded rounds; caller holds the
        lock.  The ONE drain-rate computation — both the published
        routing signal and the retry-after hint read it, so they can
        never diverge."""
        if not self._rounds:
            return None
        served = sum(n for n, _ in self._rounds)
        busy_s = sum(s for _, s in self._rounds)
        return served / busy_s if busy_s > 0 else None

    def drain_rate(self) -> Optional[float]:
        """Observed recent drain rate (requests/sec while solving) —
        the load signal the replica publishes in ``telemetry.prom`` and
        the fleet router routes on; None until any round completed."""
        with self._cond:
            return self._drain_rate_locked()

    def _retry_hint(self) -> float:
        """Seconds a rejected caller should wait: queue depth divided by
        the OBSERVED recent drain rate (requests/sec over the last few
        rounds), so the hint tracks real service speed instead of a
        constant.  Falls back to the static ``retry_after_s`` until any
        round has completed.  Caller holds the lock."""
        rate = self._drain_rate_locked()
        if rate is None:
            return self.retry_after_s
        # a full queue drains max_depth requests before a retried
        # admission can land; +1 for the retry itself
        hint = (len(self._heap) + 1) / rate
        return float(min(600.0, max(0.05, hint)))

    def put(self, req: QueuedRequest) -> None:
        """Admit ``req`` or raise a typed rejection (never blocks)."""
        with self._cond:
            if self.closed:
                self.counters["rejected_closed"] += 1
                raise ServiceClosedError(
                    f"request {req.request_id!r} rejected: the service "
                    "is draining — no new admissions")
            if faultinject.maybe_overload():
                self.counters["rejected_overload"] += 1
                hint = self._retry_hint()
                raise QueueFullError(
                    f"request {req.request_id!r} rejected: queue full "
                    "(overload fault injection); retry after "
                    f"{hint:.2f}s", retry_after_s=hint)
            if len(self._heap) >= self.max_depth:
                self.counters["rejected_full"] += 1
                hint = self._retry_hint()
                raise QueueFullError(
                    f"request {req.request_id!r} rejected: queue depth "
                    f"{len(self._heap)} at capacity {self.max_depth}; "
                    f"retry after {hint:.2f}s", retry_after_s=hint)
            req.seq = next(self._seq)
            heapq.heappush(self._heap, (-req.priority, req.seq, req))
            self.counters["admitted"] += 1
            self._cond.notify_all()

    def depth(self) -> int:
        with self._cond:
            return len(self._heap)

    def close(self) -> None:
        """Stop admissions (drain): subsequent ``put`` raises
        :class:`ServiceClosedError`; pending requests stay takeable."""
        with self._cond:
            self.closed = True
            self._cond.notify_all()

    # ------------------------------------------------------------------
    def take(self, max_batch: int = 64, max_wait_s: float = 0.0,
             block: bool = True,
             timeout: Optional[float] = None) -> List[QueuedRequest]:
        """Drain the next batch of requests, in priority-then-FIFO order.

        Blocks (up to ``timeout``) until at least one request is pending,
        then holds the batch open for up to ``max_wait_s`` — the
        continuous-batching window that lets small requests arriving
        close together share one device dispatch — or until ``max_batch``
        requests are pending.  Returns ``[]`` when nothing arrived (or
        the queue closed while empty).

        Requests whose deadline already passed are answered here with
        :class:`DeadlineExpiredError` and excluded from the batch."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while block and not self._heap and not self.closed:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    break
                self._cond.wait(remaining if remaining is not None else 0.5)
            if self._heap and max_wait_s > 0:
                # batching window: wait for stragglers to coalesce
                until = time.monotonic() + max_wait_s
                while len(self._heap) < max_batch and not self.closed:
                    remaining = until - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            # fairness floor: requests waiting past fairness_after_s are
            # served FIRST (oldest first), ahead of priority order — a
            # sustained stream of high-priority work can delay
            # low-priority requests but never starve them out entirely
            now = time.monotonic()
            max_prio = max((e[2].priority for e in self._heap), default=0)
            starved = sorted(
                (entry for entry in self._heap
                 if now - entry[2].t_submit > self.fairness_after_s
                 and entry[2].priority < max_prio),
                key=lambda e: e[1])
            out: List[QueuedRequest] = []
            for entry in starved:
                if len(out) >= max_batch:
                    break
                self._heap.remove(entry)
                req = entry[2]
                if req.expired():
                    self.counters["expired"] += 1
                    req.future.set_exception(DeadlineExpiredError(
                        f"request {req.request_id!r} expired in queue "
                        "before dispatch"))
                    continue
                self.counters["fairness_promotions"] += 1
                out.append(req)
            if starved:
                heapq.heapify(self._heap)
            while self._heap and len(out) < max_batch:
                _, _, req = heapq.heappop(self._heap)
                if req.expired():
                    self.counters["expired"] += 1
                    req.future.set_exception(DeadlineExpiredError(
                        f"request {req.request_id!r} expired in queue "
                        "before dispatch"))
                    continue
                out.append(req)
            return out

    def drain_pending(self) -> List[QueuedRequest]:
        """Pop everything still queued (shutdown path)."""
        with self._cond:
            out = [req for (_, _, req) in sorted(self._heap)]
            self._heap.clear()
            return out
