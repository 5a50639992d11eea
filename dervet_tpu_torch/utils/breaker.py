"""Circuit breakers for the service resilience layer.

A long-lived service that keeps feeding work into a failing path makes
every failure worse: a broken HiGHS fallback rung turns each escalation
into a wedged round, a certification layer rejecting everything turns
each window into a full ladder climb.  The breaker pattern (the standard
fleet-serving discipline — DuaLip-GPU-scale LP fleets treat degraded
paths as first-class, PAPERS.md: arxiv 2603.04621) cuts the sick path
off after its observed failure rate trips a threshold, serves from the
healthy paths, and probes the sick one on a schedule instead of
hammering it:

* **closed** — normal operation; outcomes are recorded into a sliding
  window, and the breaker trips OPEN when ``failure_rate >= threshold``
  over at least ``min_samples`` recent outcomes.
* **open** — the path is skipped entirely (``allow()`` is False) until
  ``cooldown_s`` elapses.
* **half-open** — exactly ONE probe call is allowed through; its
  outcome decides (success -> closed with a fresh window, failure ->
  open again with a fresh cooldown).

:class:`BreakerBoard` is the named collection the dispatch layer
consults (``retry_rung``, ``cpu_rung``, ``certify``, ``backend``);
every state transition is loggable and the whole board snapshots into
``run_health`` / the solve ledger so degradation is visible, not silent.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional

from .errors import TellUser


class CircuitBreaker:
    """One monitored path's sliding-window failure breaker."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, name: str, window: int = 20, min_samples: int = 4,
                 failure_threshold: float = 0.5, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        self.name = str(name)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.failure_threshold = float(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._events = collections.deque(maxlen=self.window)
        self.state = self.CLOSED
        self.trips = 0
        self.probes = 0
        self._opened_at: Optional[float] = None
        self._probe_inflight = False
        self._probe_started: Optional[float] = None

    # ------------------------------------------------------------------
    def _failure_rate(self) -> float:
        if not self._events:
            return 0.0
        return sum(1 for ok in self._events if not ok) / len(self._events)

    def _reap_lost_probe(self) -> None:
        """A probe whose guarded path RAISED never reports an outcome
        (every record() site is downstream of the path running); after a
        cooldown's worth of silence the probe is declared lost and
        counted as a failure — otherwise ``_probe_inflight`` wedges the
        breaker half-open-and-refusing forever.  Caller holds the
        lock."""
        if self.state == self.HALF_OPEN and self._probe_inflight and \
                self._probe_started is not None and \
                self._clock() - self._probe_started >= self.cooldown_s:
            self._probe_inflight = False
            self.state = self.OPEN
            self._opened_at = self._clock()
            TellUser.warning(f"breaker {self.name!r}: probe never "
                             "reported (path crashed?) — treating as "
                             f"failure, re-OPENED for {self.cooldown_s:g}s")

    def allow(self) -> bool:
        """May the guarded path be used right now?  OPEN returns False
        until the cooldown elapses, then exactly one half-open probe is
        let through; a second caller during an in-flight probe is still
        refused."""
        with self._lock:
            self._reap_lost_probe()
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    return False
                self.state = self.HALF_OPEN
                self._probe_inflight = False
            # half-open: one probe at a time
            if self._probe_inflight:
                return False
            self._probe_inflight = True
            self._probe_started = self._clock()
            self.probes += 1
            TellUser.info(f"breaker {self.name!r}: half-open — allowing "
                          "one probe through")
            return True

    def record(self, success: bool) -> None:
        """Record one outcome of the guarded path.  In half-open state
        the probe's outcome decides: success closes the breaker (fresh
        window), failure re-opens it (fresh cooldown)."""
        with self._lock:
            self._reap_lost_probe()
            if self.state == self.OPEN:
                if self._clock() - self._opened_at < self.cooldown_s:
                    return  # stragglers from before the trip: ignore
                # record-only callers (no allow() in their path — e.g.
                # the service's backend breaker) still heal: the first
                # outcome past the cooldown IS the probe outcome
                self.state = self.HALF_OPEN
                self._probe_inflight = True
            if self.state == self.HALF_OPEN:
                self._probe_inflight = False
                if success:
                    self.state = self.CLOSED
                    self._events.clear()
                    self._opened_at = None
                    TellUser.info(f"breaker {self.name!r}: probe "
                                  "succeeded — CLOSED")
                else:
                    self.state = self.OPEN
                    self._opened_at = self._clock()
                    TellUser.warning(f"breaker {self.name!r}: probe "
                                     "failed — re-OPENED for "
                                     f"{self.cooldown_s:g}s")
                return
            self._events.append(bool(success))
            if len(self._events) >= self.min_samples and \
                    self._failure_rate() >= self.failure_threshold:
                self.state = self.OPEN
                self._opened_at = self._clock()
                self.trips += 1
                rate = self._failure_rate()
                TellUser.warning(
                    f"breaker {self.name!r}: TRIPPED ({rate:.0%} failures "
                    f"over last {len(self._events)}) — path cut off for "
                    f"{self.cooldown_s:g}s, then half-open probe")

    def trip(self, reason: str = "") -> None:
        """Force the breaker OPEN immediately (fresh cooldown), bypassing
        the sliding-window rate.  For failures that are conclusive on
        their own — the fleet router confirming a replica dead (process
        exited / heartbeats stopped) must cut routing NOW, not after the
        window's failure rate catches up with reality."""
        with self._lock:
            if self.state != self.OPEN:
                self.trips += 1
            self.state = self.OPEN
            self._opened_at = self._clock()
            self._probe_inflight = False
            self._events.clear()
            TellUser.warning(
                f"breaker {self.name!r}: force-TRIPPED"
                + (f" ({reason})" if reason else "")
                + f" — path cut off for {self.cooldown_s:g}s, then "
                "half-open probe")

    # ------------------------------------------------------------------
    def probe_in_s(self) -> Optional[float]:
        """Seconds until the next half-open probe (None unless open)."""
        with self._lock:
            if self.state != self.OPEN:
                return None
            return max(0.0, self.cooldown_s
                       - (self._clock() - self._opened_at))

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "state": self.state,
                "failure_rate": round(self._failure_rate(), 3),
                "samples": len(self._events),
                "trips": self.trips,
                "probes": self.probes,
            }


class BreakerBoard:
    """Named collection of breakers, consulted by the dispatch layer.

    ``allow(name)``/``record(name, ok)`` auto-create a breaker on first
    touch with the board's defaults (overridable per name via
    ``configure``); a None board everywhere means 'no breakers' — solo
    ``DERVET.solve`` runs pass None and pay nothing."""

    def __init__(self, window: int = 20, min_samples: int = 4,
                 failure_threshold: float = 0.5, cooldown_s: float = 30.0,
                 clock=time.monotonic):
        self._defaults = dict(window=window, min_samples=min_samples,
                              failure_threshold=failure_threshold,
                              cooldown_s=cooldown_s, clock=clock)
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def configure(self, name: str, **overrides) -> CircuitBreaker:
        """Create (or replace) the named breaker with specific knobs."""
        with self._lock:
            br = CircuitBreaker(name, **{**self._defaults, **overrides})
            self._breakers[name] = br
            return br

    def get(self, name: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(name)
            if br is None:
                br = CircuitBreaker(name, **self._defaults)
                self._breakers[name] = br
            return br

    def allow(self, name: str) -> bool:
        return self.get(name).allow()

    def record(self, name: str, success: bool) -> None:
        self.get(name).record(success)

    def trip(self, name: str, reason: str = "") -> None:
        self.get(name).trip(reason)

    def is_open(self, name: str) -> bool:
        """True while the named path is cut off (no probe due yet).
        Unlike ``allow`` this never consumes the half-open probe."""
        br = self.get(name)
        with br._lock:
            br._reap_lost_probe()
            if br.state == CircuitBreaker.CLOSED:
                return False
            if br.state == CircuitBreaker.OPEN and \
                    br._clock() - br._opened_at >= br.cooldown_s:
                return False        # probe due: not 'open' to callers
            return br.state == CircuitBreaker.OPEN or br._probe_inflight

    def snapshot(self) -> Dict:
        with self._lock:
            return {name: br.snapshot()
                    for name, br in sorted(self._breakers.items())}
