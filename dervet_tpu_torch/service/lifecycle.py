"""Fleet lifecycle supervisor: the control loop that makes replica
death a routine, automatically repaired event: the router detects
dead replicas and re-routes their work exactly-once; this relaunches
them and resizes the fleet.  On one GPU it is also the recovery from a
sticky CUDA fault: a replica whose context an illegal address or a
device-side assert poisoned exits (its serve loop cannot re-initialize
the context in-process), and its replacement starts with a fresh one.

:class:`FleetSupervisor` owns :class:`~dervet_tpu_torch.service.fleet
.SpoolReplica` processes end to end:

* **Respawn with crash-loop backoff** — when the router declares a
  replica dead (``_declare_dead`` hands the corpse here AFTER fencing
  and exactly-once failover), the supervisor schedules a replacement
  over the SAME spool with an exponentially-backed-off delay
  (``backoff_base_s · 2^k``, capped at ``backoff_max_s``).  A replica
  that keeps dying within ``rapid_crash_window_s`` of each respawn is
  parked in the typed ``quarantined`` terminal state after
  ``quarantine_after`` rapid crashes (:class:`~dervet_tpu_torch.utils.errors
  .ReplicaQuarantinedError` carries the diagnosis) instead of
  hot-looping spawn/crash forever; an operator clears it with
  :meth:`FleetSupervisor.release`.
* **Heartbeat-epoch fencing** — every respawn bumps the incarnation
  epoch (``spawn_replica(epoch=...)`` → ``--heartbeat-epoch`` → stamped
  into each beat).  The router discredits beats below the handle's
  epoch and, once a name is declared dead, only resurrects it for a
  STRICTLY higher epoch — so a fenced zombie still writing the shared
  spool can neither fake liveness nor close the breaker via a probe
  echo, and can never double-deliver (late answers fall to the
  router's first-answer-wins dedup).
* **Warm respawn** — the replacement imports the dead incarnation's
  last ``memory_export.pkl`` blob through the fleet's export-import
  path (dropped into ``memory_in/`` for the new serve loop's scan), so
  already-converged windows re-solve as exact-match substitutions.
  The dead replica's journaled in-flight requests were already
  re-routed by the router's exactly-once failover before the
  supervisor ever saw the corpse.
* **Telemetry-driven autoscaling** — the autoscaler reads the same
  replica-published load signals the router scrapes from each
  ``telemetry.prom`` (queue depth + drain rate + pending, via
  :meth:`FleetRouter.load_snapshot`): sustained per-replica backlog
  above ``scale_up_backlog`` for ``scale_pressure_s`` adds a replica
  (up to ``max_replicas``); a sustained-idle fleet sheds
  supervisor-added replicas (never the configured baseline, never
  below ``min_replicas``) only after a CLEAN drain — the victim is
  first unrouted (``handle.draining``), then waits for zero inflight
  and an empty spool, then gets a polite SIGTERM.

Kill switch: ``DERVET_TPU_FLEET_SUPERVISE=0`` makes :meth:`start` a
no-op (no thread, no router attachment, no state file) — the fleet
behaves bit for bit as it does today.

Env knobs (the ``DERVET_TPU_FLEET_*`` family; constructor args win):

======================================  =================================
``DERVET_TPU_FLEET_SUPERVISE``          kill switch (default on)
``DERVET_TPU_FLEET_MIN_REPLICAS``       autoscale floor
``DERVET_TPU_FLEET_MAX_REPLICAS``       autoscale ceiling
``DERVET_TPU_FLEET_BACKOFF_BASE_S``     first-respawn delay (0.5)
``DERVET_TPU_FLEET_BACKOFF_MAX_S``      backoff cap (30)
``DERVET_TPU_FLEET_RAPID_CRASH_S``      rapid-crash window (5)
``DERVET_TPU_FLEET_QUARANTINE_AFTER``   rapid crashes before quarantine (3)
``DERVET_TPU_FLEET_SCALE_UP_BACKLOG``   per-replica backlog trigger (8)
``DERVET_TPU_FLEET_SCALE_PRESSURE_S``   sustained-pressure window (5)
``DERVET_TPU_FLEET_SCALE_DOWN_IDLE_S``  sustained-idle window (30)
======================================  =================================
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from ..telemetry import registry as telemetry_registry
from ..telemetry import trace as telemetry_trace
from ..utils.errors import ReplicaQuarantinedError, TellUser
from .fleet import (MEMORY_EXPORT_FILE, ReplicaHandle, SpoolReplica,
                    spawn_replica)

SUPERVISE_ENV = "DERVET_TPU_FLEET_SUPERVISE"
STATE_FILE = "supervisor_state.json"

# lifecycle states (record.state); terminal ones are QUARANTINED (until
# released) and STOPPED (scale-down complete)
SPAWNING = "spawning"
UP = "up"
BACKOFF = "backoff"
DRAINING = "draining"
QUARANTINED = "quarantined"
STOPPED = "stopped"


def supervision_enabled() -> bool:
    """The ``DERVET_TPU_FLEET_SUPERVISE`` kill switch (default ON)."""
    return os.environ.get(SUPERVISE_ENV, "1").strip().lower() not in (
        "0", "false", "off", "no")


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return float(default)
    try:
        return float(raw)
    except ValueError:
        TellUser.warning(f"lifecycle: ignoring non-numeric {name}={raw!r}")
        return float(default)


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return int(raw)
    except ValueError:
        TellUser.warning(f"lifecycle: ignoring non-integer {name}={raw!r}")
        return default


class ReplicaSpec:
    """How to (re)spawn ONE replica: the spool it lives over plus the
    ``spawn_replica`` kwargs.  The supervisor keeps the spec so a
    respawn reproduces the original launch exactly (same backend, same
    queue bound, same extra args) with only the epoch bumped."""

    def __init__(self, spool, *, name: Optional[str] = None,
                 backend: str = "torch", device: str = "cuda:0",
                 heartbeat_s: float = 0.25,
                 poll_s: float = 0.05, max_queue_depth: int = 64,
                 extra_args: Optional[List[str]] = None,
                 env: Optional[Dict[str, str]] = None):
        self.spool = Path(spool)
        self.name = str(name or self.spool.name)
        self.backend = backend
        self.device = str(device)
        self.heartbeat_s = float(heartbeat_s)
        self.poll_s = float(poll_s)
        self.max_queue_depth = int(max_queue_depth)
        self.extra_args = list(extra_args or [])
        self.env = dict(env or {})

    def spawn(self, epoch: int, spawn_fn: Callable = spawn_replica
              ) -> SpoolReplica:
        return spawn_fn(self.spool, name=self.name, backend=self.backend,
                        device=self.device,
                        heartbeat_s=self.heartbeat_s, poll_s=self.poll_s,
                        max_queue_depth=self.max_queue_depth,
                        epoch=int(epoch), extra_args=self.extra_args,
                        env=self.env)

    def with_spool(self, spool, name: str) -> "ReplicaSpec":
        """A copy of this spec over a different spool — the autoscaler's
        template for scale-up replicas."""
        return ReplicaSpec(spool, name=name, backend=self.backend,
                           device=self.device,
                           heartbeat_s=self.heartbeat_s, poll_s=self.poll_s,
                           max_queue_depth=self.max_queue_depth,
                           extra_args=self.extra_args, env=self.env)


class _Record:
    """Supervisor-side lifecycle state for one replica name."""

    __slots__ = ("spec", "state", "epoch", "restarts", "rapid",
                 "last_restart_reason", "last_restart_t",
                 "last_spawn_mono", "backoff_until", "pending_reason",
                 "quarantine", "scaled", "warm_imports", "drain_since")

    def __init__(self, spec: ReplicaSpec, *, epoch: int = 0,
                 state: str = SPAWNING, scaled: bool = False):
        self.spec = spec
        self.state = state
        self.epoch = int(epoch)
        self.restarts = 0
        self.rapid = 0                  # consecutive rapid-crash streak
        self.last_restart_reason: Optional[str] = None
        self.last_restart_t: Optional[float] = None
        self.last_spawn_mono: Optional[float] = None
        self.backoff_until: Optional[float] = None
        self.pending_reason: Optional[str] = None
        self.quarantine: Optional[Dict] = None
        self.scaled = bool(scaled)      # autoscaler-added (down-scalable)
        self.warm_imports = 0
        self.drain_since: Optional[float] = None

    def as_dict(self) -> Dict:
        now = time.monotonic()
        return {
            "state": self.state,
            "epoch": self.epoch,
            "restarts": self.restarts,
            "rapid_crashes": self.rapid,
            "last_restart_reason": self.last_restart_reason,
            "last_restart_t": self.last_restart_t,
            "backoff_remaining_s": (
                round(max(0.0, self.backoff_until - now), 3)
                if self.backoff_until is not None
                and self.state == BACKOFF else None),
            "quarantine": self.quarantine,
            "scaled": self.scaled,
            "warm_imports": self.warm_imports,
        }


class FleetSupervisor:
    """Replica lifecycle control loop over a :class:`FleetRouter`.

    Construction wires nothing; :meth:`start` attaches to the router
    (``router.attach_supervisor``), adopts/spawns the configured
    replicas, and starts the supervisor thread — unless the
    ``DERVET_TPU_FLEET_SUPERVISE=0`` kill switch is set, in which case
    ``start()`` is a complete no-op and the fleet behaves exactly as an
    unsupervised one.

    ``spawn_fn`` is injectable (tests supervise fake replicas without
    subprocesses); it must accept ``spawn_replica``'s signature.
    """

    def __init__(self, router, specs=(), *,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 backoff_base_s: Optional[float] = None,
                 backoff_max_s: Optional[float] = None,
                 rapid_crash_window_s: Optional[float] = None,
                 quarantine_after: Optional[int] = None,
                 scale_up_backlog: Optional[float] = None,
                 scale_pressure_s: Optional[float] = None,
                 scale_down_idle_s: Optional[float] = None,
                 warm_respawn: bool = True,
                 tick_s: float = 0.25,
                 spool_root=None,
                 spawn_fn: Callable = spawn_replica):
        self.router = router
        spec_list = (list(specs.values()) if isinstance(specs, dict)
                     else list(specs))
        self._records: Dict[str, _Record] = {}
        for spec in spec_list:
            if spec.name in self._records:
                raise ValueError(f"duplicate replica spec {spec.name!r}")
            self._records[spec.name] = _Record(spec)
        n0 = len(spec_list)
        self.min_replicas = (int(min_replicas) if min_replicas is not None
                             else _env_int("DERVET_TPU_FLEET_MIN_REPLICAS",
                                           None))
        if self.min_replicas is None:
            self.min_replicas = n0
        self.max_replicas = (int(max_replicas) if max_replicas is not None
                             else _env_int("DERVET_TPU_FLEET_MAX_REPLICAS",
                                           None))
        if self.max_replicas is None:
            # default: no autoscale-up — the ceiling is the configured
            # fleet size (deployments opt into growth by raising it)
            self.max_replicas = max(n0, self.min_replicas)
        self.backoff_base_s = (float(backoff_base_s)
                               if backoff_base_s is not None else
                               _env_float("DERVET_TPU_FLEET_BACKOFF_BASE_S",
                                          0.5))
        self.backoff_max_s = (float(backoff_max_s)
                              if backoff_max_s is not None else
                              _env_float("DERVET_TPU_FLEET_BACKOFF_MAX_S",
                                         30.0))
        self.rapid_crash_window_s = (
            float(rapid_crash_window_s)
            if rapid_crash_window_s is not None else
            _env_float("DERVET_TPU_FLEET_RAPID_CRASH_S", 5.0))
        self.quarantine_after = (
            int(quarantine_after) if quarantine_after is not None else
            _env_int("DERVET_TPU_FLEET_QUARANTINE_AFTER", 3))
        self.scale_up_backlog = (
            float(scale_up_backlog) if scale_up_backlog is not None else
            _env_float("DERVET_TPU_FLEET_SCALE_UP_BACKLOG", 8.0))
        self.scale_pressure_s = (
            float(scale_pressure_s) if scale_pressure_s is not None else
            _env_float("DERVET_TPU_FLEET_SCALE_PRESSURE_S", 5.0))
        self.scale_down_idle_s = (
            float(scale_down_idle_s) if scale_down_idle_s is not None else
            _env_float("DERVET_TPU_FLEET_SCALE_DOWN_IDLE_S", 30.0))
        self.warm_respawn = bool(warm_respawn)
        self.tick_s = float(tick_s)
        self.spool_root = Path(spool_root) if spool_root else None
        self.spawn_fn = spawn_fn
        self.enabled = supervision_enabled()
        self._lock = threading.RLock()
        self._counters = {"restarts": 0, "quarantined": 0,
                          "released": 0, "scale_up": 0, "scale_down": 0,
                          "warm_imports": 0, "spawn_failures": 0}
        self._pressure_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._scale_seq = 0
        self._publish_last = 0.0
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "FleetSupervisor":
        """Attach to the router, adopt/spawn the fleet, start the loop.
        A no-op under the kill switch: no attachment, no thread, no
        state file — today's unsupervised behavior, bit for bit."""
        if not self.enabled or self._thread is not None:
            return self
        self.router.attach_supervisor(self)
        self._adopt_existing()
        with self._lock:
            records = list(self._records.items())
        for name, rec in records:
            if rec.state == SPAWNING and name not in self.router.replicas:
                self._spawn(rec, epoch=rec.epoch + 1, reason=None)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="dervet-fleet-supervisor")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the control loop.  Replica processes are NOT touched —
        they stay registered with the router, whose ``close()`` owns
        their termination."""
        with self._lock:
            self._closed = True
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self.enabled:
            self._publish(force=True)

    def __enter__(self) -> "FleetSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _adopt_existing(self) -> None:
        """Bring router replicas the caller spawned themselves under
        management: every ``SpoolReplica`` without a spec gets one
        synthesized from its handle (default spawn kwargs, its spool);
        in-process ``LocalReplica``s cannot be respawned and stay
        unmanaged."""
        for name, h in list(self.router.replicas.items()):
            with self._lock:
                rec = self._records.get(name)
                if rec is None:
                    if not isinstance(h, SpoolReplica):
                        continue
                    rec = _Record(ReplicaSpec(h.spool, name=name))
                    self._records[name] = rec
                # the handle is already live: record its incarnation
                rec.state = UP if h.state == "up" else rec.state
                rec.epoch = int(h.epoch or 0)
                rec.last_spawn_mono = time.monotonic()

    # -- router death hook ----------------------------------------------
    def on_replica_dead(self, name: str, reason: str) -> None:
        """Router ``_declare_dead`` hands the corpse here AFTER fencing
        + exactly-once failover.  Schedules the respawn (with crash-loop
        backoff) or quarantines; never spawns inline — the router's
        monitor thread must not block on process launch."""
        if not self.enabled:
            return
        with self._lock:
            if self._closed:
                return
            rec = self._records.get(name)
            if rec is None or rec.state in (BACKOFF, QUARANTINED,
                                            STOPPED):
                return
            if rec.state == DRAINING:
                # scale-down victim exiting after its SIGTERM: death is
                # the drain completing, not a crash
                return
            now = time.monotonic()
            uptime = (None if rec.last_spawn_mono is None
                      else now - rec.last_spawn_mono)
            rapid = (uptime is not None
                     and uptime <= self.rapid_crash_window_s)
            rec.rapid = rec.rapid + 1 if rapid else 1
            rec.pending_reason = reason
            if rec.rapid >= max(1, self.quarantine_after):
                self._quarantine_locked(name, rec, reason)
                return
            delay = min(self.backoff_max_s,
                        self.backoff_base_s * (2.0 ** (rec.rapid - 1)))
            rec.state = BACKOFF
            rec.backoff_until = now + delay
        TellUser.warning(
            f"lifecycle: replica {name!r} died ({reason}) — respawn in "
            f"{delay:.2f}s (crash streak {rec.rapid})")
        self._span(name, "crash", reason=reason, streak=rec.rapid,
                   backoff_s=round(delay, 3))

    def _quarantine_locked(self, name: str, rec: _Record,
                           reason: str) -> None:
        rec.state = QUARANTINED
        err = ReplicaQuarantinedError(
            f"replica {name!r} quarantined after {rec.rapid} rapid "
            f"crashes (each within {self.rapid_crash_window_s:g}s of "
            f"its respawn); last reason: {reason}",
            replica=name, crashes=rec.rapid, last_reason=reason)
        rec.quarantine = err.as_dict()
        self._counters["quarantined"] += 1
        TellUser.error(f"lifecycle: {err}")
        if self.router.journal is not None:
            self.router.journal.note("replica_quarantined", name,
                                     crashes=rec.rapid, reason=reason)
        self._span(name, "quarantine", crashes=rec.rapid, reason=reason)

    def release(self, name: str) -> bool:
        """Operator override: clear a quarantined replica and respawn
        it immediately (fresh crash streak)."""
        with self._lock:
            rec = self._records.get(name)
            if rec is None or rec.state != QUARANTINED:
                return False
            rec.state = BACKOFF
            rec.backoff_until = time.monotonic()
            rec.rapid = 0
            rec.quarantine = None
            self._counters["released"] += 1
        self._span(name, "release")
        return True

    # -- spawning -------------------------------------------------------
    def _spawn(self, rec: _Record, *, epoch: int,
               reason: Optional[str]) -> Optional[ReplicaHandle]:
        name = rec.spec.name
        blob = None
        if self.warm_respawn and reason is not None:
            try:
                blob = (rec.spec.spool / MEMORY_EXPORT_FILE).read_bytes()
            except OSError:
                blob = None
        try:
            handle = rec.spec.spawn(epoch, self.spawn_fn)
        except Exception as e:
            with self._lock:
                self._counters["spawn_failures"] += 1
                rec.rapid += 1
                if rec.rapid >= max(1, self.quarantine_after):
                    self._quarantine_locked(name, rec,
                                            f"spawn failed: {e}")
                    return None
                delay = min(self.backoff_max_s, self.backoff_base_s
                            * (2.0 ** (rec.rapid - 1)))
                rec.state = BACKOFF
                rec.backoff_until = time.monotonic() + delay
            TellUser.warning(f"lifecycle: spawning {name!r} failed "
                             f"({e}) — retry in {delay:.2f}s")
            return None
        with self._lock:
            rec.epoch = int(epoch)
            rec.state = SPAWNING
            rec.last_spawn_mono = time.monotonic()
            rec.backoff_until = None
            if reason is not None:
                rec.restarts += 1
                rec.last_restart_reason = reason
                rec.last_restart_t = time.time()
                self._counters["restarts"] += 1
            handle.restarts = rec.restarts
            handle.last_restart_reason = rec.last_restart_reason
            handle.last_restart_t = rec.last_restart_t
        self.router.adopt_replica(handle)
        if blob is not None:
            try:
                handle.import_memory(blob)
                with self._lock:
                    rec.warm_imports += 1
                    self._counters["warm_imports"] += 1
            except Exception as e:
                TellUser.warning(f"lifecycle: warm-start import for "
                                 f"{name!r} failed: {e}")
        self._span(name, "respawn" if reason is not None else "spawn",
                   epoch=epoch, reason=reason, warm=blob is not None)
        if reason is not None:
            TellUser.warning(f"lifecycle: replica {name!r} respawned "
                             f"(epoch {epoch}, warm={blob is not None})")
        return handle

    # -- control loop ---------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._lock:
                if self._closed:
                    return
            try:
                self._tick()
            except Exception as e:    # the loop must survive anything
                TellUser.warning(f"lifecycle: supervisor tick failed: "
                                 f"{e}")
            time.sleep(self.tick_s)

    def _tick(self) -> None:
        self._reap_transitions()
        self._process_backoffs()
        self._process_drains()
        self._autoscale()
        self._publish()

    def _reap_transitions(self) -> None:
        """SPAWNING → UP once the router has seen the incarnation's
        first FRESH beat (its startup grace is the router's)."""
        with self._lock:
            spawning = [(n, r) for n, r in self._records.items()
                        if r.state == SPAWNING]
        for name, rec in spawning:
            h = self.router.replicas.get(name)
            if h is None:
                continue
            if h.state == "up" and \
                    self.router._first_seen.get(name) is not None:
                with self._lock:
                    if rec.state == SPAWNING:
                        rec.state = UP

    def _process_backoffs(self) -> None:
        now = time.monotonic()
        with self._lock:
            due = [(n, r) for n, r in self._records.items()
                   if r.state == BACKOFF and r.backoff_until is not None
                   and now >= r.backoff_until]
        for name, rec in due:
            self._spawn(rec, epoch=rec.epoch + 1,
                        reason=rec.pending_reason or "crash")

    # -- autoscaling ----------------------------------------------------
    def _live_names(self) -> List[str]:
        with self._lock:
            return [n for n, r in self._records.items()
                    if r.state in (SPAWNING, UP, BACKOFF)]

    def _backlogs(self) -> Dict[str, float]:
        """Per-replica backlog estimate from the router's load view:
        the replica-published queue depth + pending (the same
        ``telemetry.prom`` signal routing ranks on), falling back to
        the router's inflight count for a replica that never
        published."""
        out: Dict[str, float] = {}
        for name, view in self.router.load_snapshot().items():
            if view["state"] != "up":
                continue
            pub = view.get("published")
            if pub is not None:
                out[name] = (float(pub.get("queue_depth") or 0.0)
                             + float(pub.get("pending") or 0.0))
            else:
                out[name] = float(view.get("inflight") or 0)
        return out

    def _autoscale(self) -> None:
        backlogs = self._backlogs()
        live = self._live_names()
        now = time.monotonic()
        n_live = len(live)
        if backlogs:
            avg = sum(backlogs.values()) / max(1, len(backlogs))
        else:
            avg = 0.0
        # -- scale up on sustained pressure
        if avg >= self.scale_up_backlog and n_live < self.max_replicas:
            if self._pressure_since is None:
                self._pressure_since = now
            elif now - self._pressure_since >= self.scale_pressure_s:
                self._pressure_since = None
                self._scale_up()
        else:
            self._pressure_since = None
        # -- scale down after sustained idle (clean drain first)
        idle = bool(backlogs) and all(v <= 0.0 for v in backlogs.values())
        with self._lock:
            has_victim = any(r.scaled and r.state == UP
                             for r in self._records.values())
        if idle and n_live > self.min_replicas and has_victim:
            if self._idle_since is None:
                self._idle_since = now
            elif now - self._idle_since >= self.scale_down_idle_s:
                self._idle_since = None
                self._begin_scale_down()
        else:
            self._idle_since = None

    def _scale_up(self) -> None:
        with self._lock:
            template = next((r.spec for r in self._records.values()
                             if not r.scaled), None)
            if template is None and self._records:
                template = next(iter(self._records.values())).spec
            if template is None:
                return
            self._scale_seq += 1
            name = f"scale{self._scale_seq:02d}"
            while name in self._records:
                self._scale_seq += 1
                name = f"scale{self._scale_seq:02d}"
            root = self.spool_root or template.spool.parent
            spec = template.with_spool(root / name, name)
            rec = _Record(spec, scaled=True)
            self._records[name] = rec
            self._counters["scale_up"] += 1
        TellUser.warning(f"lifecycle: sustained backlog — scaling up "
                         f"({name!r})")
        handle = self._spawn(rec, epoch=1, reason=None)
        # warm the newcomer from any up replica's published memory
        if handle is not None and self.warm_respawn:
            for other, h in list(self.router.replicas.items()):
                if other == name or not isinstance(h, SpoolReplica):
                    continue
                blob = h.read_memory_export()
                if blob:
                    try:
                        handle.import_memory(blob)
                        with self._lock:
                            rec.warm_imports += 1
                            self._counters["warm_imports"] += 1
                    except Exception:
                        pass
                    break
        self._span(name, "scale_up")

    def _begin_scale_down(self) -> None:
        with self._lock:
            victims = [(n, r) for n, r in self._records.items()
                       if r.scaled and r.state == UP]
            if not victims:
                return
            name, rec = victims[-1]      # newest scaled replica first
            rec.state = DRAINING
            rec.drain_since = time.monotonic()
        h = self.router.replicas.get(name)
        if h is not None:
            # unroute FIRST: _eligible skips a draining handle, so no
            # new request can land in the SIGTERM window
            h.draining = True
        TellUser.warning(f"lifecycle: fleet idle — draining {name!r} "
                         "for scale-down")
        self._span(name, "scale_down_begin")

    def _process_drains(self) -> None:
        with self._lock:
            draining = [(n, r) for n, r in self._records.items()
                        if r.state == DRAINING]
        for name, rec in draining:
            h = self.router.replicas.get(name)
            if h is None:
                with self._lock:
                    rec.state = STOPPED
                continue
            inflight = self.router._inflight.get(name, 0)
            spool_busy = False
            if isinstance(h, SpoolReplica):
                try:
                    spool_busy = any(p.suffix != ".tmp" for p in
                                     h.incoming.iterdir())
                except OSError:
                    spool_busy = False
            if inflight > 0 or spool_busy:
                continue                 # clean drain: wait it out
            alive = h.alive()
            if alive:
                term = getattr(h, "terminate", None)
                if term is not None:
                    term(timeout=30.0)   # polite SIGTERM: serve drains
                continue                 # re-check liveness next tick
            if self.router.remove_replica(name):
                with self._lock:
                    rec.state = STOPPED
                    self._counters["scale_down"] += 1
                TellUser.warning(f"lifecycle: replica {name!r} drained "
                                 "clean and removed (scale-down)")
                self._span(name, "scale_down_done")

    # -- observability --------------------------------------------------
    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
                "backoff_base_s": self.backoff_base_s,
                "quarantine_after": self.quarantine_after,
                "counters": dict(self._counters),
                "replicas": {n: r.as_dict()
                             for n, r in self._records.items()},
            }

    def _publish(self, force: bool = False) -> None:
        """State file (``supervisor_state.json``, read by ``python -m
        dervet_tpu_torch status``) + supervisor gauges into the router's
        fleet telemetry
        registry, at ~1s cadence."""
        now = time.monotonic()
        if not force and now - self._publish_last < 1.0:
            return
        self._publish_last = now
        snap = self.snapshot()
        snap["t"] = round(time.time(), 3)
        if telemetry_registry.enabled():
            reg = self.router._telemetry
            c = snap["counters"]
            reg.gauge("dervet_fleet_restarts_total").set(
                float(c["restarts"]))
            reg.gauge("dervet_fleet_scale_events").set(
                float(c["scale_up"] + c["scale_down"]))
            reg.gauge("dervet_fleet_quarantined_replicas").set(
                float(sum(1 for r in snap["replicas"].values()
                          if r["state"] == QUARANTINED)))
            reg.gauge("dervet_fleet_supervised_replicas").set(
                float(sum(1 for r in snap["replicas"].values()
                          if r["state"] in (SPAWNING, UP))))
        state_dir = self.router.fleet_dir or self.spool_root
        if state_dir is not None:
            from ..utils.supervisor import atomic_write
            try:
                state_dir.mkdir(parents=True, exist_ok=True)
                atomic_write(state_dir / STATE_FILE,
                             json.dumps(snap, indent=2, default=str))
            except OSError as e:
                TellUser.warning(f"lifecycle: state publish failed: {e}")

    def _span(self, name: str, event: str, **attrs) -> None:
        """One lifecycle span per event on the per-replica
        ``lifecycle.<name>`` trace, exported (or discarded) immediately
        — same discipline as the router's probe traces, so a long-lived
        supervisor never pins spans in the collector."""
        if not telemetry_trace.enabled():
            return
        try:
            rid = f"lifecycle.{name}"
            span = telemetry_trace.start_span(
                event, trace_id=telemetry_trace.trace_id_for(rid),
                attrs={"replica": name,
                       **{k: v for k, v in attrs.items()
                          if v is not None}})
            if span:
                span.end()
            exported = None
            if self.router.fleet_dir is not None:
                exported = telemetry_trace.export_request_trace(
                    rid, self.router.fleet_dir / "traces")
            if exported is None:
                telemetry_trace.COLLECTOR.pop(
                    telemetry_trace.trace_id_for(rid))
        except Exception:               # observability must never block
            pass


# ---------------------------------------------------------------------------
# CLI: `python -m dervet_tpu_torch fleet` — a supervised fleet as an ops
# surface
# ---------------------------------------------------------------------------

def fleet_main(argv=None) -> int:
    """``python -m dervet_tpu_torch fleet FLEET_DIR``: spawn and supervise an
    N-replica spool fleet until SIGTERM/SIGINT (or ``--duration-s``),
    then print the final supervisor snapshot as JSON.  Replica spools
    live under ``FLEET_DIR/replicaNN``; `python -m dervet_tpu_torch status
    FLEET_DIR`
    in another terminal shows live lifecycle columns."""
    import argparse
    import signal as _signal

    from .router import FleetRouter

    parser = argparse.ArgumentParser(
        prog="dervet_tpu_torch fleet",
        description="run a supervised multi-replica serve fleet")
    parser.add_argument("fleet_dir", type=Path)
    parser.add_argument("--replicas", type=int, default=2)
    parser.add_argument("--min-replicas", type=int, default=None)
    parser.add_argument("--max-replicas", type=int, default=None)
    parser.add_argument("--backend", default="torch",
                        choices=["torch", "cpu"])
    parser.add_argument("--device", default="cuda:0",
                        help="every replica's device (default cuda:0, "
                             "shared by all replicas; 'cpu' runs the "
                             "kernels' plain versions)")
    parser.add_argument("--heartbeat-s", type=float, default=0.25)
    parser.add_argument("--heartbeat-timeout-s", type=float, default=3.0)
    parser.add_argument("--max-queue-depth", type=int, default=64)
    parser.add_argument("--duration-s", type=float, default=None,
                        help="exit after this long (default: run until "
                             "SIGTERM/SIGINT)")
    args = parser.parse_args(argv)

    fleet_dir = args.fleet_dir
    fleet_dir.mkdir(parents=True, exist_ok=True)
    specs = [ReplicaSpec(fleet_dir / f"replica{i:02d}",
                         backend=args.backend, device=args.device,
                         heartbeat_s=args.heartbeat_s,
                         max_queue_depth=args.max_queue_depth)
             for i in range(max(1, args.replicas))]
    router = FleetRouter([], fleet_dir=fleet_dir,
                         heartbeat_timeout_s=args.heartbeat_timeout_s)
    supervisor = FleetSupervisor(
        router, specs, min_replicas=args.min_replicas,
        max_replicas=args.max_replicas, spool_root=fleet_dir)
    if not supervisor.enabled:
        TellUser.warning(f"fleet: {SUPERVISE_ENV}=0 — replicas will be "
                         "spawned once but never respawned")
        for spec in specs:
            router.adopt_replica(spec.spawn(epoch=1))
    stop = threading.Event()
    for sig in (_signal.SIGTERM, _signal.SIGINT):
        try:
            _signal.signal(sig, lambda *_: stop.set())
        except (ValueError, OSError):
            pass
    router.start()
    supervisor.start()
    t0 = time.monotonic()
    try:
        while not stop.is_set():
            if args.duration_s is not None and \
                    time.monotonic() - t0 >= args.duration_s:
                break
            stop.wait(0.25)
    finally:
        supervisor.stop()
        router.close()
    print(json.dumps(supervisor.snapshot(), indent=2, default=str))
    return 0
