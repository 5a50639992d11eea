"""Fleet replicas: the per-replica half of multi-replica serving.

One service saturates its device (or its host's LP assembly), so heavy
traffic means N service replicas behind a router (DuaLip-GPU runs LP
fleets at exactly this shape, arxiv 2603.04621).  On one H100 the
replicas share ``cuda:0``, each process with a CUDA context of its own:
a sticky CUDA fault (an illegal address, a device-side assert) poisons
only the context of the process that hit it, and the router fails its
requests over to a sibling while the lifecycle supervisor respawns it.
This module defines what a *replica* is to the router;
:mod:`dervet_tpu_torch.service.router` builds the routing/health/failover
brain on top.

Two transports, one interface (:class:`ReplicaHandle`):

* :class:`SpoolReplica` — a real ``python -m dervet_tpu_torch serve``
  process over its own spool directory.  Requests travel as
  atomically-renamed pickle payloads into ``incoming/``; answers are the
  spool's normal ``results/<rid>/`` artifacts plus the
  ``done/``/``failed/`` terminal markers; liveness is the
  ``heartbeat.json`` the serve loop rewrites every ``--heartbeat-s``;
  the replica's crash-safe ``service_journal.jsonl`` is what makes
  failover exactly-once rather than best-effort.  :func:`spawn_replica`
  launches one.
* :class:`LocalReplica` — an in-process :class:`ScenarioService`
  behind the same interface (tests, single-process benches).

Affinity key: :func:`structure_fingerprint` hashes the facts that
determine a request's LP structure (DER set, window scheme, horizon
length, stream set) and nothing content-like (prices, loads) — two
requests with the same fingerprint hit the same cached solvers and
warm-start structure pools, so the router keeps them on the replica
that is already warm for that shape.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import signal
import subprocess
import sys
import time
from concurrent.futures import Future
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..utils.errors import TellUser
from .journal import ServiceJournal

# spool layout bits the router and the serve loop agree on
HEARTBEAT_FILE = "heartbeat.json"
PROBE_FILE = "probe.json"
CANCEL_DIR = "cancel"
MEMORY_EXPORT_FILE = "memory_export.pkl"
MEMORY_IN_DIR = "memory_in"
JOURNAL_FILE = "service_journal.jsonl"
PAYLOAD_SUFFIX = ".pkl"


# ---------------------------------------------------------------------------
# Structure-fingerprint affinity key
# ---------------------------------------------------------------------------

# scenario keys that shape the LP structure (window scheme,
# step, horizon, included couplings) — NOT content like prices/loads
_STRUCTURAL_SCENARIO_KEYS = (
    "n", "dt", "opt_years", "start_year", "end_year", "incl_site_load",
    "incl_thermal_load", "allow_partial_year", "binary",
)


def structure_fingerprint(cases: Dict) -> str:
    """Hash of a request's LP *structure*: per case, the DER set
    (tags + ids + which keys each carries), the stream tags, the
    window-shaping scenario keys, and the time-series LENGTH — everything
    that decides which cached solvers and warm-start structure pools
    the request will hit, and nothing about the numbers in them.  Two
    requests that differ only in prices/ratings/loads share the
    fingerprint (and should share a warm replica); a different horizon
    or DER mix does not."""
    h = hashlib.sha256()
    for key in sorted(cases, key=str):
        case = cases[key]
        scen = case.scenario
        h.update(repr([(k, scen.get(k))
                       for k in _STRUCTURAL_SCENARIO_KEYS]).encode())
        h.update(repr(sorted((tag, der_id, tuple(sorted(keys)))
                             for tag, der_id, keys in case.ders)).encode())
        h.update(repr(sorted(case.streams)).encode())
        ts = case.datasets.time_series
        h.update(str(0 if ts is None else len(ts)).encode())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# Replica handles
# ---------------------------------------------------------------------------

class ReplicaHandle:
    """One replica as the router sees it: submit / poll / health / fence.

    Subclasses implement the transport; the router only ever talks to
    this surface.  ``state`` is router-owned ("up" | "dead")."""

    def __init__(self, name: str):
        self.name = str(name)
        self.state = "up"
        # heartbeat-epoch fence (lifecycle supervisor): ``epoch`` is the
        # incarnation this handle's process was spawned with (None =
        # unsupervised, no fencing); ``fence_epoch`` is set by the
        # router at declare-dead time to the LAST epoch it saw beat —
        # only a beat with a STRICTLY HIGHER epoch can resurrect the
        # name, so a fenced zombie's late heartbeat writes over the
        # shared spool can never re-open routing to the corpse
        self.epoch: Optional[int] = None
        self.fence_epoch: Optional[int] = None
        # restart metadata (stamped by the supervisor on each respawn;
        # surfaced through snapshot() -> metrics -> `python -m
        # dervet_tpu_torch status`)
        self.restarts = 0
        self.last_restart_reason: Optional[str] = None
        self.last_restart_t: Optional[float] = None

    # -- request path ---------------------------------------------------
    def submit(self, cases, rid: str, *, priority: int = 0,
               deadline_epoch: Optional[float] = None,
               payload: Optional[bytes] = None,
               trace_ctx: Optional[Dict] = None,
               extra: Optional[Dict] = None) -> None:
        """Hand one request to the replica.  May raise the replica's
        typed admission errors synchronously (local transport); spool
        transport never raises here — outcomes arrive via :meth:`poll`.

        ``trace_ctx`` is the router's telemetry trace context
        (``{"trace_id", "span_id"}``): it rides the transport (spool
        pickle payload / local submit kwarg) so the replica-side span
        tree parents under the router's — one stitched trace per
        request across processes.

        ``extra`` carries request-kind extensions through the same
        transport — today the ``portfolio_shard`` payload (one shard of
        a fleet-sharded portfolio dual round: site cases + dual-price
        vector; see ``dervet_tpu_torch.portfolio.shard``)."""
        raise NotImplementedError

    def poll(self, rid: str) -> Optional[Tuple[str, object]]:
        """The replica's answer for ``rid`` if it has one:
        ``("done", answer)`` / ``("failed", error_payload_dict)`` /
        ``None`` while still in flight."""
        raise NotImplementedError

    def request_state(self, rid: str) -> str:
        """Failover-time classification: ``"completed"`` (an answer
        exists and can be harvested), ``"failed"``, or ``"pending"``
        (must be re-routed)."""
        outcome = self.poll(rid)
        if outcome is None:
            return "pending"
        return "completed" if outcome[0] == "done" else "failed"

    def retract(self, rid: str) -> None:
        """Best-effort removal of a not-yet-served request (failover
        fencing / hedge-loser cancellation before admission)."""

    def cancel(self, rid: str) -> None:
        """Ask the replica to drop ``rid`` at the next round boundary
        (hedge loser).  Best-effort: an answer that still arrives is
        simply discarded by the router's exactly-once delivery."""

    # -- health ---------------------------------------------------------
    def heartbeat(self) -> Optional[Dict]:
        """The replica's latest heartbeat record (None = none yet)."""
        raise NotImplementedError

    def probe(self, nonce: str, trace: Optional[Dict] = None) -> None:
        """Leave a probe nonce for the replica to echo in its next
        heartbeat — the router's cheap liveness probe (no solve).
        ``trace`` is an optional telemetry context the replica echoes
        back alongside the nonce, so probe round-trips are traceable."""

    def published_load(self) -> Optional[Dict]:
        """The replica's SELF-published load signal (queue depth + drain
        rate from its telemetry exposition), or None when it has never
        published — the router's least-loaded ranking prefers this over
        its own inflight counts, which go stale across failover."""
        return None

    def alive(self) -> Optional[bool]:
        """Process-level liveness when known (None = not owned here)."""
        return None

    def kill(self) -> None:
        """Fence: make sure the replica can do no further work (router
        calls this before re-routing its in-flight requests)."""

    # -- warm-start handoff ---------------------------------------------
    def read_memory_export(self) -> Optional[bytes]:
        """The replica's last published warm-start memory export (pickle
        bytes), if any."""
        return None

    def import_memory(self, blob: bytes) -> None:
        """Hand another replica's memory export to this one."""

    def snapshot(self) -> Dict:
        return {"name": self.name, "state": self.state}


class SpoolReplica(ReplicaHandle):
    """A ``python -m dervet_tpu_torch serve`` process over its own spool
    directory.

    The handle only touches the spool filesystem (plus the process
    handle when this router spawned the replica): requests are pickle
    payloads atomically renamed into ``incoming/`` (a half-written file
    is never visible to the replica's scan), answers are the terminal
    ``done/``/``failed/`` markers plus ``results/<rid>/`` artifacts, and
    health is ``heartbeat.json`` freshness.  Payloads carry pickled
    ``CaseParams`` — a same-trust-domain transport (the replicas are our
    own processes on our own host/cluster), not a wire format."""

    def __init__(self, name: str, spool, process: Optional[
            subprocess.Popen] = None):
        super().__init__(name)
        self.spool = Path(spool)
        self.process = process
        self.incoming = self.spool / "incoming"
        self.results_root = self.spool / "results"
        self.done_dir = self.spool / "done"
        self.failed_dir = self.spool / "failed"
        self.cancel_dir = self.spool / CANCEL_DIR
        self.memory_in = self.spool / MEMORY_IN_DIR
        for d in (self.incoming, self.results_root, self.done_dir,
                  self.failed_dir, self.cancel_dir, self.memory_in):
            d.mkdir(parents=True, exist_ok=True)

    # -- request path ---------------------------------------------------
    @staticmethod
    def encode_payload(cases, *, priority: int = 0,
                       deadline_epoch: Optional[float] = None,
                       trace: Optional[Dict] = None,
                       extra: Optional[Dict] = None,
                       cases_blob: Optional[bytes] = None) -> bytes:
        # "trace" is the router's telemetry context: the replica's
        # submit_pickle hands it to ScenarioService.submit as trace_ctx;
        # "extra" merges kind extensions (the portfolio_shard payload)
        # into the same transport record.  A portfolio_shard extra IS
        # the request (submit_pickle dispatches on it and never reads
        # "cases"), so cases are omitted — shipping them too used to
        # double every shard payload on the wire.  "cases_blob" is the
        # client's one-time pickle of the cases dict: embedding the
        # bytes is a memcpy, not a re-serialization of every DataFrame.
        record = {"priority": int(priority),
                  "deadline_epoch": deadline_epoch,
                  **({"trace": trace} if trace else {}),
                  **(extra or {})}
        if "portfolio_shard" not in record:
            if cases_blob is not None:
                record["cases_pickle"] = cases_blob
            else:
                record["cases"] = cases
        return pickle.dumps(record, protocol=pickle.HIGHEST_PROTOCOL)

    def _fname(self, rid: str) -> str:
        return f"{rid}{PAYLOAD_SUFFIX}"

    def submit(self, cases, rid: str, *, priority: int = 0,
               deadline_epoch: Optional[float] = None,
               payload: Optional[bytes] = None,
               trace_ctx: Optional[Dict] = None,
               extra: Optional[Dict] = None) -> None:
        if payload is None:
            payload = self.encode_payload(cases, priority=priority,
                                          deadline_epoch=deadline_epoch,
                                          trace=trace_ctx, extra=extra)
        # dot-prefixed tmp + rename: the serve scan globs non-dot names,
        # so a half-written payload can never be admitted
        final = self.incoming / self._fname(rid)
        tmp = self.incoming / f".{final.name}.tmp"
        tmp.write_bytes(payload)
        os.replace(tmp, final)

    def poll(self, rid: str) -> Optional[Tuple[str, object]]:
        fname = self._fname(rid)
        if (self.done_dir / fname).exists():
            return "done", self.results_root / rid
        err_json = self.failed_dir / f"{fname}.error.json"
        if (self.failed_dir / fname).exists() or err_json.exists():
            try:
                payload = json.loads(err_json.read_text())
            except (OSError, ValueError):
                payload = {"error": "unknown", "kind": "error",
                           "message": "replica recorded a failure but "
                                      "its error payload is unreadable",
                           "retry_hint": None}
            return "failed", payload
        return None

    def request_state(self, rid: str) -> str:
        outcome = self.poll(rid)
        if outcome is not None:
            return "completed" if outcome[0] == "done" else "failed"
        # the terminal marker may be missing only because the kill
        # landed between persisting results and moving the input file:
        # trust the replica's own journal (results are persisted BEFORE
        # "completed" is journaled, so a journaled completion always has
        # its results on disk — harvestable, no re-solve)
        state = ServiceJournal.replay_path(
            self.spool / JOURNAL_FILE).get(rid, {}).get("state")
        if state == "completed" and (self.results_root / rid).is_dir():
            return "completed"
        if state == "failed":
            return "failed"
        return "pending"

    def retract(self, rid: str) -> None:
        try:
            (self.incoming / self._fname(rid)).unlink()
        except FileNotFoundError:
            pass

    def cancel(self, rid: str) -> None:
        # marker file; the serve scan retracts the input if it has not
        # been admitted yet (round-boundary cancellation)
        try:
            (self.cancel_dir / str(rid)).touch()
        except OSError:
            pass

    # -- health ---------------------------------------------------------
    def heartbeat(self) -> Optional[Dict]:
        try:
            return json.loads((self.spool / HEARTBEAT_FILE).read_text())
        except (OSError, ValueError):
            return None         # missing or torn mid-replace: no beat

    def probe(self, nonce: str, trace: Optional[Dict] = None) -> None:
        from ..utils.supervisor import atomic_write
        atomic_write(self.spool / PROBE_FILE,
                     json.dumps({"nonce": str(nonce),
                                 "t": round(time.time(), 3),
                                 **({"trace": trace} if trace else {})}))

    def published_load(self) -> Optional[Dict]:
        """Parse the replica's ``telemetry.prom`` exposition (written
        atomically by its serve loop at the heartbeat cadence) into the
        routing load signal.  None when the file does not exist (replica
        never published / telemetry off) or is unreadable."""
        from ..telemetry import ops as telemetry_ops
        from ..telemetry import registry as telemetry_registry
        prom = self.spool / telemetry_ops.PROM_FILE
        try:
            text = prom.read_text()
            parsed = telemetry_registry.parse_prometheus(text)
            t_published = prom.stat().st_mtime
        except (OSError, ValueError):
            return None
        depth = telemetry_registry.sample_value(
            parsed, telemetry_ops.M_QUEUE_DEPTH)
        if depth is None:
            return None
        return {
            "queue_depth": float(depth),
            "drain_rate_rps": telemetry_registry.sample_value(
                parsed, telemetry_ops.M_DRAIN_RATE) or 0.0,
            "pending": telemetry_registry.sample_value(
                parsed, telemetry_ops.M_PENDING) or 0.0,
            # wall-clock publish time (exposition mtime): the router
            # treats a signal older than its staleness bound as
            # never-published — a frozen file from a dead/restarted
            # replica must not keep ranking it as idle
            "t_published": t_published,
        }

    def alive(self) -> Optional[bool]:
        if self.process is None:
            return None
        return self.process.poll() is None

    def kill(self) -> None:
        """SIGKILL the owned process (fencing before failover: a hung
        replica must not wake up and keep writing once its requests have
        been re-routed — its spool stays readable for harvest/journal
        replay, its compute is done)."""
        if self.process is not None and self.process.poll() is None:
            try:
                self.process.send_signal(signal.SIGKILL)
                self.process.wait(timeout=10)
            except (OSError, subprocess.TimeoutExpired) as e:
                TellUser.warning(
                    f"fleet: could not fence replica {self.name!r}: {e}")

    def terminate(self, timeout: float = 30.0) -> None:
        """Polite shutdown of an owned process (router drain path)."""
        if self.process is None or self.process.poll() is not None:
            return
        try:
            self.process.terminate()
            self.process.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.process.kill()
            self.process.wait(timeout=10)
        except OSError:
            pass

    # -- failover -------------------------------------------------------
    def journal_states(self) -> Dict[str, Dict]:
        return ServiceJournal.replay_path(self.spool / JOURNAL_FILE)

    def read_memory_export(self) -> Optional[bytes]:
        try:
            return (self.spool / MEMORY_EXPORT_FILE).read_bytes()
        except OSError:
            return None

    def import_memory(self, blob: bytes) -> None:
        # dropped into memory_in/ for the serve loop to install on its
        # next scan; unique name so two handoffs never clobber
        target = self.memory_in / f"import-{time.time_ns()}.pkl"
        tmp = target.with_name(f".{target.name}.tmp")
        tmp.write_bytes(blob)
        os.replace(tmp, target)

    def snapshot(self) -> Dict:
        alive = self.alive()
        return {"name": self.name, "state": self.state,
                "spool": str(self.spool),
                "pid": self.process.pid if self.process else None,
                "process_alive": alive,
                "epoch": self.epoch,
                "restarts": self.restarts,
                "last_restart_reason": self.last_restart_reason}


class LocalReplica(ReplicaHandle):
    """An in-process :class:`ScenarioService` behind the replica
    interface — the unit-test / single-process transport.  ``submit``
    raises the service's typed admission errors synchronously (the
    router's redirect path catches queue-full and tries the next
    replica); health is synthesized from service state.  ``kill`` only
    simulates death to the ROUTER (heartbeats stop); the underlying
    service keeps running unless ``hard=True`` drains it — that is
    exactly what a flapping/hung replica looks like from outside, which
    is what the router tests need."""

    def __init__(self, name: str, service):
        super().__init__(name)
        self.service = service
        self._futures: Dict[str, Future] = {}
        self._killed = False
        self._t0 = time.time()

    def submit(self, cases, rid: str, *, priority: int = 0,
               deadline_epoch: Optional[float] = None,
               payload: Optional[bytes] = None,
               trace_ctx: Optional[Dict] = None,
               extra: Optional[Dict] = None) -> None:
        deadline_s = None
        if deadline_epoch is not None:
            deadline_s = max(0.0, deadline_epoch - time.time())
        # the rid rides through unchanged: each LocalReplica wraps its
        # OWN service, so ids cannot cross-wire between replicas, and
        # artifact names stay identical to a single-replica run
        if extra and extra.get("portfolio_shard") is not None:
            self._futures[rid] = self.service.submit_portfolio_shard(
                extra["portfolio_shard"], request_id=rid,
                priority=priority, deadline_s=deadline_s,
                trace_ctx=trace_ctx)
            return
        self._futures[rid] = self.service.submit(
            cases, request_id=rid, priority=priority,
            deadline_s=deadline_s, trace_ctx=trace_ctx)

    def poll(self, rid: str) -> Optional[Tuple[str, object]]:
        fut = self._futures.get(rid)
        if fut is None or not fut.done():
            return None
        err = fut.exception()
        if err is None:
            return "done", fut.result()
        return "failed", err

    def retract(self, rid: str) -> None:
        self._futures.pop(rid, None)

    def heartbeat(self) -> Optional[Dict]:
        if self._killed:
            return None
        return {"t": time.time(), "name": self.name,
                "pending": self.service.queue.depth(),
                "draining": self.service._draining.is_set()}

    def alive(self) -> Optional[bool]:
        return not self._killed

    def published_load(self) -> Optional[Dict]:
        """In-process transport: the service's live queue IS the
        published signal (no exposition file round-trip), gated on the
        same kill switch so routing behavior matches the spool
        transport's never-published fallback."""
        from ..telemetry import registry as telemetry_registry
        if self._killed or not telemetry_registry.enabled():
            return None
        return {"queue_depth": float(self.service.queue.depth()),
                "drain_rate_rps": self.service.queue.drain_rate() or 0.0,
                "pending": 0.0}

    def kill(self, hard: bool = False) -> None:
        self._killed = True
        if hard:
            self.service.request_stop()

    def read_memory_export(self) -> Optional[bytes]:
        mem = self.service.solver_cache.memory
        if mem is None:
            return None
        # entries + learned seed models (ops/seedpredict.py) in one
        # payload; import_payload on the receiving side accepts both
        # this dict and the older bare-entries list
        return pickle.dumps(mem.export_payload(),
                            protocol=pickle.HIGHEST_PROTOCOL)

    def import_memory(self, blob: bytes) -> None:
        mem = self.service.solver_cache.memory
        if mem is not None:
            mem.import_payload(pickle.loads(blob))

    def snapshot(self) -> Dict:
        return {"name": self.name, "state": self.state,
                "local": True, "killed": self._killed}


# ---------------------------------------------------------------------------
# Replica process spawning
# ---------------------------------------------------------------------------

def spawn_replica(spool, *, name: Optional[str] = None,
                  backend: str = "torch", device: str = "cuda:0",
                  heartbeat_s: float = 0.25,
                  poll_s: float = 0.05, max_queue_depth: int = 64,
                  epoch: Optional[int] = None,
                  extra_args: Optional[List[str]] = None,
                  env: Optional[Dict[str, str]] = None,
                  stdout=subprocess.DEVNULL,
                  stderr=subprocess.DEVNULL) -> SpoolReplica:
    """Launch one ``python -m dervet_tpu_torch serve`` replica process
    over ``spool`` and return its :class:`SpoolReplica` handle (process
    attached, so the router can fence it).

    ``device`` is the child's ``--device`` (default ``cuda:0``: every
    replica of a one-card fleet shares it, each with a CUDA context of
    its own); ``device="cpu"`` runs the kernels' plain versions on the
    CPU, as the CPU tests do.  A child that finds no GPU for a ``cuda``
    device fails to start — it never serves on the CPU instead.
    ``backend="cpu"`` solves on HiGHS.  ``env`` is merged into the
    child's environment (fault plans are armed this way, never in the
    parent).

    ``epoch`` is the incarnation number the lifecycle supervisor bumps
    on every respawn over a reused spool: the child stamps it into each
    heartbeat, and the router only credits beats at or above the
    handle's epoch — a fenced zombie still writing the old spool can
    never impersonate its replacement."""
    spool = Path(spool)
    spool.mkdir(parents=True, exist_ok=True)
    # a reused spool's previous-incarnation heartbeat must not be read
    # as this replica's (the router also grants startup grace until the
    # first FRESH beat, but a stale file is simply wrong state)
    try:
        (spool / HEARTBEAT_FILE).unlink()
    except FileNotFoundError:
        pass
    name = name or spool.name
    argv = [str(spool), "--backend", backend, "--device", str(device),
            "--poll-s", str(poll_s), "--heartbeat-s", str(heartbeat_s),
            "--max-queue-depth", str(max_queue_depth),
            "--replica-name", name] + \
        (["--heartbeat-epoch", str(int(epoch))]
         if epoch is not None else []) + list(extra_args or [])
    child_env = dict(os.environ)
    # the child must import THIS checkout's dervet_tpu_torch even when
    # the package is not pip-installed (test runs from the repo root)
    repo_root = str(Path(__file__).resolve().parents[2])
    child_env["PYTHONPATH"] = repo_root + os.pathsep + \
        child_env.get("PYTHONPATH", "")
    child_env.update(env or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", "dervet_tpu_torch", "serve"] + argv,
        env=child_env, stdout=stdout, stderr=stderr)
    handle = SpoolReplica(name, spool, process=proc)
    if epoch is not None:
        handle.epoch = int(epoch)
    return handle
