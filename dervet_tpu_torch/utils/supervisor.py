"""Run supervisor: preemption-safe sweeps on interruptible hardware.

The dispatch engine targets preemptible accelerators, where a SIGTERM can
arrive at any window batch and a wedged device call can stall a sweep
indefinitely.  PR 1's resilience ladder covers *solver* failure inside a
window; this layer covers the *run*:

* **Graceful shutdown** — :class:`RunSupervisor` installs SIGTERM/SIGINT
  handlers that set a stop flag; ``run_dispatch`` checks it at
  window-batch boundaries, flushes every case's checkpoint plus the
  sweep-level resume manifest, and raises
  :class:`~dervet_tpu.utils.errors.PreemptedError` (CLI exit code
  :data:`EXIT_PREEMPTED`).
* **Resume manifest** — ``run_manifest.json`` in the checkpoint
  directory records per-case status (``done``/``partial``/
  ``quarantined``), the case input fingerprint, and completed-window
  counts.  A re-run with the same ``checkpoint_dir`` skips fully-``done``
  cases entirely (reloading their persisted results) instead of only
  skipping windows inside a case.
* **Solve watchdog** — :class:`SolveWatchdog` bounds each dispatch-loop
  solve with a configurable deadline (``DERVET_TPU_SOLVE_DEADLINE_S``);
  a hung device call is detected, recorded in the run-health report
  (``watchdog_timeouts``), and escalated down the existing ladder
  instead of stalling the process.
* **Crash-safe writes** — :func:`atomic_write` / :func:`atomic_output`
  (tmp + fsync + ``os.replace``) back every result/health/manifest/
  checkpoint write, so a kill mid-write leaves the previous complete
  file, never a truncated one.

GPU/TPU first-order LP stacks (PAPERS.md: MPAX, DuaLip) treat long PDHG
runs as restartable jobs; this module applies the same contract to the
whole multi-case sweep.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
from pathlib import Path
from typing import Dict, Optional

from .errors import TellUser

# EX_TEMPFAIL: the sysexits code for "transient failure, retry later" —
# distinct from 1 (error) so schedulers can requeue a preempted run
EXIT_PREEMPTED = 75

MANIFEST_NAME = "run_manifest.json"
MANIFEST_VERSION = 1

DEADLINE_ENV = "DERVET_TPU_SOLVE_DEADLINE_S"


# ---------------------------------------------------------------------------
# Crash-safe writes
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def atomic_output(path):
    """Yield a temporary sibling path to write into; on clean exit fsync
    it and ``os.replace`` it over ``path`` (the checkpoint idiom, now the
    ONE write path for results/health/manifest files).  An interruption
    mid-write leaves the previous complete file untouched and at most a
    stale tmp file behind.

    The tmp keeps ``path``'s suffix (``.foo.tmp.npz``, not
    ``foo.npz.tmp``) so suffix-appending writers like ``np.savez`` hit
    the intended name, and leads with a dot so output-dir globs never
    pick a half-written file up."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.stem}.tmp{path.suffix}")
    try:
        yield tmp
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
        # fsync the directory so the rename itself survives a crash;
        # best-effort — not every filesystem supports O_DIRECTORY fsync
        try:
            dfd = os.open(path.parent, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass
    except BaseException:
        with contextlib.suppress(OSError):
            tmp.unlink()
        raise


def atomic_write(path, data) -> None:
    """Crash-safe small-file write (str or bytes) via :func:`atomic_output`."""
    with atomic_output(path) as tmp:
        if isinstance(data, str):
            tmp.write_text(data)
        else:
            tmp.write_bytes(data)


# ---------------------------------------------------------------------------
# Sweep-level resume manifest
# ---------------------------------------------------------------------------

def manifest_path(checkpoint_dir, request_id=None) -> Path:
    # request-namespaced manifests (run_manifest.<rid>.json) are the
    # scenario service's per-request resume/reporting slices; the bare
    # name stays the whole-sweep manifest the resume path consults
    from ..io.summary import run_artifact_name
    return Path(checkpoint_dir) / run_artifact_name(MANIFEST_NAME,
                                                    request_id)


def write_manifest(checkpoint_dir, scenarios, backend: str = "",
                   request_id=None) -> Dict:
    """Write ``run_manifest.json``: the sweep-level resume picture.

    Per case: ``status`` (``done`` — every window solved, or no dispatch
    needed; ``partial`` — interrupted with windows outstanding;
    ``quarantined`` — dropped by the failure-isolation layer with its
    diagnosis), the input ``fingerprint`` the per-case checkpoint is
    keyed by, and window counts.  Keys are case ids as strings; colliding
    caller-supplied ids overwrite each other here, which is safe — resume
    re-verifies the fingerprint per scenario before skipping anything.

    ``request_id`` (scenario service) writes a per-request slice under a
    namespaced filename instead — concurrent requests in one process get
    their own manifests and cannot clobber each other's."""
    cases = {}
    for s in scenarios:
        total = len(s.windows)
        solved = len(getattr(s, "_solved", ()) or ())
        if s.quarantine is not None:
            status = "quarantined"
        elif not s.opt_engine or solved >= total:
            status = "done"
        else:
            status = "partial"
        cases[str(s.case.case_id)] = {
            "status": status,
            "fingerprint": s._checkpoint_fingerprint(),
            "windows_total": total,
            "windows_done": solved,
            "reason": (s.quarantine or {}).get("reason"),
        }
    manifest = {"version": MANIFEST_VERSION, "backend": backend,
                "cases": cases}
    if request_id is not None:
        manifest["request_id"] = str(request_id)
    atomic_write(manifest_path(checkpoint_dir, request_id),
                 json.dumps(manifest, indent=2))
    return manifest


def load_manifest(checkpoint_dir) -> Optional[Dict]:
    """Read a prior run's manifest; a missing, corrupt, or
    wrong-version file is treated as absent (resume then falls back to
    the per-window checkpoint path, which self-verifies)."""
    path = manifest_path(checkpoint_dir)
    if not path.exists():
        return None
    try:
        manifest = json.loads(path.read_text())
        if manifest.get("version") != MANIFEST_VERSION or \
                not isinstance(manifest.get("cases"), dict):
            TellUser.warning(f"ignoring {path}: unrecognized manifest "
                             f"version {manifest.get('version')!r}")
            return None
        return manifest
    except (OSError, ValueError) as e:
        TellUser.warning(f"ignoring unreadable run manifest {path}: {e}")
        return None


# ---------------------------------------------------------------------------
# Solve watchdog
# ---------------------------------------------------------------------------

class SolveWatchdog:
    """Deadline guard for one dispatch-loop solve call.

    ``call(fn)`` runs ``fn`` on a daemon worker and waits up to the
    deadline from a monitor (the calling) thread.  A call that overruns
    is *abandoned* — a wedged device call cannot be cancelled from
    Python, but the dispatch loop regains control, records the timeout in
    the health report, and escalates the affected windows down the
    existing ladder (retry -> exact CPU fallback -> quarantine) instead
    of stalling the whole sweep.  Off unless ``DERVET_TPU_SOLVE_DEADLINE_S``
    is set: the extra thread per solve is only worth paying when a
    deadline is actually enforced.

    Caveats of abandoning: the deadline must also cover the FIRST solve's
    XLA compile (~10-40 s on a cold remote chip), or the compile itself is
    read as a hang; and an abandoned thread still wedged inside the device
    runtime at process exit can abort interpreter teardown — ugly, but
    after the results are flushed, and strictly better than hanging
    forever."""

    def __init__(self, deadline_s: float):
        self.deadline_s = float(deadline_s)
        self.timeouts = 0

    @classmethod
    def from_env(cls) -> Optional["SolveWatchdog"]:
        raw = os.environ.get(DEADLINE_ENV, "").strip()
        if not raw:
            return None
        try:
            deadline = float(raw)
        except ValueError:
            TellUser.warning(f"{DEADLINE_ENV}={raw!r} is not a number — "
                             "solve watchdog disabled")
            return None
        return cls(deadline) if deadline > 0 else None

    def call(self, fn, what: str = "solve"):
        """Returns ``(result, timed_out)``; on timeout the result is
        None and the worker is left behind (daemon, so it never blocks
        process exit).  Exceptions raised by ``fn`` propagate."""
        box: Dict[str, object] = {}

        def _run():
            try:
                box["result"] = fn()
            except BaseException as e:      # re-raised on the caller
                box["error"] = e

        worker = threading.Thread(target=_run, daemon=True,
                                  name=f"dervet-solve[{what}]")
        worker.start()
        worker.join(self.deadline_s)
        if worker.is_alive():
            self.timeouts += 1
            TellUser.error(
                f"watchdog: {what} exceeded the {self.deadline_s:g}s "
                f"deadline ({DEADLINE_ENV}) — abandoning the call and "
                "escalating")
            return None, True
        err = box.get("error")
        if err is not None:
            raise err
        return box.get("result"), False


# ---------------------------------------------------------------------------
# Run supervisor (graceful shutdown)
# ---------------------------------------------------------------------------

class RunSupervisor:
    """Sweep-scoped stop-flag + signal handling, used as a context
    manager around ``run_dispatch``.

    The first SIGTERM/SIGINT only *requests* a stop: the dispatch loop
    finishes the in-flight window batch, flushes checkpoints + manifest,
    and raises ``PreemptedError``.  A second signal restores the default
    disposition and re-delivers itself — the escape hatch when even the
    graceful path is wedged.  Signal handlers can only be installed from
    the main thread; elsewhere (e.g. a test worker) the supervisor still
    works as a plain stop-flag via :meth:`request_stop`."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, install_signals: bool = True, on_stop=None):
        self._stop = threading.Event()
        self._install = install_signals
        self._previous: Dict[int, object] = {}
        self.stop_signal: Optional[int] = None
        self.watchdog = SolveWatchdog.from_env()
        # on_stop: invoked ONCE when the stop is first requested — the
        # scenario service uses it to close admissions the instant the
        # drain signal lands.  It may run in signal-handler context, so
        # it must be lock-free (set events/flags only).
        self._on_stop = on_stop

    # -- stop flag ------------------------------------------------------
    def stop_requested(self) -> bool:
        return self._stop.is_set()

    def wait_stop(self, timeout: Optional[float] = None) -> bool:
        """Block until a stop is requested (or ``timeout``); returns the
        flag state — the poll primitive for service/serve loops."""
        return self._stop.wait(timeout)

    def request_stop(self, signum: Optional[int] = None) -> None:
        first = not self._stop.is_set()
        self.stop_signal = signum
        self._stop.set()
        if first and self._on_stop is not None:
            try:
                self._on_stop()
            except Exception:
                pass    # a failing hook must never break the stop path

    # -- signal plumbing ------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        if self._stop.is_set():
            # second signal: give up on graceful — restore the default
            # handler and re-deliver so the process dies with the
            # conventional signal exit status
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        self.request_stop(signum)
        TellUser.warning(
            f"received signal {signum}: finishing the in-flight window "
            "batch, then flushing checkpoints + run manifest and exiting "
            f"with code {EXIT_PREEMPTED} (send again to abort immediately)")

    def __enter__(self) -> "RunSupervisor":
        if self._install:
            try:
                for sig in self.SIGNALS:
                    self._previous[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                # not the main thread: signals stay with the process's
                # existing handlers; the stop flag still works
                self._previous.clear()
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        return None
