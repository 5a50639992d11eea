"""Crash-safe service journal: the serve loop's append-only ledger.

The drain path covers the POLITE kill (SIGTERM: close admissions,
finish or checkpoint the round, flush manifests, exit 0).  A SIGKILL /
OOM / power loss gets none of that — so the serve loop journals every
spool admission and completion to an append-only JSONL file (one
``write + flush + fsync`` per event; a torn final line from a crash
mid-append is tolerated and ignored on replay).  On startup the loop
replays the journal and reconciles the spool:

* ``admitted`` with no terminal event + input file still in
  ``incoming/`` — the round died with the request in flight; the normal
  scan re-serves it, and solved-window checkpoints bound the re-work.
  Results are re-written atomically, so recovery is idempotent.
* ``completed``/``failed`` but the input file still in ``incoming/`` —
  the kill landed between recording the outcome and moving the file;
  the file is moved to its terminal directory WITHOUT re-serving.

Event order in the happy path is deliberate: results are persisted
first, THEN ``completed`` is journaled, THEN the input file moves — so
at every kill point the journal either under-claims (re-serve, idempotent)
or exactly matches the spool, never over-claims a result that does not
exist on disk.
"""
from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..utils.errors import TellUser

TERMINAL_EVENTS = ("completed", "failed")
# a hedge loser retracted before admission (fleet router cancel): not a
# terminal answer, but recovery must finish its input-file removal, not
# re-serve it
CANCELLED_EVENT = "cancelled"


class ServiceJournal:
    """Append-only admissions/completions journal for one spool."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        # line-buffered append handle held for the process life; every
        # event fsyncs so the journal survives a SIGKILL mid-round
        self._fh = open(self.path, "a", encoding="utf-8")

    # ------------------------------------------------------------------
    def _append(self, event: str, rid: str, **extra) -> None:
        # wall + MONOTONIC timestamp pair: replay/`dervet_tpu_torch trace` can
        # order pre-crash events robustly (mono never steps backwards
        # within one process incarnation) while the wall time anchors
        # them against other processes' traces.  Readers tolerate
        # records without these fields (journals older than these fields).
        rec = {"event": event, "rid": str(rid), "t": round(time.time(), 3),
               "mono": round(time.monotonic(), 6),
               **{k: v for k, v in extra.items() if v is not None}}
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def admitted(self, rid: str, file: Optional[str] = None,
                 trace_id: Optional[str] = None) -> None:
        self._append("admitted", rid, trace_id=trace_id,
                     **({"file": str(file)} if file else {}))

    def completed(self, rid: str,
                  trace_id: Optional[str] = None) -> None:
        self._append("completed", rid, trace_id=trace_id)

    def failed(self, rid: str, error: Optional[Dict] = None,
               trace_id: Optional[str] = None) -> None:
        self._append("failed", rid, trace_id=trace_id,
                     **({"error": error} if error else {}))

    def note(self, event: str, rid: str, **extra) -> None:
        """Journal an arbitrary event (fsync'd like the rest).  The
        fleet layer uses this for its routing ledger (``routed`` /
        ``rerouted`` / ``hedged`` / ``cancelled``) on top of the three
        spool events above."""
        self._append(str(event), rid, **extra)

    def close(self) -> None:
        with self._lock:
            self._fh.close()

    # ------------------------------------------------------------------
    @staticmethod
    def replay_path(path) -> Dict[str, Dict]:
        """Read-only replay of a journal file that may belong to ANOTHER
        process (the fleet router inspecting a dead replica's spool) —
        no append handle is opened, so this never touches the file."""
        out: Dict[str, Dict] = {}
        path = Path(path)
        if not path.exists():
            return out
        for line in path.read_text(encoding="utf-8").splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue        # torn tail from a hard kill: ignore
            rid = str(rec.get("rid"))
            entry = out.setdefault(rid, {"state": None, "file": None})
            event = rec.get("event")
            # terminal states are FINAL: a non-terminal note appended
            # after completed/failed (a late hedge/reroute record, a
            # request-cache annotation) must not resurrect the rid into
            # a replayable state — recovery would re-serve an already
            # answered request.  Cancellation may still supersede (the
            # retract-vs-answer race resolves toward the cancel record,
            # which only finishes a file removal).
            if entry["state"] in TERMINAL_EVENTS and \
                    event not in TERMINAL_EVENTS + (CANCELLED_EVENT,):
                pass
            else:
                entry["state"] = event
            if rec.get("file"):
                entry["file"] = rec["file"]
            if rec.get("trace_id"):
                # pre-crash timeline reconstruction (telemetry/ops.py)
                entry["trace_id"] = rec["trace_id"]
        return out

    def replay(self) -> Dict[str, Dict]:
        """Reconstruct each request id's LAST journaled state:
        ``rid -> {"state": admitted|completed|failed, "file": ...}``.
        A torn final line (crash mid-append) is skipped, not fatal."""
        with self._lock:
            self._fh.flush()
        return self.replay_path(self.path)

    def unfinished(self) -> List[Tuple[str, Optional[str]]]:
        """Request ids admitted but never terminal — the set a restarted
        serve loop must recover."""
        return [(rid, e.get("file")) for rid, e in self.replay().items()
                if e["state"] == "admitted"]

    # ------------------------------------------------------------------
    def recover_spool(self, incoming: Path, done_dir: Path,
                      failed_dir: Optional[Path] = None) -> Dict:
        """Post-SIGKILL reconciliation (called at serve startup).

        Returns ``{"reserve": [rids...], "moved": [rids...]}``:
        ``reserve`` are admitted-but-unanswered requests whose input
        files still sit in ``incoming/`` — the scan loop re-serves them
        (idempotently: results re-write atomically, checkpoints bound
        re-work); ``moved`` are terminal requests whose file move was
        lost to the kill — finished now (``completed`` -> ``done/``,
        ``failed`` -> ``failed/``), NOT re-served."""
        reserve: List[str] = []
        moved: List[str] = []
        for rid, entry in self.replay().items():
            fname = entry.get("file")
            src = (incoming / fname) if fname else None
            if src is None or not src.exists():
                continue
            if entry["state"] == "admitted":
                reserve.append(rid)
            elif entry["state"] == CANCELLED_EVENT:
                # kill landed between journaling the cancel and removing
                # the input: finish the removal, never re-serve a
                # retracted hedge loser
                try:
                    src.unlink()
                except FileNotFoundError:
                    pass
            elif entry["state"] in TERMINAL_EVENTS:
                # a journaled FAILURE must not be misfiled as a success
                target = (failed_dir if entry["state"] == "failed"
                          and failed_dir is not None else done_dir)
                try:
                    src.replace(target / src.name)
                except FileNotFoundError:
                    # a CONCURRENT recovery (router failover firing while
                    # the replica restarts) won the move between our
                    # exists() check and the replace — the outcome is the
                    # same file in the same terminal directory, so the
                    # race is benign; claiming the move twice is not
                    continue
                moved.append(rid)
        if reserve or moved:
            TellUser.warning(
                f"serve: journal recovery after hard kill — "
                f"{len(reserve)} unanswered request(s) will be "
                f"re-served, {len(moved)} completed file move(s) "
                "replayed")
        return {"reserve": reserve, "moved": moved}
