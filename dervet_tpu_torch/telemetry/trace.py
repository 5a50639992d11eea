"""Zero-dependency request tracing: a span tree that follows one request
across the whole serving stack.

The serving path is now router -> replica transport -> admission queue ->
continuous batcher -> (elastic) dispatch groups -> escalation rungs ->
certification, plus the design-screen and portfolio-dual-loop phases —
and until now no single record followed one request across those hops
(the solve ledger is per-round, ``run_health`` per-request-after-the-
fact, ``metrics()`` point-in-time).  A *trace* is that record: a tree of
**spans** (one per hop, monotonic-clock durations anchored to one wall
timestamp) sharing a ``trace_id``, with typed attributes (the solve
ledger entry IS the attribute payload of a dispatch-group span) and
point events (warm-start grades, breaker decisions, failover/hedge/
harvest, certification rejections).

Design constraints, in order:

* **Kill switch is a real kill switch** — ``DERVET_TPU_TELEMETRY=0``
  makes every span constructor return the singleton no-op span: no
  allocation beyond the enabled() check, no locks, no files, and the
  solve path is untouched either way (tracing only ever *observes*;
  bench gate: warm-serving p50 regression < 2% with telemetry ON).
* **Zero dependencies** — stdlib only, importable from the deepest ops
  code without dragging jax/pandas in.
* **Cross-process stitching** — the trace id is DERIVED from the request
  id (:func:`trace_id_for`), and trace context additionally rides the
  fleet transport payload, so the router process and every replica
  process agree on the id even across a SIGKILL failover; the ``trace``
  CLI stitches their exported ``trace.<rid>.json`` files into one tree.

**Phases** (:func:`phase`) are the run-scoped half: one ``with`` block
for each phase of the product entry (``DERVET.solve``'s ``valuation``
root, prep, dispatch, the groups, rungs, solver builds, captures,
certification, the outage walks, post).  A phase always times itself
(one clock pair) and adds its duration under its key to its own and
every enclosing phase's ``totals`` — ``Result.phase_seconds`` and the
dispatch metadata read those sums, telemetry on or off.  It records a
span only when telemetry is on AND its parent records (a root phase, a
recording phase, or a request's span), so a direct solver call (the
price sweep, ``ops.solve_lp``) or a service round records nothing and
leaves no orphan in the collector.  A root phase takes its tree out of
the collector as it exits (:attr:`Phase.trace`, ``Result.trace``); it
is written only on request: ``export_chrome_trace(result.trace,
path)``.  Phases emit no profiler range: a span's ``t_start`` is
``time.time()``, the clock the profiler stamps its events with, so the
two timelines join as they are.

Thread model: span creation/finish may happen on any thread (the
collector is lock-protected).  Ambient parenting (``with span(...)``)
is per-thread; code that crosses threads — the batcher handing a request
to pool workers, the elastic device workers — parents explicitly via the
request registry (:func:`register_request` / :func:`context_for_request`)
keyed by the request id that already rides :class:`MicrogridScenario`.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import threading
import time
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional

ENV = "DERVET_TPU_TELEMETRY"

# bounded collector: a service that never dies must not grow one span
# list per request forever (traces evict LRU once delivered/exported)
MAX_TRACES = 512
MAX_SPANS_PER_TRACE = 8192
MAX_REQUEST_CONTEXTS = 4096


def enabled() -> bool:
    """Telemetry kill switch (``DERVET_TPU_TELEMETRY=0`` off).  Read per
    call so tests (and a live operator) can flip it without restarting;
    a dict lookup + compare is the entire disabled-path cost."""
    return os.environ.get(ENV, "1").strip().lower() \
        not in ("0", "false", "off")


def trace_id_for(rid) -> str:
    """Deterministic trace id for a request id: every process that sees
    ``rid`` (router, replica, post-crash recovery, the ``trace`` CLI)
    derives the same id, so stitching never depends on in-band context
    having survived."""
    return hashlib.sha256(f"dervet-trace:{rid}".encode()).hexdigest()[:32]


_span_seq = itertools.count(1)


def _new_span_id() -> str:
    # unique across processes: pid + in-process counter (no randomness —
    # dispatch determinism contracts forbid entropy on this path)
    return f"{os.getpid():08x}-{next(_span_seq):06x}"


class _NoopSpan:
    """The disabled-path span: every method is a no-op, every child is
    itself.  One shared instance, so the hot path allocates nothing."""

    __slots__ = ()
    recording = False
    trace_id = None
    span_id = None

    def set_attr(self, key, value):
        return self

    def set_attrs(self, attrs):
        return self

    def event(self, name, **attrs):
        return self

    def child(self, name, **attrs):
        return self

    def end(self, error=None):
        return self

    def ctx(self):
        return None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def __bool__(self):
        # `if span:` reads as "is telemetry recording this?"
        return False


NOOP = _NoopSpan()


class Span:
    """One timed hop.  Create via :func:`start_span` / :func:`span` (the
    constructor itself never checks the kill switch)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t_start",
                 "_t0_mono", "duration_s", "attrs", "events", "status",
                 "_ambient", "_ended")
    recording = True

    def __init__(self, name: str, trace_id: str,
                 parent_id: Optional[str] = None,
                 t_start: Optional[float] = None,
                 duration_s: Optional[float] = None,
                 attrs: Optional[Dict] = None):
        self.name = str(name)
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        # wall anchor + monotonic duration: the exported record is wall-
        # timestamped (stitchable across processes) but durations never
        # go negative under clock steps
        self.t_start = time.time() if t_start is None else float(t_start)
        self._t0_mono = time.monotonic()
        self.duration_s = duration_s
        self.attrs: Dict = dict(attrs) if attrs else {}
        self.events: List[Dict] = []
        self.status = "ok"
        self._ambient = False
        self._ended = duration_s is not None
        if self._ended:
            COLLECTOR.add(self)

    # -- recording ------------------------------------------------------
    def set_attr(self, key, value) -> "Span":
        self.attrs[str(key)] = value
        return self

    def set_attrs(self, attrs: Dict) -> "Span":
        for k, v in attrs.items():
            self.attrs[str(k)] = v
        return self

    def event(self, name: str, **attrs) -> "Span":
        ev = {"name": str(name), "t": round(time.time(), 6)}
        if attrs:
            ev["attrs"] = attrs
        self.events.append(ev)
        return self

    def child(self, name: str, **attrs) -> "Span":
        if not enabled():
            return NOOP
        return Span(name, self.trace_id, parent_id=self.span_id,
                    attrs=attrs or None)

    def ctx(self) -> Dict:
        """The propagation context: what rides a transport payload."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def end(self, error=None) -> "Span":
        if self._ended:
            return self
        return self._close(time.monotonic() - self._t0_mono, error)

    def _close(self, duration_s: float, error=None) -> "Span":
        self._ended = True
        self.duration_s = duration_s
        if error is not None:
            self.status = "error"
            self.attrs.setdefault("error", f"{type(error).__name__}: "
                                           f"{error}"
                                  if isinstance(error, BaseException)
                                  else str(error))
        COLLECTOR.add(self)
        return self

    # -- ambient context manager ---------------------------------------
    def __enter__(self) -> "Span":
        _tls_stack().append(self)
        self._ambient = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._ambient:
            stack = _tls_stack()
            if stack and stack[-1] is self:
                stack.pop()
            self._ambient = False
        self.end(error=exc)
        return False

    def __bool__(self):
        return True

    def to_dict(self) -> Dict:
        out = {"trace_id": self.trace_id, "span_id": self.span_id,
               "parent_id": self.parent_id, "name": self.name,
               "t_start": round(self.t_start, 6),
               "duration_s": (round(self.duration_s, 6)
                              if self.duration_s is not None else None),
               "status": self.status}
        if self.attrs:
            out["attrs"] = self.attrs
        if self.events:
            out["events"] = self.events
        return out


# ---------------------------------------------------------------------------
# Ambient (per-thread) parenting
# ---------------------------------------------------------------------------

_tls = threading.local()


def _tls_stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current():
    """The calling thread's innermost open span or phase (None if none)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


# ---------------------------------------------------------------------------
# Collector: finished spans per trace + the request-context registry
# ---------------------------------------------------------------------------

class _Collector:
    def __init__(self):
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, List[Dict]]" = OrderedDict()
        # rid -> Span: where deep code (resolve_group on a worker
        # thread, the portfolio loop) finds the parent for request-
        # scoped spans without any plumbing through the solve stack
        self._requests: "OrderedDict[str, Span]" = OrderedDict()
        self.dropped = 0

    def add(self, span: Span) -> None:
        rec = span.to_dict()
        with self._lock:
            spans = self._traces.get(span.trace_id)
            if spans is None:
                spans = self._traces[span.trace_id] = []
                while len(self._traces) > MAX_TRACES:
                    self._traces.popitem(last=False)
            self._traces.move_to_end(span.trace_id)
            if len(spans) >= MAX_SPANS_PER_TRACE:
                self.dropped += 1
                return
            spans.append(rec)

    def spans(self, trace_id: str) -> List[Dict]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def pop(self, trace_id: str) -> List[Dict]:
        with self._lock:
            return self._traces.pop(trace_id, [])

    # -- request registry ----------------------------------------------
    def register_request(self, rid, span: Span) -> None:
        with self._lock:
            self._requests[str(rid)] = span
            self._requests.move_to_end(str(rid))
            while len(self._requests) > MAX_REQUEST_CONTEXTS:
                self._requests.popitem(last=False)

    def context_for_request(self, rid) -> Optional[Span]:
        with self._lock:
            return self._requests.get(str(rid))

    def release_request(self, rid) -> None:
        with self._lock:
            self._requests.pop(str(rid), None)

    def reset(self) -> None:
        """Test hook: drop every collected trace and registration."""
        with self._lock:
            self._traces.clear()
            self._requests.clear()
            self.dropped = 0


COLLECTOR = _Collector()

register_request = COLLECTOR.register_request
context_for_request = COLLECTOR.context_for_request
release_request = COLLECTOR.release_request


def trace_id_of(rid) -> Optional[str]:
    """The trace id a live request is recording under (None when
    telemetry is off or the request was never registered)."""
    span = COLLECTOR.context_for_request(rid)
    return span.trace_id if span is not None else None


# ---------------------------------------------------------------------------
# Span construction
# ---------------------------------------------------------------------------

def start_span(name: str, *, parent=None, trace_id: Optional[str] = None,
               rid=None, t_start: Optional[float] = None,
               duration_s: Optional[float] = None,
               attrs: Optional[Dict] = None):
    """Start one span (the caller ends it).  Returns :data:`NOOP` when
    telemetry is off.

    Parent resolution, most explicit first: ``parent`` (a :class:`Span`,
    a :class:`Phase`, or a ``{"trace_id", "span_id"}`` context dict, e.g.
    off a transport payload), then the span registered for ``rid``, then
    the calling thread's ambient span or phase, else a root
    (``trace_id`` defaults to :func:`trace_id_for` of ``rid`` when given,
    else a fresh id)."""
    if not enabled():
        return NOOP
    parent_id = None
    if parent is None and rid is not None:
        parent = COLLECTOR.context_for_request(rid)
    if parent is None:
        parent = current()
    if isinstance(parent, Phase):
        parent = parent.span
    if isinstance(parent, Span):
        trace_id = trace_id or parent.trace_id
        parent_id = parent.span_id
    elif isinstance(parent, dict) and parent.get("trace_id"):
        trace_id = trace_id or str(parent["trace_id"])
        parent_id = (str(parent["span_id"])
                     if parent.get("span_id") else None)
    if trace_id is None:
        trace_id = trace_id_for(rid) if rid is not None \
            else _new_span_id()
    return Span(name, trace_id, parent_id=parent_id, t_start=t_start,
                duration_s=duration_s, attrs=attrs)


def span(name: str, **attrs):
    """Ambient-parented span for ``with`` blocks."""
    return start_span(name, attrs=attrs or None)


# ---------------------------------------------------------------------------
# Phases: timed always, recorded under a recording parent
# ---------------------------------------------------------------------------

_totals_lock = threading.Lock()


class Phase:
    """One phase of a run (see :func:`phase`).  ``elapsed`` holds its
    seconds once the block exits; ``totals`` the per-key sums of it and
    every keyed phase below it, on any thread; a root phase's ``trace``
    the finished spans of its tree (empty when telemetry was off)."""

    __slots__ = ("name", "key", "parent", "attrs", "totals", "span",
                 "mirrors", "t_start", "elapsed", "trace", "_root", "_t0")

    def __init__(self, name: str, key: Optional[str] = None, parent=None,
                 root: bool = False, mirrors=(), attrs=None):
        self.name = name
        self.key = key
        self.parent = parent
        self.attrs: Dict = dict(attrs) if attrs else {}
        self.totals: Dict[str, float] = {}
        self.span: Optional[Span] = None
        self.mirrors = mirrors
        self.elapsed: Optional[float] = None
        self.trace: List[Dict] = []
        self._root = root

    def set_attr(self, key, value) -> "Phase":
        self.attrs[str(key)] = value
        return self

    def set_attrs(self, attrs: Dict) -> "Phase":
        for k, v in attrs.items():
            self.attrs[str(k)] = v
        return self

    def __enter__(self) -> "Phase":
        self.t_start = time.time()
        self._t0 = time.monotonic()
        if enabled():
            up = (self.parent.span if isinstance(self.parent, Phase)
                  else self.parent)
            if self._root:
                self.span = Span(self.name, _new_span_id(),
                                 t_start=self.t_start)
            elif isinstance(up, Span):
                self.span = Span(self.name, up.trace_id,
                                 parent_id=up.span_id, t_start=self.t_start)
        _tls_stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        self.elapsed = time.monotonic() - self._t0
        stack = _tls_stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self.key is not None:
            with _totals_lock:
                p = self
                while isinstance(p, Phase):
                    p.totals[self.key] = \
                        p.totals.get(self.key, 0.0) + self.elapsed
                    p = p.parent
        if self.span is not None:
            self.span.set_attrs(self.attrs)
            # the thread names the phase's lane, and which of its
            # children ran on its own thread
            self.span.set_attr("thread", threading.current_thread().name)
            self.span._close(self.elapsed, exc)
            if self._root:
                # the run's tree leaves the collector with its root
                self.trace = COLLECTOR.pop(self.span.trace_id)
        for up in self.mirrors:
            start_span(self.name, parent=up, t_start=self.t_start,
                       duration_s=self.elapsed, attrs=self.attrs)
        return False

    def __bool__(self):
        # as with spans: `if ph:` reads "is telemetry recording this?"
        return self.span is not None


class ambient:
    """``with ambient(parent):`` makes ``parent`` (a span or phase, or
    None) the calling thread's innermost one for the block, untimed: a
    thread that runs work on another's behalf keeps its phases in place
    in the trace and in the sums."""

    __slots__ = ("parent",)

    def __init__(self, parent):
        self.parent = parent

    def __enter__(self):
        _tls_stack().append(self.parent)
        return self.parent

    def __exit__(self, exc_type, exc, tb):
        stack = _tls_stack()
        if stack and stack[-1] is self.parent:
            stack.pop()
        return False


def phase(name: str, key: Optional[str] = None, *, parent=None,
          root: bool = False, mirrors=(), **attrs) -> Phase:
    """A phase of a run, for ``with`` blocks.

    The block is always timed, and with ``key`` its seconds add to the
    ``totals`` of the phase and of every phase above it.  ``parent`` (a
    :class:`Phase` or a request's :class:`Span`) defaults to the calling
    thread's innermost span or phase; work handed to another thread
    passes it.  A span is recorded only when telemetry is on and the
    parent records; ``root`` starts a run of its own (no parent), whose
    spans :attr:`Phase.trace` holds once it exits.  ``mirrors`` are
    request spans that get a finished copy of this one as a child (a
    request's trace through a batched round).  No profiler range is
    emitted."""
    if root:
        parent = None
    elif parent is None:
        parent = current()
    return Phase(name, key, parent, root, mirrors, attrs)


# ---------------------------------------------------------------------------
# Export / tree assembly
# ---------------------------------------------------------------------------

def _atomic_write_text(path, text: str) -> None:
    # the codebase's ONE atomic-write path (dot-tmp + fsync + replace);
    # utils.supervisor is stdlib-only, so this module stays light
    from ..utils.supervisor import atomic_write
    atomic_write(path, text)


def export_request_trace(rid, out_dir, trace_id: Optional[str] = None,
                         pop: bool = True, chrome: bool = False,
                         merge: bool = False) -> Optional[Path]:
    """Write ``trace.<rid>.json`` for one request into ``out_dir``
    (created if needed).  Returns the path, or None when telemetry is
    off / no spans were recorded.  ``pop`` drops the trace from the
    collector after export (the serving loop's delivery path — a
    long-lived process must not keep delivered traces pinned);
    ``chrome`` also writes the ``trace.<rid>.chrome.json`` timeline
    from the same in-memory spans.  ``merge`` unions with an existing
    export instead of clobbering it — the late-answer path: a span that
    ended after the request's trace was already exported (a hedge or
    failover loser) re-enters the collector as an orphan entry, and the
    merged re-export both records its timing and frees the slot."""
    if not enabled():
        return None
    tid = trace_id or trace_id_of(rid) or trace_id_for(rid)
    spans = COLLECTOR.pop(tid) if pop else COLLECTOR.spans(tid)
    if not spans:
        return None
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"trace.{rid}.json"
    if merge and path.exists():
        try:
            prev = json.loads(path.read_text()).get("spans", [])
        except (OSError, ValueError):
            prev = []
        if prev:
            spans = merge_spans([prev, spans])
    _atomic_write_text(path, json.dumps(
        {"request_id": str(rid), "trace_id": tid, "spans": spans},
        indent=1, default=str))
    if chrome:
        export_chrome_trace(spans, out_dir / f"trace.{rid}.chrome.json",
                            rid)
    return path


def merge_spans(span_lists) -> List[Dict]:
    """Union span records from several exports (router + replicas + a
    failover inheritor), deduped by span id (a harvested request's trace
    may be exported twice)."""
    seen: Dict[str, Dict] = {}
    for spans in span_lists:
        for s in spans or ():
            sid = s.get("span_id")
            if sid and sid not in seen:
                seen[sid] = s
    return sorted(seen.values(), key=lambda s: s.get("t_start") or 0.0)


def build_tree(spans: List[Dict]):
    """Assemble ``(root, children)`` from span records.  Exactly-one-
    root is the stitched-trace contract: when several parentless spans
    exist (processes that never saw each other's context), the earliest
    becomes the root and the rest are REPARENTED under it with a
    ``stitched`` mark — the tree stays single-rooted, and the surgery is
    visible rather than silent.  Returns ``(None, {})`` on empty."""
    if not spans:
        return None, {}
    by_id = {s["span_id"]: s for s in spans}
    roots = [s for s in spans
             if not s.get("parent_id") or s["parent_id"] not in by_id]
    roots.sort(key=lambda s: (s.get("t_start") or 0.0, s["span_id"]))
    root = roots[0]
    for orphan in roots[1:]:
        if orphan.get("parent_id") not in by_id:
            orphan = dict(orphan)
            by_id[orphan["span_id"]] = orphan
            orphan.setdefault("attrs", {})
            if orphan["attrs"].get("stitched") is None:
                orphan["attrs"]["stitched"] = (
                    "reparented: original parent "
                    f"{orphan.get('parent_id')!r} not in trace"
                    if orphan.get("parent_id") else "reparented root")
            orphan["parent_id"] = root["span_id"]
    children: Dict[str, List[Dict]] = {}
    for s in by_id.values():
        if s["span_id"] != root["span_id"]:
            children.setdefault(s["parent_id"], []).append(s)
    for kids in children.values():
        kids.sort(key=lambda s: (s.get("t_start") or 0.0, s["span_id"]))
    return root, children


def validate_trace(spans: List[Dict]) -> Dict:
    """Structural validation for the smoke/CI gates: non-empty, unique
    span ids, a SINGLE root (before any stitching surgery), every other
    span's parent present, no negative durations.  Raises ``ValueError``
    naming the violation; returns ``{"root": ..., "n_spans": ...}``."""
    if not spans:
        raise ValueError("trace has no spans")
    ids = [s.get("span_id") for s in spans]
    if len(set(ids)) != len(ids):
        raise ValueError("trace has duplicate span ids")
    by_id = set(ids)
    roots = [s for s in spans
             if not s.get("parent_id") or s["parent_id"] not in by_id]
    if len(roots) != 1:
        raise ValueError(
            f"trace must have exactly one root, found {len(roots)}: "
            f"{[s.get('name') for s in roots]}")
    tids = {s.get("trace_id") for s in spans}
    if len(tids) != 1:
        raise ValueError(f"trace mixes trace ids: {sorted(tids)}")
    for s in spans:
        d = s.get("duration_s")
        if d is not None and d < 0:
            raise ValueError(f"span {s.get('name')!r} has negative "
                             f"duration {d}")
    return {"root": roots[0], "n_spans": len(spans)}


def slowest_path(spans: List[Dict]) -> List[str]:
    """Span ids of the critical path: from the root, repeatedly descend
    into the longest-duration child — the chain the ``trace`` CLI
    highlights."""
    root, children = build_tree(spans)
    if root is None:
        return []
    path = [root["span_id"]]
    node = root
    while True:
        kids = children.get(node["span_id"])
        if not kids:
            return path
        node = max(kids, key=lambda s: s.get("duration_s") or 0.0)
        path.append(node["span_id"])


# ---------------------------------------------------------------------------
# Chrome trace-event export (chrome://tracing / Perfetto)
# ---------------------------------------------------------------------------

def to_chrome(spans: List[Dict], request_id: Optional[str] = None) -> Dict:
    """Chrome trace-event JSON for one trace: complete ("X") events on
    named lanes.  Dispatch-group spans carry the elastic scheduler's
    ``device`` attribute, so each device gets its own lane — the
    per-device occupancy timeline the serving benches gate on, loadable
    without any custom tooling; a run's phases take the lane of the
    thread they ran on."""
    lanes: Dict[str, int] = {}
    events: List[Dict] = []

    def lane(s: Dict) -> int:
        attrs = s.get("attrs") or {}
        if attrs.get("device") is not None:
            name = f"device:{attrs['device']}"
        elif attrs.get("replica"):
            name = f"replica:{attrs['replica']}"
        elif attrs.get("thread"):
            name = f"thread:{attrs['thread']}"
        else:
            name = "request"
        if name not in lanes:
            lanes[name] = len(lanes) + 1
            events.append({"ph": "M", "pid": 1, "tid": lanes[name],
                           "name": "thread_name",
                           "args": {"name": name}})
        return lanes[name]

    for s in spans:
        tid = lane(s)
        ts = (s.get("t_start") or 0.0) * 1e6
        events.append({
            "ph": "X", "pid": 1, "tid": tid, "name": s.get("name"),
            "cat": "dervet", "ts": ts,
            "dur": max(1.0, (s.get("duration_s") or 0.0) * 1e6),
            "args": {**(s.get("attrs") or {}),
                     "span_id": s.get("span_id"),
                     "status": s.get("status")},
        })
        for ev in s.get("events") or ():
            events.append({"ph": "i", "pid": 1, "tid": tid, "s": "t",
                           "name": ev.get("name"), "cat": "dervet",
                           "ts": (ev.get("t") or 0.0) * 1e6,
                           "args": ev.get("attrs") or {}})
    meta = {"request_id": request_id} if request_id else {}
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": meta}


def export_chrome_trace(spans: List[Dict], path,
                        request_id: Optional[str] = None) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    # default=str mirrors the span-export serialization, so in-memory
    # spans and re-loaded trace.json spans render identically
    _atomic_write_text(path, json.dumps(to_chrome(spans, request_id),
                                        default=str))
    return path
