"""Time-series metrics registry with a Prometheus text exposition.

The stack already computes every number an autoscaler or an operator
needs — queue depth, drain rate, per-replica inflight, breaker states,
iters per window, certification verdicts, warm-grade mix, steal counts —
but each lives in a point-in-time ``metrics()`` dict or a per-run
artifact.  This registry makes them survive as signals:

* **Counters / gauges / histograms**, thread-safe, created on demand by
  name + label set.  Histograms use ONE fixed log-bucket layout
  (:data:`HIST_BOUNDS`, factor-2 buckets spanning 1e-4..~1.3e4) so
  percentile estimates are **mergeable across replicas** by adding
  bucket counts — the fleet ``status`` CLI merges N replicas' request-
  latency histograms into one fleet p50/p99 without ever seeing a raw
  sample.
* **Bounded ring-buffer time series** — :meth:`MetricsRegistry.sample`
  snapshots every gauge/counter into a per-metric ``deque`` (the
  heartbeat cadence), so "queue depth over the last minute" is a real
  series, not a single number.  Bounded: a service that never dies must
  not grow history forever.
* **Prometheus text exposition** — :meth:`to_prometheus` renders the
  standard text format; the serve loop writes it atomically next to the
  heartbeat (``telemetry.prom``) and the router SCRAPES replica files to
  route on *published* load.  :func:`parse_prometheus` is the matching reader.
* **Optional localhost HTTP endpoint** — :meth:`serve_http` exposes
  ``/metrics`` on 127.0.0.1 for an ad-hoc scrape; file exposition stays
  the primary transport (the fleet is same-host/same-filesystem).

Stdlib-only, like ``telemetry.trace``.  The process-default registry
(:func:`get_registry`) is what the serving stack populates; bench legs
snapshot it per leg.
"""
from __future__ import annotations

import bisect
import math
import re
import threading
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Tuple

# one fixed log-bucket layout for every histogram: factor-2 buckets from
# 100 µs to ~13.1 ks (28 finite bounds + +Inf).  Fixed so merges across
# replicas/processes are exact bucket-count adds; wide enough for both
# latencies (seconds) and iteration counts (hundreds..thousands).
HIST_BOUNDS: Tuple[float, ...] = tuple(1e-4 * 2 ** i for i in range(28))

SERIES_CAP = 512            # ring-buffer samples kept per metric


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _esc_label(v) -> str:
    # Prometheus text-format label escaping: backslash, quote, newline.
    # Label values come from caller-chosen names (replica/spool/breaker
    # names) — an unescaped quote would render an exposition our own
    # parser rejects.
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc_label(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotone counter."""

    __slots__ = ("name", "labels", "_lock", "value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class Gauge:
    """Set-to-current-value gauge."""

    __slots__ = ("name", "labels", "_lock", "value")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Histogram:
    """Fixed log-bucket histogram (cumulative-bucket exposition).

    ``buckets[i]`` counts observations <= ``HIST_BOUNDS[i]`` (NON-
    cumulative internally; the exposition cumulates).  Identical bounds
    everywhere make :func:`merge_histograms` an exact elementwise add."""

    __slots__ = ("name", "labels", "_lock", "buckets", "overflow",
                 "count", "sum")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()
        self.buckets = [0] * len(HIST_BOUNDS)
        self.overflow = 0           # > last finite bound (the +Inf bucket)
        self.count = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.observe_many((value,))

    def observe_many(self, values) -> None:
        idxs = []
        total = 0.0
        n = 0
        for v in values:
            v = float(v)
            if v != v:          # NaN: not observable
                continue
            idxs.append(bisect.bisect_left(HIST_BOUNDS, v))
            total += v
            n += 1
        if not n:
            return
        with self._lock:
            for i in idxs:
                if i >= len(HIST_BOUNDS):
                    self.overflow += 1
                else:
                    self.buckets[i] += 1
            self.count += n
            self.sum += total

    def snapshot(self) -> Dict:
        with self._lock:
            return {"count": self.count, "sum": round(self.sum, 6),
                    "buckets": list(self.buckets),
                    "overflow": self.overflow}

    def quantile(self, q: float) -> Optional[float]:
        return quantile_from_buckets(self.snapshot(), q)


def quantile_from_buckets(snap: Dict, q: float) -> Optional[float]:
    """Quantile estimate from a histogram snapshot (log-interpolated
    within the landing bucket); None when empty.  Works on merged
    snapshots too — that is the point of the fixed layout."""
    count = int(snap.get("count") or 0)
    if count <= 0:
        return None
    rank = q * count
    seen = 0.0
    buckets = snap["buckets"]
    for i, c in enumerate(buckets):
        if c <= 0:
            continue
        if seen + c >= rank:
            hi = HIST_BOUNDS[i]
            lo = HIST_BOUNDS[i - 1] if i else hi / 2.0
            frac = (rank - seen) / c
            # log interpolation matches the bucket geometry
            return float(lo * (hi / lo) ** max(0.0, min(1.0, frac)))
        seen += c
    return float(HIST_BOUNDS[-1])


def merge_histograms(snaps: List[Dict]) -> Dict:
    """Exact merge of same-layout histogram snapshots (bucket-count
    adds) — the fleet-wide percentile surface."""
    out = {"count": 0, "sum": 0.0,
           "buckets": [0] * len(HIST_BOUNDS), "overflow": 0}
    for s in snaps:
        if not s:
            continue
        b = s.get("buckets") or []
        if len(b) != len(HIST_BOUNDS):
            raise ValueError(
                f"histogram layout mismatch: {len(b)} buckets != "
                f"{len(HIST_BOUNDS)} — merge requires the fixed layout")
        for i, c in enumerate(b):
            out["buckets"][i] += int(c)
        out["count"] += int(s.get("count") or 0)
        out["sum"] += float(s.get("sum") or 0.0)
        out["overflow"] += int(s.get("overflow") or 0)
    return out


class MetricsRegistry:
    """Name+labels -> metric, with snapshot / series / exposition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple], object] = {}
        self._series: Dict[str, deque] = {}
        self._http = None

    # -- construction ---------------------------------------------------
    def _get(self, cls, name: str, labels: Optional[Dict]) -> object:
        labels = {str(k): str(v) for k, v in (labels or {}).items()}
        key = (str(name), tuple(sorted(labels.items())))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(str(name), labels)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r}{_label_str(labels)} already "
                    f"registered as {type(m).__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    # -- time series ----------------------------------------------------
    def sample(self) -> None:
        """Append every counter/gauge's current value to its bounded
        ring-buffer series (call at the heartbeat cadence)."""
        now = round(time.time(), 3)
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, (Counter, Gauge)):
                key = f"{m.name}{_label_str(m.labels)}"
                with self._lock:
                    series = self._series.get(key)
                    if series is None:
                        series = self._series[key] = deque(
                            maxlen=SERIES_CAP)
                series.append((now, m.value))

    def series(self, name: str, **labels) -> List[Tuple[float, float]]:
        key = f"{name}{_label_str({str(k): str(v) for k, v in labels.items()})}"
        with self._lock:
            return list(self._series.get(key, ()))

    # -- snapshot / exposition ------------------------------------------
    def snapshot(self) -> Dict:
        """JSON-ready view: the shape ``benchlib.
        validate_telemetry_section`` checks and bench legs publish."""
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        histograms: Dict[str, Dict] = {}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            key = f"{m.name}{_label_str(m.labels)}"
            if isinstance(m, Counter):
                counters[key] = m.value
            elif isinstance(m, Gauge):
                gauges[key] = m.value
            elif isinstance(m, Histogram):
                histograms[key] = m.snapshot()
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms,
                "series_cap": SERIES_CAP,
                "hist_bounds": len(HIST_BOUNDS),
                "t": round(time.time(), 3)}

    def to_prometheus(self) -> str:
        """Standard Prometheus text format (histograms as cumulative
        ``_bucket{le=}`` + ``_sum`` + ``_count``)."""
        with self._lock:
            metrics = list(self._metrics.values())
        by_name: Dict[str, List] = {}
        for m in metrics:
            by_name.setdefault(m.name, []).append(m)
        lines: List[str] = []
        for name in sorted(by_name):
            group = by_name[name]
            kind = ("counter" if isinstance(group[0], Counter)
                    else "gauge" if isinstance(group[0], Gauge)
                    else "histogram")
            lines.append(f"# TYPE {name} {kind}")
            for m in group:
                ls = _label_str(m.labels)
                if isinstance(m, (Counter, Gauge)):
                    lines.append(f"{name}{ls} {_fmt(m.value)}")
                    continue
                snap = m.snapshot()
                cum = 0
                for bound, c in zip(HIST_BOUNDS, snap["buckets"]):
                    cum += c
                    lab = dict(m.labels)
                    lab["le"] = _fmt(bound)
                    lines.append(f"{name}_bucket{_label_str(lab)} {cum}")
                lab = dict(m.labels)
                lab["le"] = "+Inf"
                lines.append(f"{name}_bucket{_label_str(lab)} "
                             f"{snap['count']}")
                lines.append(f"{name}_sum{ls} {_fmt(snap['sum'])}")
                lines.append(f"{name}_count{ls} {snap['count']}")
        lines.append(f"# EOF t={round(time.time(), 3)}")
        return "\n".join(lines) + "\n"

    def write_prom(self, path) -> Path:
        """Atomic exposition write (dot-tmp + fsync + replace) — the
        router's scrape never sees a torn file."""
        from .trace import _atomic_write_text
        path = Path(path)
        _atomic_write_text(path, self.to_prometheus())
        return path

    # -- optional localhost endpoint ------------------------------------
    def serve_http(self, port: int = 0, host: str = "127.0.0.1"):
        """Start a daemon-thread HTTP server answering ``/metrics`` with
        the text exposition; returns the bound port.  Localhost-only by
        default — this is an operator convenience, not a public API."""
        import http.server

        registry = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (stdlib naming)
                if self.path not in ("/metrics", "/"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = registry.to_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silent: CI output hygiene
                pass

        server = http.server.ThreadingHTTPServer((host, int(port)),
                                                 Handler)
        thread = threading.Thread(target=server.serve_forever,
                                  name="dervet-telemetry-http",
                                  daemon=True)
        thread.start()
        self._http = server
        return server.server_address[1]

    def stop_http(self) -> None:
        if self._http is not None:
            self._http.shutdown()
            self._http = None

    def reset(self) -> None:
        """Test hook: drop every metric and series."""
        with self._lock:
            self._metrics.clear()
            self._series.clear()


# ---------------------------------------------------------------------------
# Exposition parsing (the router-side scrape + smoke validation)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unesc_label(v: str) -> str:
    return re.sub(r"\\(.)",
                  lambda m: "\n" if m.group(1) == "n" else m.group(1), v)


def parse_prometheus(text: str) -> Dict[str, List[Dict]]:
    """Parse a text exposition into ``name -> [{labels, value}, ...]``.
    Tolerant of comments/blank lines; raises ``ValueError`` on a
    malformed sample line (the smoke's parse gate)."""
    out: Dict[str, List[Dict]] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"unparseable exposition line {ln}: "
                             f"{line!r}")
        raw = m.group("value")
        try:
            value = float("inf") if raw == "+Inf" else float(raw)
        except ValueError:
            raise ValueError(f"non-numeric sample value on line {ln}: "
                             f"{raw!r}")
        labels = {k: _unesc_label(v)
                  for k, v in _LABEL_RE.findall(m.group("labels") or "")}
        out.setdefault(m.group("name"), []).append(
            {"labels": labels, "value": value})
    return out


def sample_value(parsed: Dict, name: str,
                 labels: Optional[Dict] = None) -> Optional[float]:
    """First sample of ``name`` whose labels are a superset of
    ``labels`` (None when absent)."""
    want = {str(k): str(v) for k, v in (labels or {}).items()}
    for s in parsed.get(name, ()):
        if all(s["labels"].get(k) == v for k, v in want.items()):
            return s["value"]
    return None


def histogram_from_parsed(parsed: Dict, name: str,
                          labels: Optional[Dict] = None
                          ) -> Optional[Dict]:
    """Reconstruct a mergeable histogram snapshot from a parsed
    exposition (de-cumulating the ``_bucket`` series)."""
    want = {str(k): str(v) for k, v in (labels or {}).items()}
    rows = []
    for s in parsed.get(f"{name}_bucket", ()):
        ls = dict(s["labels"])
        le = ls.pop("le", None)
        if le is None or not all(ls.get(k) == v
                                 for k, v in want.items()):
            continue
        bound = math.inf if le == "+Inf" else float(le)
        rows.append((bound, s["value"]))
    if not rows:
        return None
    rows.sort()
    buckets = [0] * len(HIST_BOUNDS)
    prev = 0.0
    overflow = 0
    for bound, cum in rows:
        delta = int(cum - prev)
        prev = cum
        if bound == math.inf:
            overflow = delta
            continue
        # a foreign bucket layout (mixed-version fleet) must surface as
        # "no histogram", never be snapped onto HIST_BOUNDS — a remapped
        # reconstruction would pass merge_histograms' layout check and
        # silently corrupt fleet p50/p99
        i = bisect.bisect_left(HIST_BOUNDS, bound * (1 - 1e-9))
        if i >= len(HIST_BOUNDS) or \
                abs(HIST_BOUNDS[i] - bound) > 1e-9 * max(1.0, bound):
            return None
        buckets[i] = delta
    count = sample_value(parsed, f"{name}_count", want)
    total = sample_value(parsed, f"{name}_sum", want)
    return {"count": int(count or prev), "sum": float(total or 0.0),
            "buckets": buckets, "overflow": overflow}


# ---------------------------------------------------------------------------
# Process-default registry
# ---------------------------------------------------------------------------

_default = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default


def enabled() -> bool:
    """Registry population honors the same kill switch as tracing —
    ONE implementation, so the two planes can never drift apart."""
    from .trace import enabled as _trace_enabled
    return _trace_enabled()
