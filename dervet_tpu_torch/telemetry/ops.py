"""Operator surface: the ``status`` and ``trace`` subcommands.

``status SPOOL_DIR [SPOOL_DIR...]`` renders live fleet health from each
replica spool's published artifacts — ``heartbeat.json`` (liveness,
queue depth, request counters) and ``telemetry.prom`` (the metrics
registry exposition the serve loop rewrites at the heartbeat cadence) —
plus the router's ``fleet_telemetry.prom``/``fleet_metrics.json`` when a
fleet directory is given.  Per-replica request-latency histograms share
one fixed bucket layout, so the fleet-wide p50/p99 and SLO attainment
are EXACT bucket merges, not approximations over approximations.

``trace RID DIR [DIR...]`` stitches one request's exported span trees
(``trace.<rid>.json`` from the router and every replica that touched the
request — a failover leaves two) into a single tree and pretty-prints it
with the slowest root-to-leaf path highlighted; ``--chrome OUT.json``
additionally writes a Chrome trace-event timeline (chrome://tracing /
Perfetto) with per-device occupancy lanes.  When no trace file exists
(pre-crash, or telemetry was off) the spool journals are consulted:
their records carry wall+mono timestamps and the active trace id,
so a timeline of journaled events is still reconstructable.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import registry as _registry
from . import trace as _trace

PROM_FILE = "telemetry.prom"
FLEET_PROM_FILE = "fleet_telemetry.prom"

# metric names shared between the publishers (server/router) and this
# reader — one place, so the surface cannot silently fork
M_QUEUE_DEPTH = "dervet_queue_depth"
M_DRAIN_RATE = "dervet_drain_rate_rps"
M_PENDING = "dervet_pending_requests"
M_REQ_LATENCY = "dervet_request_latency_seconds"
M_REQUESTS = "dervet_requests_total"
M_WINDOWS = "dervet_windows_total"
M_WARM = "dervet_warm_windows_total"
M_CERT = "dervet_certifications_total"
M_BREAKER_OPEN = "dervet_breaker_open"
M_STEALS = "dervet_elastic_steals_total"


def _read_json(path: Path) -> Optional[Dict]:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError):
        return None


def _read_prom(path: Path) -> Optional[Dict]:
    # ValueError too: a corrupt/foreign exposition reads as
    # "unpublished", it must never crash the status CLI for the fleet
    try:
        return _registry.parse_prometheus(path.read_text())
    except (OSError, ValueError):
        return None


def discover_spools(dirs: List[Path]) -> List[Path]:
    """Replica spools among/under the given dirs: a dir with a
    ``heartbeat.json`` or ``telemetry.prom`` is a spool; otherwise its
    immediate children are scanned (a fleet root holding ``replica*/``
    spools)."""
    out: List[Path] = []
    for d in dirs:
        d = Path(d)
        if (d / "heartbeat.json").exists() or (d / PROM_FILE).exists():
            out.append(d)
            continue
        for child in sorted(p for p in d.iterdir() if p.is_dir()) \
                if d.is_dir() else ():
            if (child / "heartbeat.json").exists() or \
                    (child / PROM_FILE).exists():
                out.append(child)
    return out


def replica_status(spool: Path) -> Dict:
    """One replica's health/load view from its published artifacts."""
    hb = _read_json(spool / "heartbeat.json")
    parsed = _read_prom(spool / PROM_FILE)
    now = time.time()
    out: Dict = {
        "spool": str(spool),
        "name": (hb or {}).get("name") or spool.name,
        "heartbeat_age_s": (round(now - float(hb["t"]), 2)
                            if hb and "t" in hb else None),
        "draining": (hb or {}).get("draining"),
        "pending": (hb or {}).get("pending"),
        "queue_depth": (hb or {}).get("queue_depth"),
        "completed": (hb or {}).get("completed"),
        "failed": (hb or {}).get("failed"),
        "published": parsed is not None,
    }
    age = out["heartbeat_age_s"]
    out["state"] = ("unknown" if age is None
                    else "stale" if age > 10.0 else "up")
    if parsed:
        sv = _registry.sample_value
        qd = sv(parsed, M_QUEUE_DEPTH)
        if qd is not None:
            out["queue_depth"] = qd
        out["drain_rate_rps"] = sv(parsed, M_DRAIN_RATE)
        out["breakers_open"] = int(sum(
            s["value"] for s in parsed.get(M_BREAKER_OPEN, ())))
        out["windows"] = sv(parsed, M_WINDOWS)
        warm = sum(s["value"] for s in parsed.get(M_WARM, ())
                   if s["labels"].get("grade") not in (None, "cold"))
        cold = sv(parsed, M_WARM, {"grade": "cold"}) or 0.0
        out["warm_hit_rate"] = (round(warm / (warm + cold), 4)
                                if warm + cold else None)
        cert_ok = sv(parsed, M_CERT, {"verdict": "accepted"}) or 0.0
        cert_rej = sv(parsed, M_CERT, {"verdict": "rejected"}) or 0.0
        out["cert_accept_rate"] = (round(cert_ok / (cert_ok + cert_rej), 4)
                                   if cert_ok + cert_rej else None)
        out["latency_hist"] = _registry.histogram_from_parsed(
            parsed, M_REQ_LATENCY)
        if out["latency_hist"]:
            out["latency_p50_s"] = _registry.quantile_from_buckets(
                out["latency_hist"], 0.5)
            out["latency_p99_s"] = _registry.quantile_from_buckets(
                out["latency_hist"], 0.99)
    return out


def slo_attainment(hist: Optional[Dict], slo_s: float) -> Optional[float]:
    """Fraction of observed request latencies at or under ``slo_s``,
    from the merged histogram.  Only buckets whose UPPER bound is
    <= ``slo_s`` count as attained — bucket i holds observations in
    ``(HIST_BOUNDS[i-1], HIST_BOUNDS[i]]``, so including the bucket
    that straddles ``slo_s`` would credit latencies up to a factor 2
    past the target (conservative under-count, never over)."""
    if not hist or not hist.get("count"):
        return None
    import bisect
    cut = bisect.bisect_right(_registry.HIST_BOUNDS, float(slo_s))
    under = sum(hist["buckets"][:cut])
    return round(min(1.0, under / hist["count"]), 4)


def fleet_status(dirs: List[Path], slo_s: float = 60.0) -> Dict:
    spools = discover_spools(dirs)
    replicas = [replica_status(s) for s in spools]
    merged = _registry.merge_histograms(
        [r.get("latency_hist") or {} for r in replicas])
    fleet: Dict = {
        "replicas": replicas,
        "n_replicas": len(replicas),
        "n_up": sum(1 for r in replicas if r["state"] == "up"),
        "queue_depth_total": sum(int(r.get("queue_depth") or 0)
                                 for r in replicas),
        "completed_total": sum(int(r.get("completed") or 0)
                               for r in replicas),
        "failed_total": sum(int(r.get("failed") or 0) for r in replicas),
        "latency_p50_s": _registry.quantile_from_buckets(merged, 0.5),
        "latency_p99_s": _registry.quantile_from_buckets(merged, 0.99),
        "slo_s": slo_s,
        "slo_attainment": slo_attainment(merged, slo_s),
    }
    # router-side view when one of the dirs is a fleet directory
    for d in dirs:
        d = Path(d)
        fm = _read_json(d / "fleet_metrics.json")
        parsed = _read_prom(d / FLEET_PROM_FILE)
        if fm or parsed:
            fleet["router"] = {
                "dir": str(d),
                "routing": (fm or {}).get("routing"),
                "scraped": {k: [dict(s) for s in v]
                            for k, v in (parsed or {}).items()
                            if k.startswith("dervet_fleet_")} or None,
            }
            break
    # lifecycle supervisor view (supervisor_state.json, published by
    # service/lifecycle.py): per-replica restart counts, crash-loop /
    # quarantine state, and last restart reason — merged into the
    # replica rows by name so the table shows WHY a replica vanished,
    # not just that its heartbeat aged out
    sup = None
    for d in dirs:
        sup = _read_json(Path(d) / "supervisor_state.json")
        if sup is not None:
            break
    if sup is not None:
        fleet["supervisor"] = {k: v for k, v in sup.items()
                               if k != "replicas"}
        by_name = sup.get("replicas") or {}
        for r in replicas:
            s = by_name.get(r["name"])
            if s is not None:
                r["restarts"] = s.get("restarts")
                r["lifecycle"] = s.get("state")
                r["last_restart_reason"] = s.get("last_restart_reason")
    return fleet


def _fmt_cell(v, unit: str = "") -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.3g}{unit}"
    return f"{v}{unit}"


def render_status(fleet: Dict) -> str:
    # supervisor columns only when a supervisor_state.json was found —
    # an unsupervised fleet's table stays byte-identical to before
    supervised = fleet.get("supervisor") is not None
    cols = ("name", "state", "age", "queue", "drain/s", "pending",
            "done", "failed", "warm%", "cert%", "p50", "p99", "brk")
    if supervised:
        cols = cols + ("restarts", "life", "last restart")
    rows = []
    for r in fleet["replicas"]:
        row = (
            r["name"], r["state"], _fmt_cell(r.get("heartbeat_age_s"), "s"),
            _fmt_cell(r.get("queue_depth")),
            _fmt_cell(r.get("drain_rate_rps")),
            _fmt_cell(r.get("pending")), _fmt_cell(r.get("completed")),
            _fmt_cell(r.get("failed")),
            _fmt_cell(None if r.get("warm_hit_rate") is None
                      else round(100 * r["warm_hit_rate"], 1)),
            _fmt_cell(None if r.get("cert_accept_rate") is None
                      else round(100 * r["cert_accept_rate"], 1)),
            _fmt_cell(r.get("latency_p50_s"), "s"),
            _fmt_cell(r.get("latency_p99_s"), "s"),
            _fmt_cell(r.get("breakers_open")),
        )
        if supervised:
            reason = r.get("last_restart_reason")
            row = row + (
                _fmt_cell(r.get("restarts")),
                _fmt_cell(r.get("lifecycle")),
                ("-" if not reason else
                 reason if len(reason) <= 40 else reason[:37] + "..."),
            )
        rows.append(row)
    widths = [max(len(str(c)), *(len(str(row[i])) for row in rows))
              if rows else len(str(c)) for i, c in enumerate(cols)]
    lines = [" ".join(str(c).ljust(widths[i])
                      for i, c in enumerate(cols))]
    lines.append(" ".join("-" * w for w in widths))
    for row in rows:
        lines.append(" ".join(str(v).ljust(widths[i])
                              for i, v in enumerate(row)))
    lines.append("")
    att = fleet.get("slo_attainment")
    lines.append(
        f"fleet: {fleet['n_up']}/{fleet['n_replicas']} up, "
        f"queue {fleet['queue_depth_total']}, "
        f"completed {fleet['completed_total']}, "
        f"failed {fleet['failed_total']}, merged latency p50/p99 "
        f"{_fmt_cell(fleet.get('latency_p50_s'), 's')}/"
        f"{_fmt_cell(fleet.get('latency_p99_s'), 's')}, "
        f"SLO({fleet['slo_s']:g}s) "
        f"{'-' if att is None else f'{100 * att:.1f}%'}")
    router = fleet.get("router")
    if router and router.get("routing"):
        rt = router["routing"]
        lines.append(
            f"router: submitted {rt.get('submitted')}, completed "
            f"{rt.get('completed')}, failovers {rt.get('failovers')}, "
            f"harvested {rt.get('harvested')}, hedged "
            f"{rt.get('hedged')}, affinity hit rate "
            f"{rt.get('affinity_hit_rate')}")
    sup = fleet.get("supervisor")
    if sup is not None:
        c = sup.get("counters") or {}
        lines.append(
            f"supervisor: restarts {c.get('restarts')}, quarantined "
            f"{c.get('quarantined')}, scale up/down "
            f"{c.get('scale_up')}/{c.get('scale_down')}, warm imports "
            f"{c.get('warm_imports')}, bounds "
            f"[{sup.get('min_replicas')}, {sup.get('max_replicas')}]")
    return "\n".join(lines)


def status_main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dervet_tpu_torch status",
        description="live fleet status from replica-published telemetry")
    parser.add_argument("dirs", nargs="+",
                        help="replica spool dir(s), a fleet root "
                             "containing them, and/or the router's "
                             "fleet dir")
    parser.add_argument("--slo-s", type=float, default=60.0,
                        help="latency bound for the SLO-attainment "
                             "column (default 60s)")
    parser.add_argument("--json", action="store_true",
                        help="emit the raw status dict instead of the "
                             "table")
    args = parser.parse_args(argv)
    fleet = fleet_status([Path(d) for d in args.dirs], slo_s=args.slo_s)
    if args.json:
        print(json.dumps(fleet, indent=2, default=str))
    else:
        print(render_status(fleet))
    return 0


# ---------------------------------------------------------------------------
# trace: stitch + pretty-print one request's span tree
# ---------------------------------------------------------------------------

def find_trace_files(rid: str, dirs: List[Path]) -> List[Path]:
    """Every ``trace.<rid>.json`` under the given dirs: direct, in a
    ``traces/`` subdir (router export), in ``results/<rid>/`` (replica
    export), or one directory level down (a fleet root)."""
    fname = f"trace.{rid}.json"
    hits: List[Path] = []
    for d in dirs:
        d = Path(d)
        candidates = [d / fname, d / "traces" / fname,
                      d / "results" / rid / fname]
        if d.is_dir():
            for child in sorted(p for p in d.iterdir() if p.is_dir()):
                candidates += [child / fname, child / "traces" / fname,
                               child / "results" / rid / fname]
        for c in candidates:
            if c.exists() and c not in hits:
                hits.append(c)
    return hits


def journal_spans(rid: str, dirs: List[Path]) -> List[Dict]:
    """Timeline reconstruction from spool/fleet journals when no trace
    export exists (pre-crash, or telemetry was off at the replica):
    every journal record for ``rid`` becomes a zero-duration span under
    a synthesized root, using the wall timestamps (and trace id) the
    journal records carry."""
    records: List[Dict] = []
    for d in dirs:
        d = Path(d)
        paths = list(d.glob("*journal.jsonl"))
        if d.is_dir():
            paths += list(d.glob("*/*journal.jsonl"))
        for p in paths:
            try:
                lines = p.read_text(encoding="utf-8").splitlines()
            except OSError:
                continue
            for line in lines:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if str(rec.get("rid")) == str(rid):
                    rec["_journal"] = str(p)
                    records.append(rec)
    if not records:
        return []
    records.sort(key=lambda r: r.get("t") or 0.0)
    tid = next((r["trace_id"] for r in records if r.get("trace_id")),
               _trace.trace_id_for(rid))
    t0 = records[0].get("t") or time.time()
    t1 = records[-1].get("t") or t0
    root = {"trace_id": tid, "span_id": f"journal-root-{rid}",
            "parent_id": None, "name": "journal_timeline",
            "t_start": t0, "duration_s": round(max(0.0, t1 - t0), 6),
            "status": "ok",
            "attrs": {"request_id": rid, "source": "journal replay"}}
    spans = [root]
    for i, rec in enumerate(records):
        spans.append({
            "trace_id": tid, "span_id": f"journal-{rid}-{i}",
            "parent_id": root["span_id"],
            "name": f"journal:{rec.get('event')}",
            "t_start": rec.get("t"), "duration_s": 0.0, "status": "ok",
            "attrs": {k: v for k, v in rec.items()
                      if k not in ("event", "t")},
        })
    return spans


def load_stitched_trace(rid: str, dirs: List[Path]) -> List[Dict]:
    """All span records for ``rid`` across the given dirs, merged and
    deduped; falls back to journal reconstruction when no export
    exists."""
    lists = []
    for path in find_trace_files(rid, dirs):
        doc = _read_json(path)
        if doc:
            lists.append(doc.get("spans") or [])
    spans = _trace.merge_spans(lists)
    if not spans:
        spans = journal_spans(rid, dirs)
    return spans


def render_trace(spans: List[Dict], highlight: bool = True) -> str:
    root, children = _trace.build_tree(spans)
    if root is None:
        return "(no spans)"
    hot = set(_trace.slowest_path(spans)) if highlight else set()
    lines: List[str] = []

    def fmt(s: Dict, depth: int) -> None:
        dur = s.get("duration_s")
        mark = "*" if s["span_id"] in hot else " "
        bits = [f"{mark} {'  ' * depth}{s.get('name')}"]
        bits.append(f"[{dur * 1e3:.1f}ms]" if dur is not None
                    else "[?]")
        if s.get("status") == "error":
            bits.append("ERROR")
        attrs = s.get("attrs") or {}
        for key in ("replica", "device", "rung", "fidelity", "variant",
                    "kernel", "verdict", "batch", "stitched"):
            if attrs.get(key) is not None:
                bits.append(f"{key}={attrs[key]}")
        evs = s.get("events") or ()
        if evs:
            bits.append("events=" + ",".join(e.get("name", "?")
                                             for e in evs[:8]))
        lines.append(" ".join(bits))
        for kid in children.get(s["span_id"], ()):
            fmt(kid, depth + 1)

    fmt(root, 0)
    lines.append("")
    lines.append("* = slowest root-to-leaf path")
    return "\n".join(lines)


def trace_main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dervet_tpu_torch trace",
        description="stitch and pretty-print one request's span tree")
    parser.add_argument("rid", help="request id")
    parser.add_argument("dirs", nargs="+",
                        help="spool / fleet / results dir(s) holding "
                             "trace.<rid>.json exports (journals are "
                             "consulted when no export exists)")
    parser.add_argument("--chrome", default=None, metavar="OUT.json",
                        help="also write a Chrome trace-event timeline")
    parser.add_argument("--json", action="store_true",
                        help="emit the stitched span list instead of "
                             "the tree rendering")
    args = parser.parse_args(argv)
    spans = load_stitched_trace(args.rid, [Path(d) for d in args.dirs])
    if not spans:
        print(f"trace: no spans or journal records found for "
              f"{args.rid!r} under {args.dirs}", file=sys.stderr)
        return 3
    if args.chrome:
        path = _trace.export_chrome_trace(spans, args.chrome,
                                          request_id=args.rid)
        print(f"chrome trace written to {path}", file=sys.stderr)
    if args.json:
        print(json.dumps(spans, indent=1, default=str))
    else:
        print(render_trace(spans))
    return 0
