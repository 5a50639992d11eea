"""Pre-run input echo (reference: storagevet.Visualization.class_summary,
invoked from dervet/DERVET.py:68-70 in verbose mode): prints every active
tag's keys/values so the user can confirm what was loaded.

Also builds the RUN-HEALTH report (resilience layer): per-run counts of
clean / inaccurate-accepted / retried / CPU-fallback / quarantined windows
plus escalation-ladder wall time, aggregated across the sweep's cases, so
a large run's degradations are visible instead of silent."""
from __future__ import annotations

from typing import Dict

import pandas as pd

from ..utils.errors import TellUser

# the one authoritative bucket list — scenario._new_health derives its
# counters from this, so the dispatch loop and the report cannot drift
HEALTH_KEYS = ("clean", "inaccurate", "retried", "cpu_fallback",
               "quarantined", "skipped")


def run_artifact_name(base: str, request_id=None) -> str:
    """Namespace a run artifact filename by request id: ``run_health.json``
    -> ``run_health.<rid>.json`` — so concurrent service requests sharing
    one process (or one output/checkpoint directory) cannot clobber each
    other's reports.  With no request id the name is returned unchanged,
    so the single-run CLI path keeps today's filenames.  The id is
    sanitized to filename-safe characters ([A-Za-z0-9._-], the rest
    mapped to ``_``)."""
    if request_id in (None, ""):
        return base
    rid = "".join(ch if (ch.isalnum() or ch in "._-") else "_"
                  for ch in str(request_id))
    stem, dot, suffix = base.rpartition(".")
    if not dot:
        return f"{base}.{rid}"
    return f"{stem}.{rid}.{suffix}"


def class_summary(cases: Dict) -> None:
    first = cases[min(cases.keys())]
    sections = [("Scenario", first.scenario), ("Finance", first.finance),
                ("Results", first.results)]
    sections += [(f"{tag} (id {der_id or '1'})", keys)
                 for tag, der_id, keys in first.ders]
    sections += [(tag, keys) for tag, keys in first.streams.items()]
    lines = ["", "=" * 60, "INPUT SUMMARY", "=" * 60]
    for title, keys in sections:
        lines.append(f"--- {title} ---")
        df = pd.Series({k: v for k, v in sorted(keys.items())}, dtype=object)
        lines.append(df.to_string())
    if len(cases) > 1:
        lines.append(f"--- Sensitivity: {len(cases)} cases ---")
        lines.append(first.sensitivity_df.to_string())
    TellUser.info("\n".join(lines))


def run_health_report(health_by_case: Dict, quarantined: Dict,
                      certification_by_case: Dict = None) -> Dict:
    """Aggregate per-case window-health counters into one run report.

    ``health_by_case``: case key -> the scenario's ``health`` dict.
    ``quarantined``: case key -> quarantine record (reason/window) for
    cases dropped by the failure-isolation layer.
    ``certification_by_case`` (optional): case key -> the scenario's
    ``certification`` dict (numerical trust layer) — aggregated into a
    ``certification`` section: per-window float64 certificate counts,
    rejected-then-recovered recoveries, shadow-solve drift stats, and
    the active tolerance policy."""
    totals = {k: 0 for k in HEALTH_KEYS}
    retry_s = 0.0
    watchdog = 0
    for h in health_by_case.values():
        for k in HEALTH_KEYS:
            totals[k] += int(h.get(k, 0))
        retry_s += float(h.get("retry_seconds", 0.0))
        # event counter, not a disjoint window bucket: a timed-out solve's
        # windows still land in retried/cpu_fallback/quarantined
        watchdog += int(h.get("watchdog_timeouts", 0))
    report = {
        "windows": totals,
        "retry_seconds": round(retry_s, 3),
        "watchdog_timeouts": watchdog,
        "cases_total": len(health_by_case),
        "cases_quarantined": sorted(str(k) for k in quarantined),
        "quarantine_reasons": {str(k): (q.get("reason") if
                                        isinstance(q, dict) else str(q))
                               for k, q in quarantined.items()},
        "per_case": {str(k): {kk: h.get(kk, 0) for kk in
                              HEALTH_KEYS + ("retry_seconds",
                                             "watchdog_timeouts")}
                     for k, h in health_by_case.items()},
    }
    # solver version stamp: provenance for every persisted answer, and
    # part of the router's request-cache key (service/reqcache.py) so a
    # numerics upgrade can never serve a stale memoized answer.  Lazy
    # import — this module stays importable without jax.
    try:
        from ..ops.pdhg import SOLVER_VERSION
        report["solver_version"] = str(SOLVER_VERSION)
    except Exception:
        report["solver_version"] = "unknown"
    if certification_by_case is not None:
        from ..ops import certify
        report["certification"] = certify.aggregate_certification(
            certification_by_case)
    return report


def log_health_report(report: Dict) -> None:
    """One TellUser line summarizing the run's solver health; WARNING when
    anything degraded, INFO when the run was fully clean."""
    t = report["windows"]
    # degraded-fidelity answers (load-shed screening tier) must never
    # read as healthy certified output in the log trail
    fidelity = report.get("fidelity")
    prefix = (f"[fidelity: {fidelity}] "
              if fidelity not in (None, "certified") else "")
    msg = (f"{prefix}run health: "
           f"{t['clean']} clean / {t['inaccurate']} inaccurate-accepted / "
           f"{t['retried']} retried / {t['cpu_fallback']} CPU-fallback / "
           f"{t['quarantined']} quarantined / "
           f"{t['skipped']} skipped window(s); "
           f"escalation wall time {report['retry_seconds']:.3f}s")
    if report.get("watchdog_timeouts"):
        msg += (f"; {report['watchdog_timeouts']} solve(s) abandoned at "
                "the watchdog deadline")
    cert = report.get("certification")
    if cert and cert.get("enabled"):
        cw = cert["windows"]
        msg += (f"; certification: {cert['windows_certified']} window(s) "
                f"certified ({cw['certified_loose']} loose)")
        if cw["rejected"]:
            msg += (f", {cw['rejected']} rejection(s) "
                    f"[{cw['rejected_then_recovered']} recovered, "
                    f"{cw['rejected_final']} final]")
        sh = cert.get("shadow") or {}
        if sh.get("n"):
            msg += (f"; shadow drift max {sh['rel_diff_max']:.1e} rel "
                    f"over {sh['n']} window(s)")
    if report["cases_quarantined"]:
        msg += (f"; quarantined case(s) "
                f"{', '.join(report['cases_quarantined'])}: "
                + "; ".join(f"case {k}: {r}" for k, r in
                            report["quarantine_reasons"].items()))
    breakers = report.get("breakers") or {}
    tripped = sorted(name for name, b in breakers.items()
                     if b.get("state") != "closed")
    if tripped:
        msg += f"; OPEN breaker(s): {', '.join(tripped)}"
    degraded = any(t[k] for k in HEALTH_KEYS if k != "clean") \
        or bool(prefix) or bool(tripped)
    (TellUser.warning if degraded else TellUser.info)(msg)
