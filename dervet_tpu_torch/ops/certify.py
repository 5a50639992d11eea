"""Independent solution certification + physical-invariant audit.

The numerical trust layer: PDHG self-reports its residuals in its OWN
scaled float32 space (``ops/pdhg.py`` ``_kkt_terms``), so a scaling bug,
a compaction-bucket mixup, or a pipeline data-staging race would ship a
wrong answer stamped "OPTIMAL" — the silent-wrong-answer class that
first-order LP codes guard against with unscaled KKT certification
(PAPERS.md: MPAX; cuPDLP's postsolve checks).  This module re-derives
every accepted solution's quality from the UNSCALED float64 LP data,
entirely independently of the solver:

* :func:`certify_solution` — per-window certificate: primal feasibility
  split by row class (``balance`` equality rows / ``requirement``
  inequality rows / ``bounds`` box violations), objective agreement
  (reported objective vs a float64 ``c @ x`` recompute), and — when a
  dual vector is supplied — dual feasibility and the duality gap.  The
  verdict is ``certified`` / ``certified_loose`` / ``rejected`` under
  the env-tunable :class:`CertPolicy`.
* :func:`audit_case` — scenario-level physical-invariant audit over the
  ASSEMBLED results: the SOE recurrence re-derived timestep by timestep
  (a scrambled scatter or window mixup breaks it even when every window
  was individually optimal), window-seam SOE pins, dispatch-column
  rating bounds, the POI power-balance identity, and per-window
  objective-component reconciliation (labeled components must sum to
  the reported total to 1e-9 — the tiebreak tilt is reported as its own
  explicit column and excluded from the sum; see
  ``models/streams/markets.py``).

Rejected windows do NOT reach the caller: ``scenario.resolve_group``
feeds them back into the PR-1 escalation ladder (boosted retry → exact
CPU fallback) and re-certifies whatever the ladder recovers — see the
``certification`` section of ``run_health.json``.

Env knobs (all optional)::

    DERVET_TPU_CERT=0                 disable the layer entirely
    DERVET_TPU_CERT_EPS_REL=1e-3      per-row relative violation for
                                      'certified'
    DERVET_TPU_CERT_LOOSE_FACTOR=10   'certified_loose' band multiplier
    DERVET_TPU_CERT_EPS_OBJ=2e-4      objective-agreement tolerance
                                      (relative to the |c|@|x| mass)
    DERVET_TPU_CERT_EPS_DUAL=1e-3     dual-feasibility / gap tolerance
    DERVET_TPU_CERT_DUAL=1            fetch duals and certify the dual
                                      side on the batched path too
                                      (default off: keeps the PR-3
                                      y-stays-on-device invariant)
    DERVET_TPU_CERT_SHADOW_K=1        deterministic shadow-solve sample
                                      size per run (0 disables)
    DERVET_TPU_CERT_SHADOW_WARN=5e-3  warn when a shadow re-solve's
                                      objective drifts further than this
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import threading as _threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .lp import LP

VERDICT_CERTIFIED = "certified"
VERDICT_LOOSE = "certified_loose"
VERDICT_REJECTED = "rejected"

# diagnostic prefix the escalation ladder keys on (scenario._escalate
# treats it like the watchdog marker: a cert rejection may come from a
# transient data race, so a re-solve is worth attempting even where a
# deterministic solver failure would go straight to quarantine)
REJECT_DIAG_PREFIX = "certification:"


# ---------------------------------------------------------------------------
# Tolerance policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CertPolicy:
    """Certification tolerance policy (see module docstring for the env
    knobs).  ``eps_rel`` grades per-row violations relative to each row's
    own activity scale ``1 + |q_i| + (|K| @ |x|)_i`` — the same
    convention as ``cpu_ref.binary_feasible`` — so the policy is
    dimensionless and survives kW-vs-MW input conventions.  The default
    matches the honest accuracy of the f32 first-order solver at its
    shipped tolerances (eps_rel 1e-4 on 2-norm residuals concentrates up
    to ~10x on a single row); STATUS_INACCURATE acceptances land in the
    ``certified_loose`` band by construction."""

    enabled: bool = True
    eps_rel: float = 1e-3
    loose_factor: float = 10.0
    eps_obj: float = 2e-4
    eps_dual: float = 1e-3
    check_dual: bool = False
    shadow_k: int = 1
    shadow_warn: float = 5e-3

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_ENV_VARS = ("DERVET_TPU_CERT", "DERVET_TPU_CERT_EPS_REL",
             "DERVET_TPU_CERT_LOOSE_FACTOR", "DERVET_TPU_CERT_EPS_OBJ",
             "DERVET_TPU_CERT_EPS_DUAL", "DERVET_TPU_CERT_DUAL",
             "DERVET_TPU_CERT_SHADOW_K", "DERVET_TPU_CERT_SHADOW_WARN")
_POLICY_MEMO: Optional[CertPolicy] = None
_POLICY_SNAPSHOT: Optional[tuple] = None

# thread-local policy override (service degraded tier): scoping the
# override to the DISPATCHING thread means a concurrent independent
# solve on another thread keeps its own env-derived policy — a
# process-global flip (env var) would silently strip certification
# from bystanders.  Dispatch-internal pool workers receive the policy
# EXPLICITLY (resolve_group's ``policy`` parameter, captured once on
# the dispatching thread), so the override composes with the pipeline.
_TLS = _threading.local()


@contextlib.contextmanager
def policy_override(policy: CertPolicy):
    """Install ``policy`` as this THREAD's active certification policy
    for the duration (see the thread-local note above)."""
    prev = getattr(_TLS, "override", None)
    _TLS.override = policy
    try:
        yield policy
    finally:
        _TLS.override = prev


def policy_from_env() -> CertPolicy:
    """The active policy: this thread's ``policy_override`` if one is
    installed, else the env-knob policy (memoized per snapshot — the
    hot path consults it once per window group)."""
    override = getattr(_TLS, "override", None)
    if override is not None:
        return override
    global _POLICY_MEMO, _POLICY_SNAPSHOT
    snap = tuple(os.environ.get(k) for k in _ENV_VARS)
    if snap == _POLICY_SNAPSHOT and _POLICY_MEMO is not None:
        return _POLICY_MEMO
    d = CertPolicy()

    def _f(name, default):
        raw = os.environ.get(name)
        try:
            return float(raw) if raw not in (None, "") else default
        except ValueError:
            return default

    enabled = os.environ.get("DERVET_TPU_CERT", "1").strip().lower() \
        not in ("0", "false", "off")
    _POLICY_SNAPSHOT = snap
    _POLICY_MEMO = CertPolicy(
        enabled=enabled,
        eps_rel=_f("DERVET_TPU_CERT_EPS_REL", d.eps_rel),
        loose_factor=_f("DERVET_TPU_CERT_LOOSE_FACTOR", d.loose_factor),
        eps_obj=_f("DERVET_TPU_CERT_EPS_OBJ", d.eps_obj),
        eps_dual=_f("DERVET_TPU_CERT_EPS_DUAL", d.eps_dual),
        check_dual=os.environ.get("DERVET_TPU_CERT_DUAL", "").strip().lower()
        in ("1", "true", "on"),
        shadow_k=int(_f("DERVET_TPU_CERT_SHADOW_K", d.shadow_k)),
        shadow_warn=_f("DERVET_TPU_CERT_SHADOW_WARN", d.shadow_warn))
    return _POLICY_MEMO


# ---------------------------------------------------------------------------
# Per-window certificate
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Certificate:
    """One window solution's independent verdict.  ``rel_viol`` holds the
    worst scale-relative violation per row class; ``abs_viol`` the raw
    inf-norms (kW / kWh / $ units of the unscaled problem).  ``dual_*``
    and ``gap_rel`` are None when no dual vector was supplied."""

    verdict: str
    rel_viol: Dict[str, float]
    abs_viol: Dict[str, float]
    obj_rel_err: float
    obj_recomputed: float
    worst_class: str
    worst_group: Optional[str]
    reason: str = ""
    dual_rel_viol: Optional[float] = None
    gap_rel: Optional[float] = None

    @property
    def accepted(self) -> bool:
        return self.verdict != VERDICT_REJECTED

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["rel_viol"] = {k: float(v) for k, v in d["rel_viol"].items()}
        d["abs_viol"] = {k: float(v) for k, v in d["abs_viol"].items()}
        return d


# id(K) -> (weakref to K, |K|): windows of a structure group share one K
# object byte-identically (LPBuilder.build_data), so the O(nnz) abs-copy
# the row-scale needs is paid once per DISTINCT matrix, not once per
# window certificate.  Weakref-guarded against id reuse, same pattern as
# MicrogridScenario._skey_memo.
_ABSK_MEMO: Dict[int, tuple] = {}


def _abs_K(K):
    import weakref

    entry = _ABSK_MEMO.get(id(K))
    if entry is not None and entry[0]() is K:
        return entry[1]
    absK = K.copy()
    absK.data = np.abs(absK.data)
    if len(_ABSK_MEMO) > 256:
        # sweep dead-weakref entries first (their |K| copies are the
        # actual leak); only if live structures alone exceed the cap do
        # we evict live ones, oldest-inserted first
        for k in [k for k, (ref, _) in _ABSK_MEMO.items() if ref() is None]:
            _ABSK_MEMO.pop(k, None)
        while len(_ABSK_MEMO) > 256:
            _ABSK_MEMO.pop(next(iter(_ABSK_MEMO)))
    _ABSK_MEMO[id(K)] = (weakref.ref(K), absK)
    return absK


def _group_of_row(lp: LP, row: int) -> Optional[str]:
    for name, ranges in lp.row_groups.items():
        for a, b in ranges:
            if a <= row < b:
                return name
    return None


def certify_solution(lp: LP, x, obj: float,
                     policy: Optional[CertPolicy] = None,
                     y=None) -> Certificate:
    """Certify one solution vector against the UNSCALED float64 LP data.

    ``obj`` is the solver-REPORTED objective (``c @ x`` without ``c0`` —
    the convention of ``PDHGResult.obj`` and ``CPUResult.obj``); the
    certificate recomputes it in float64 and grades the disagreement
    against the absolute cost mass ``1 + |c| @ |x|`` (a cancellation-safe
    denominator: dispatch objectives net large revenues against large
    costs).  ``y`` (optional) additionally certifies dual feasibility and
    the duality gap.
    """
    policy = policy or policy_from_env()
    x64 = np.asarray(x, np.float64)
    if not np.all(np.isfinite(x64)):
        return Certificate(
            verdict=VERDICT_REJECTED,
            rel_viol={"balance": np.inf, "requirement": np.inf,
                      "bounds": np.inf},
            abs_viol={"balance": np.inf, "requirement": np.inf,
                      "bounds": np.inf},
            obj_rel_err=np.inf, obj_recomputed=float("nan"),
            worst_class="bounds", worst_group=None,
            reason=f"{int((~np.isfinite(x64)).sum())} non-finite "
                   "solution entr(ies)")

    q = np.asarray(lp.q, np.float64)
    c = np.asarray(lp.c, np.float64)
    l = np.asarray(lp.l, np.float64)
    u = np.asarray(lp.u, np.float64)

    # per-row activity scale: 1 + |q_i| + (|K| @ |x|)_i — the violation a
    # row can plausibly accumulate from honest rounding is proportional
    # to the magnitudes flowing through it
    row_scale = 1.0 + np.abs(q) + _abs_K(lp.K) @ np.abs(x64)

    r = lp.K @ x64 - q
    n_eq = lp.n_eq
    eq_viol = np.abs(r[:n_eq])
    ge_viol = np.maximum(-r[n_eq:], 0.0)

    # variable box violations, graded against 1 + |x| + |finite bound|
    lo_gap = np.where(np.isfinite(l), l - x64, 0.0)
    hi_gap = np.where(np.isfinite(u), x64 - u, 0.0)
    box_viol = np.maximum(np.maximum(lo_gap, hi_gap), 0.0)
    box_scale = 1.0 + np.abs(x64) \
        + np.where(np.isfinite(l), np.abs(l), 0.0) \
        + np.where(np.isfinite(u), np.abs(u), 0.0)

    def _cls(viol, scale):
        if not viol.size:
            return 0.0, 0.0, -1
        rel = viol / scale
        j = int(np.argmax(rel))
        return float(viol[j]), float(rel[j]), j

    eq_abs, eq_rel, eq_j = _cls(eq_viol, row_scale[:n_eq])
    ge_abs, ge_rel, ge_j = _cls(ge_viol, row_scale[n_eq:])
    bx_abs, bx_rel, _ = _cls(box_viol, box_scale)
    rel_viol = {"balance": eq_rel, "requirement": ge_rel, "bounds": bx_rel}
    abs_viol = {"balance": eq_abs, "requirement": ge_abs, "bounds": bx_abs}

    worst_class = max(rel_viol, key=rel_viol.get)
    worst_group = None
    if worst_class == "balance" and eq_j >= 0:
        worst_group = _group_of_row(lp, eq_j)
    elif worst_class == "requirement" and ge_j >= 0:
        worst_group = _group_of_row(lp, n_eq + ge_j)

    obj64 = float(c @ x64)
    obj_mass = 1.0 + float(np.abs(c) @ np.abs(x64))
    obj_rel = abs(obj64 - float(obj)) / obj_mass if np.isfinite(obj) \
        else np.inf

    dual_rel = gap_rel = None
    if y is not None:
        y64 = np.asarray(y, np.float64)
        if y64.shape == (lp.m,) and np.all(np.isfinite(y64)):
            # inequality duals must be >= 0 (GE-sense rows)
            sign_viol = np.maximum(-y64[n_eq:], 0.0)
            lam = c - lp.K.T @ y64
            lam_pos = np.maximum(lam, 0.0)
            lam_neg = np.minimum(lam, 0.0)
            # reduced-cost mass no finite bound can absorb
            dres = np.where(np.isfinite(l), 0.0, lam_pos) \
                + np.where(np.isfinite(u), 0.0, -lam_neg)
            dscale = 1.0 + float(np.linalg.norm(c))
            dual_rel = float(max(
                dres.max() if dres.size else 0.0,
                sign_viol.max() if sign_viol.size else 0.0) / dscale)
            dobj = float(q @ y64
                         + np.sum(np.where(np.isfinite(l), lam_pos * l, 0.0))
                         + np.sum(np.where(np.isfinite(u), lam_neg * u, 0.0)))
            gap_rel = abs(obj64 - dobj) / (1.0 + abs(obj64) + abs(dobj))
        else:
            dual_rel = np.inf

    # ---- verdict ----
    eps, loose = policy.eps_rel, policy.eps_rel * policy.loose_factor
    worst_rel = rel_viol[worst_class]
    reasons: List[str] = []
    loose_hits: List[str] = []
    if worst_rel > loose:
        reasons.append(
            f"primal violation {worst_rel:.2e} rel ({worst_class}"
            + (f", row group {worst_group!r}" if worst_group else "")
            + f") exceeds {loose:.0e}")
    elif worst_rel > eps:
        loose_hits.append(f"primal {worst_class} {worst_rel:.2e}")
    if obj_rel > policy.eps_obj * policy.loose_factor:
        reasons.append(
            f"objective disagreement {obj_rel:.2e} rel "
            f"(reported {float(obj):.6g}, recomputed {obj64:.6g})")
    elif obj_rel > policy.eps_obj:
        loose_hits.append(f"objective {obj_rel:.2e}")
    if dual_rel is not None:
        dl = policy.eps_dual * policy.loose_factor
        if dual_rel > dl:
            reasons.append(f"dual infeasibility {dual_rel:.2e} rel")
        elif dual_rel > policy.eps_dual:
            loose_hits.append(f"dual {dual_rel:.2e}")
        if gap_rel is not None:
            if gap_rel > dl:
                reasons.append(f"duality gap {gap_rel:.2e} rel")
            elif gap_rel > policy.eps_dual:
                loose_hits.append(f"gap {gap_rel:.2e}")
    if reasons:
        verdict, reason = VERDICT_REJECTED, "; ".join(reasons)
    elif loose_hits:
        verdict, reason = VERDICT_LOOSE, "; ".join(loose_hits)
    else:
        verdict, reason = VERDICT_CERTIFIED, ""
    return Certificate(verdict=verdict, rel_viol=rel_viol,
                       abs_viol=abs_viol, obj_rel_err=float(obj_rel),
                       obj_recomputed=obj64, worst_class=worst_class,
                       worst_group=worst_group, reason=reason,
                       dual_rel_viol=dual_rel, gap_rel=gap_rel)


# ---------------------------------------------------------------------------
# Deterministic shadow-solve sampling
# ---------------------------------------------------------------------------

def shadow_rank(case_id, label) -> int:
    """Stable rank of a (case, window) pair for the shadow sample: a
    cryptographic digest of the identifiers, NOT Python's salted hash —
    the sample must be identical across processes and runs so drift
    stats are comparable run over run."""
    h = hashlib.sha256(f"shadow|{case_id}|{label}".encode()).digest()
    return int.from_bytes(h[:8], "big")


def pick_shadow_sample(pairs, k: int) -> List[Tuple[Any, Any]]:
    """The ``k`` (case_id, label) pairs with the smallest shadow ranks —
    a deterministic K-per-run sample over all dispatched windows."""
    if k <= 0 or not pairs:
        return []
    ranked = sorted(pairs, key=lambda p: shadow_rank(p[0], p[1]))
    return ranked[:min(k, len(ranked))]


def new_shadow_stats() -> Dict[str, Any]:
    return {"n": 0, "windows": [], "rel_diff_max": 0.0, "rel_diff_mean": 0.0,
            "shadow_s": 0.0, "_rel_diffs": []}


def record_shadow(stats: Dict[str, Any], label, rel_diff: float) -> None:
    stats["n"] += 1
    stats["windows"].append(label)
    stats["_rel_diffs"].append(float(rel_diff))
    diffs = stats["_rel_diffs"]
    stats["rel_diff_max"] = float(np.max(diffs))
    stats["rel_diff_mean"] = float(np.mean(diffs))


# ---------------------------------------------------------------------------
# Per-case certification ledger
# ---------------------------------------------------------------------------

CERT_COUNT_KEYS = ("certified", "certified_loose", "rejected",
                   "rejected_then_recovered", "rejected_final")


def new_certification(enabled: bool = True) -> Dict[str, Any]:
    """Fresh per-case certification counters (``scenario.certification``).

    ``certified``/``certified_loose``/``rejected_final`` partition every
    window that carried a FINAL accepted-or-quarantined certificate;
    ``rejected`` counts rejection EVENTS (a window rejected then
    recovered contributes to both ``rejected`` and its final bucket) and
    ``rejected_then_recovered`` the recoveries the escalation ladder won
    back."""
    return {**{k: 0 for k in CERT_COUNT_KEYS}, "cert_s": 0.0,
            "enabled": bool(enabled), "windows": {},
            "shadow": new_shadow_stats()}


def aggregate_certification(cert_by_case: Dict) -> Dict[str, Any]:
    """Run-level ``certification`` section from per-case counters."""
    totals = {k: 0 for k in CERT_COUNT_KEYS}
    cert_s = 0.0
    enabled = False
    shadow = new_shadow_stats()
    windows: Dict[str, Any] = {}
    for key, c in cert_by_case.items():
        if not c:
            continue
        enabled = enabled or bool(c.get("enabled"))
        for k in CERT_COUNT_KEYS:
            totals[k] += int(c.get(k, 0))
        cert_s += float(c.get("cert_s", 0.0))
        sh = c.get("shadow") or {}
        shadow["shadow_s"] = round(
            shadow["shadow_s"] + float(sh.get("shadow_s", 0.0)), 4)
        for lbl, rd in zip(sh.get("windows", ()),
                           sh.get("_rel_diffs", ())):
            record_shadow(shadow, f"{key}/{lbl}", rd)
        for lbl, rec in (c.get("windows") or {}).items():
            windows[f"{key}/{lbl}"] = rec
    shadow.pop("_rel_diffs", None)
    out = {
        "enabled": enabled,
        "windows": totals,
        "windows_certified": totals["certified"] + totals["certified_loose"],
        "cert_s": round(cert_s, 4),
        "shadow": shadow,
        "policy": policy_from_env().as_dict(),
    }
    if windows:
        out["rejected_windows"] = windows
    return out


def validate_certification(section: Dict) -> Dict:
    """Schema-check a run-level ``certification`` section (raises
    ``ValueError`` naming the missing/invalid field; returns the section
    unchanged so callers can chain it).  Used by
    ``scripts/certify_smoke.py`` and CI so a schema regression fails
    loudly instead of surfacing as a malformed ``run_health.json``."""
    if not isinstance(section, dict):
        raise ValueError(
            f"certification section must be a dict, got {type(section)}")
    for k in ("enabled", "windows", "windows_certified", "cert_s",
              "shadow", "policy"):
        if k not in section:
            raise ValueError(f"certification section missing {k!r}")
    for k in CERT_COUNT_KEYS:
        v = section["windows"].get(k)
        if not isinstance(v, int) or v < 0:
            raise ValueError(
                f"certification.windows[{k!r}] not a non-negative int: {v}")
    for k in ("n", "rel_diff_max", "rel_diff_mean", "shadow_s"):
        if k not in section["shadow"]:
            raise ValueError(f"certification.shadow missing {k!r}")
    for k in ("eps_rel", "loose_factor", "eps_obj", "eps_dual",
              "shadow_k"):
        if k not in section["policy"]:
            raise ValueError(f"certification.policy missing {k!r}")
    if section["windows_certified"] != section["windows"]["certified"] \
            + section["windows"]["certified_loose"]:
        raise ValueError("windows_certified != certified + certified_loose")
    return section


# ---------------------------------------------------------------------------
# Portfolio-level certificate (coupled-site dual decomposition)
# ---------------------------------------------------------------------------

PORTFOLIO_NOT_CERTIFIED = "not_certified"


def certify_portfolio(coupling_rows, primal_obj: float, dual_bound: float,
                      policy: Optional[CertPolicy] = None, *,
                      inner_exact: bool = False,
                      per_site: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """Portfolio-level certificate for a dual-decomposed coupled solve
    (``dervet_tpu/portfolio``), computed in FLOAT64 against the
    UNSCALED aggregate data — independent of the dual loop's own
    bookkeeping, the same trust posture as :func:`certify_solution`.

    ``coupling_rows`` is a list of dicts, one per coupling constraint
    family, each with ``kind`` (name), ``lhs`` (the aggregate activity
    per row, LE-normalized so feasible means ``lhs <= rhs``), and
    ``rhs``.  Violations are graded relative to each row's own activity
    scale ``1 + |rhs| + |lhs|`` under the policy's ``eps_rel`` /
    ``loose_factor`` bands.  The Lagrangian duality gap
    ``primal - dual_bound`` is graded relative to
    ``1 + |primal| + |dual|`` under ``eps_dual``.  ``inner_exact``
    records whether the dual bound came from EXACT inner solves (cpu
    backend) — with f32 first-order inner solves the bound carries the
    inner tolerance and the gap is honest-but-approximate, which the
    certificate says rather than hides.  ``per_site`` carries the
    aggregated per-site PR-4 certificate counts for the final iterates.

    Returns the ``portfolio`` certification section (run_health /
    solve_ledger / ``service.metrics()['portfolio']`` surface)."""
    policy = policy or policy_from_env()
    rows_out: Dict[str, Any] = {}
    if not policy.enabled:
        return {"enabled": False, "verdict": PORTFOLIO_NOT_CERTIFIED,
                "reason": "certification disabled (policy)",
                "coupling_rows": rows_out, "gap_rel": None,
                "primal_objective": float(primal_obj),
                "dual_bound": float(dual_bound),
                "inner_exact": bool(inner_exact),
                "per_site": per_site or {}}
    eps, loose = policy.eps_rel, policy.eps_rel * policy.loose_factor
    reasons: List[str] = []
    loose_hits: List[str] = []
    for row in coupling_rows:
        kind = str(row["kind"])
        lhs = np.asarray(row["lhs"], np.float64)
        rhs = np.asarray(row["rhs"], np.float64)
        scale = 1.0 + np.abs(rhs) + np.abs(lhs)
        viol = np.maximum(lhs - rhs, 0.0)
        rel = viol / scale
        j = int(np.argmax(rel)) if rel.size else -1
        rel_max = float(rel[j]) if j >= 0 else 0.0
        binding = int(np.sum(np.abs(lhs - rhs) <= eps * scale)) \
            if rel.size else 0
        rows_out[kind] = {
            "rows": int(lhs.size),
            "abs_max_kw": float(viol[j]) if j >= 0 else 0.0,
            "rel_max": rel_max,
            "worst_row": j,
            "binding": binding,
            "ok": rel_max <= loose,
        }
        if rel_max > loose:
            reasons.append(f"coupling row {kind}[{j}] violated "
                           f"{rel_max:.2e} rel (> {loose:.0e})")
        elif rel_max > eps:
            loose_hits.append(f"coupling {kind} {rel_max:.2e}")
    gap = max(float(primal_obj) - float(dual_bound), 0.0)
    gap_rel = gap / (1.0 + abs(float(primal_obj))
                     + abs(float(dual_bound)))
    dl = policy.eps_dual * policy.loose_factor
    if gap_rel > dl:
        reasons.append(f"duality gap {gap_rel:.2e} rel (> {dl:.0e})")
    elif gap_rel > policy.eps_dual:
        loose_hits.append(f"gap {gap_rel:.2e}")
    ps = dict(per_site or {})
    if ps and not ps.get("all_certified", True):
        reasons.append(
            f"{ps.get('windows_total', 0) - ps.get('windows_certified', 0)}"
            " site window(s) without an accepted float64 certificate")
    if reasons:
        verdict, reason = VERDICT_REJECTED, "; ".join(reasons)
    elif loose_hits:
        verdict, reason = VERDICT_LOOSE, "; ".join(loose_hits)
    else:
        verdict, reason = VERDICT_CERTIFIED, ""
    return {"enabled": True, "verdict": verdict, "reason": reason,
            "coupling_rows": rows_out,
            "gap_rel": float(gap_rel), "gap_abs": float(gap),
            "primal_objective": float(primal_obj),
            "dual_bound": float(dual_bound),
            "inner_exact": bool(inner_exact),
            "per_site": ps,
            "policy": policy.as_dict()}


def validate_portfolio_certification(section: Dict) -> Dict:
    """Schema-check a ``portfolio`` certification section (raises
    ``ValueError`` naming the missing/invalid field; returns the section
    unchanged).  Used by ``scripts/portfolio_smoke.py`` and CI."""
    if not isinstance(section, dict):
        raise ValueError(
            f"portfolio section must be a dict, got {type(section)}")
    for k in ("enabled", "verdict", "coupling_rows", "gap_rel",
              "primal_objective", "dual_bound", "inner_exact",
              "per_site"):
        if k not in section:
            raise ValueError(f"portfolio certification missing {k!r}")
    if section["verdict"] not in (VERDICT_CERTIFIED, VERDICT_LOOSE,
                                  VERDICT_REJECTED,
                                  PORTFOLIO_NOT_CERTIFIED):
        raise ValueError(
            f"portfolio verdict invalid: {section['verdict']!r}")
    for kind, row in (section["coupling_rows"] or {}).items():
        for k in ("rows", "rel_max", "abs_max_kw", "binding", "ok"):
            if k not in row:
                raise ValueError(
                    f"portfolio coupling row {kind!r} missing {k!r}")
    if section["enabled"] and section["gap_rel"] is not None \
            and section["gap_rel"] < 0:
        raise ValueError(f"portfolio gap_rel negative: "
                         f"{section['gap_rel']}")
    return section


# ---------------------------------------------------------------------------
# Scenario-level physical-invariant audit
# ---------------------------------------------------------------------------

def audit_case(scenario, ts_data=None, tol_rel: float = 1e-3,
               tol_exact: float = 1e-9) -> Dict[str, Any]:
    """Physical-invariant audit of one case's ASSEMBLED results.

    Runs after dispatch + scatter, over the full-horizon solution arrays
    — exactly the surface a compaction-bucket mixup, a scrambled
    scatter, or an overlapped-post race would corrupt even when every
    individual window certificate passed.  Checks:

    * ``soe_recurrence`` — the storage evolution
      ``ene[t+1] = (1-sdr)*ene[t] + rte*dt*ch[t] - dt*dis[t]`` re-derived
      at every within-window transition (float64, graded relative to the
      energy rating; ``tol_rel`` matches the solver's honest accuracy)
    * ``soe_seams`` — every window's entry SOE pinned to the target
      (skipped for degradation-coupled cases, whose target moves with
      SOH)
    * ``dispatch_bounds`` — ch/dis/ene within rated capacities
    * ``poi_balance`` — the published ``Net Load`` column equals
      ``Total Load - Total Generation - Total Storage Power`` (an exact
      float64 identity of the results assembly; ``tol_exact``-graded)
    * ``objective_components`` — per window, the labeled objective
      components sum to the reported "Total Objective" to ``tol_exact``
      (the tiebreak tilt rides as its own explicit column, excluded from
      the sum — see markets.py)

    Returns a dict with ``ok`` plus per-check maxima; never raises.
    """
    checks: Dict[str, Any] = {}
    ok = True
    solution = getattr(scenario, "_solution", None) or {}
    degrading = any(getattr(d, "incl_cycle_degrade", False)
                    for d in scenario.ders)

    # window start positions in the full horizon
    starts = []
    for ctx in scenario.windows:
        starts.append(int(np.searchsorted(scenario.index, ctx.index[0])))
    start_set = set(starts)

    ess = [d for d in scenario.ders
           if d.technology_type == "Energy Storage System"]
    soe_rel_max = seam_rel_max = bound_rel_max = 0.0
    n_trans = 0
    for d in ess:
        prefix = f"{d.tag}-{d.id or '1'}/"
        ene = solution.get(prefix + "ene")
        ch = solution.get(prefix + "ch")
        dis = solution.get(prefix + "dis")
        if ene is None or ch is None or dis is None:
            continue
        ene = np.asarray(ene, np.float64)
        ch = np.asarray(ch, np.float64)
        dis = np.asarray(dis, np.float64)
        e_rated = max(float(d.energy_capacity()), 1.0)
        dt = scenario.dt
        resid = ene[1:] - (1.0 - d.sdr) * ene[:-1] - d.rte * dt * ch[:-1] \
            + dt * dis[:-1]
        # transitions INTO a window start follow the seam pin, not the
        # recurrence — mask them out of the recurrence residual
        mask = np.ones(len(ene) - 1, bool)
        for s0 in start_set:
            if 1 <= s0 <= len(ene) - 1:
                mask[s0 - 1] = False
        if mask.any():
            soe_rel_max = max(soe_rel_max,
                              float(np.abs(resid[mask]).max()) / e_rated)
            n_trans += int(mask.sum())
        if not degrading and not getattr(d, "being_sized", lambda: False)():
            target = float(d.ene_target)
            seams = np.abs(ene[starts] - target)
            if seams.size:
                seam_rel_max = max(seam_rel_max,
                                   float(seams.max()) / e_rated)
        caps = ((ch, float(d.charge_capacity())),
                (dis, float(d.discharge_capacity())))
        for arr, cap in caps:
            if cap > 0:
                bound_rel_max = max(
                    bound_rel_max,
                    float(np.maximum(arr - cap, 0.0).max()) / cap,
                    float(np.maximum(-arr, 0.0).max()) / cap)
        e_hi = d.ulsoc * e_rated
        if e_hi > 0:
            bound_rel_max = max(
                bound_rel_max,
                float(np.maximum(ene - e_hi, 0.0).max()) / e_rated,
                float(np.maximum(-ene, 0.0).max()) / e_rated)
    checks["soe_recurrence"] = {"rel_max": round(soe_rel_max, 9),
                                "transitions": n_trans,
                                "ok": soe_rel_max <= tol_rel}
    checks["soe_seams"] = {"rel_max": round(seam_rel_max, 9),
                           "ok": seam_rel_max <= tol_rel,
                           "skipped": degrading}
    checks["dispatch_bounds"] = {"rel_max": round(bound_rel_max, 9),
                                 "ok": bound_rel_max <= tol_rel}

    if ts_data is not None and len(ts_data) and \
            "Net Load (kW)" in ts_data.columns:
        net = ts_data["Net Load (kW)"].to_numpy(np.float64)
        load = ts_data.get("Total Load (kW)")
        gen = ts_data.get("Total Generation (kW)")
        sto = ts_data.get("Total Storage Power (kW)")
        if load is not None and gen is not None and sto is not None:
            resid = np.abs(net - (load.to_numpy(np.float64)
                                  - gen.to_numpy(np.float64)
                                  - sto.to_numpy(np.float64)))
            scale = 1.0 + float(np.abs(net).max())
            checks["poi_balance"] = {
                "abs_max_kw": round(float(resid.max()), 9),
                "ok": float(resid.max()) / scale <= tol_exact * 1e3}

    # labeled objective components sum to the reported total; the
    # explicit tiebreak-tilt column is excluded (markets.py subtracts it
    # from the reported total so the LABELED streams reconcile exactly)
    from ..models.streams.markets import TILT_LABEL
    comp_abs_max = 0.0
    for label, breakdown in (scenario.objective_values or {}).items():
        total = breakdown.get("Total Objective")
        if total is None:
            continue
        comp = sum(v for k, v in breakdown.items()
                   if k not in ("Total Objective", TILT_LABEL))
        scale = 1.0 + abs(total)
        comp_abs_max = max(comp_abs_max, abs(comp - total) / scale)
    checks["objective_components"] = {
        "rel_max": round(comp_abs_max, 12),
        "ok": comp_abs_max <= tol_exact,
        "windows": len(scenario.objective_values or {})}

    ok = all(c.get("ok", True) for c in checks.values())
    return {"ok": ok, "checks": checks}


def aggregate_audits(audit_by_case: Dict) -> Dict[str, Any]:
    """Run-level ``invariant_audit`` section: overall pass flag plus the
    failing cases' full detail (passing cases contribute only counts)."""
    out: Dict[str, Any] = {"ok": True, "cases_audited": 0, "failing": {}}
    for key, a in audit_by_case.items():
        if not a:
            continue
        out["cases_audited"] += 1
        if not a.get("ok", True):
            out["ok"] = False
            out["failing"][str(key)] = a
    return out
