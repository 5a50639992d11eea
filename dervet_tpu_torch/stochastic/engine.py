"""Batched Monte-Carlo valuation: 10^3-10^4 samples, one dispatch per tier.

The engine's whole premise is that every sample of one case shares the
base case's window STRUCTURE byte-for-byte (the sampler perturbs values
only), so the full sample mass rides the existing ``run_dispatch``
pipeline as ONE structure group per tier:

* **screening tier** — every sample solves at a loose-tolerance
  hard-budget screening tier (``design/screen.SCREEN_TIERS``) with
  float64 certification FORCED OFF via the PR-6 thread-local policy
  override.  One ``run_dispatch``; compiles amortize to zero after the
  first round because all samples share one compiled solver.
* **certified tier** — the QUANTILE-PINNING samples (the order
  statistics the published quantiles/VaR interpolate between, plus the
  whole CVaR tail) re-solve FRESH at the ambient certified policy (full
  PR-4 float64 certificates, escalation ladder).  One more
  ``run_dispatch``.  The published statistics are then recomputed
  host-side in float64 from the per-sample vector where pinned samples
  carry their certified values.

Degraded contract (load shed): ``certify=False`` runs the screening
tier only over a REDUCED sample count
(``DERVET_TPU_MC_DEGRADED_SAMPLES``), marks the answer
``fidelity="degraded"`` with a resubmit hint, and never stamps a
certificate on anything.

Determinism: sample values derive from (seed, index) only, statistics
from the published per-sample vector only, and ``sample_order`` merely
permutes the SOLVE order (results re-key by sample index) — so a fixed
seed yields a byte-identical ``mc_distribution.json`` across runs and
across batch orderings.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

from ..ops import certify
from ..scenario.scenario import MicrogridScenario, SolverCache, run_dispatch
from ..utils.errors import AggregatedSolverError, ParameterError, \
    SolverError, TellUser
from ..design.screen import ScreeningCaches, dispatch_device, \
    score_scenario, screening_options
from .distribution import FIDELITY_CERTIFIED, FIDELITY_DEGRADED, \
    MCDistribution, distribution_stats, pinning_positions
from .sampler import MCSpec, sample_case

# shed-tier sample count: a degraded MC answer still shows the SHAPE of
# the distribution, just from fewer draws (env-tunable)
MC_DEGRADED_SAMPLES_ENV = "DERVET_TPU_MC_DEGRADED_SAMPLES"
_MC_DEGRADED_SAMPLES_DEFAULT = 128


def degraded_samples() -> int:
    try:
        n = int(os.environ.get(MC_DEGRADED_SAMPLES_ENV,
                               _MC_DEGRADED_SAMPLES_DEFAULT))
    except ValueError:
        n = _MC_DEGRADED_SAMPLES_DEFAULT
    return max(2, n)


def build_sample_scenarios(case, spec: MCSpec, indices: Sequence[int], *,
                           request_id: Optional[str] = None,
                           id_prefix: str = "mc"
                           ) -> List[MicrogridScenario]:
    """One scenario per sample index, case ids ``mc.s00003``-style so a
    quarantine diagnostic names the exact sample it hit."""
    scens = []
    for idx in indices:
        c = sample_case(case, spec, idx, case_id=f"{id_prefix}.s{idx:05d}")
        s = MicrogridScenario(c)
        if request_id is not None:
            s.request_id = request_id
        scens.append(s)
    return scens


def _round_stats(scens, label: str, elapsed: float,
                 failed: bool = False) -> Dict:
    ledger = ({} if failed or not scens
              else scens[0].solve_metadata.get("solve_ledger") or {})
    totals = ledger.get("totals") or {}
    warm = ledger.get("warm_start") or {}
    return {"tier": label, "samples": len(scens),
            "round_s": round(elapsed, 3),
            "dispatches": int(totals.get("dispatches", 0)),
            "chunks": int(totals.get("chunks", 0)),
            "compile_events": int(totals.get("compile_events", 0)),
            "windows": int(totals.get("windows", 0)),
            # warm-start split of the round's windows: shipped verbatim
            # from the solution memory (no device work) / seeded / cold
            "substituted": int(warm.get("substituted", 0)),
            "seeded": int(warm.get("seeded", 0)),
            "cold": int(warm.get("cold", 0))}


def run_montecarlo(case, spec: MCSpec, *, backend: str = "torch",
                   device=None, solver_opts=None,
                   caches: Optional[ScreeningCaches] = None,
                   final_cache: Optional[SolverCache] = None,
                   supervisor=None, certify_tier: bool = True,
                   request_id: Optional[str] = None,
                   sample_order: Optional[Sequence[int]] = None,
                   n_samples: Optional[int] = None) -> MCDistribution:
    """Monte-Carlo valuation of ``case`` under ``spec``.

    ``certify_tier=False`` is the load-shed path: screening tier only,
    reduced sample count, ``fidelity="degraded"``, never cert-stamped.
    ``sample_order`` permutes the solve-batch order (determinism tests
    reverse it — the published result must not change).  ``n_samples``
    overrides the spec's count (the shed tier reduces it).  ``device`` is
    where the 'torch' backend solves (``None`` -> the GPU, raising when
    none is visible; ``"cpu"`` runs the kernels' plain versions)."""
    spec.validate()
    device = dispatch_device(backend, device)
    t0 = time.perf_counter()
    n = int(n_samples if n_samples is not None else spec.n_samples)
    if not certify_tier:
        n = min(n, degraded_samples())
    indices = list(range(n))
    order = list(sample_order) if sample_order is not None else indices
    if sorted(order) != indices:
        raise ParameterError(
            "monte-carlo: sample_order must be a permutation of "
            f"range({n})")

    # --- screening tier: the whole sample mass, one dispatch, cert OFF
    scens = build_sample_scenarios(case, spec, order,
                                   request_id=request_id)
    by_idx = {idx: s for idx, s in zip(order, scens)}
    policy = dataclasses.replace(certify.policy_from_env(), enabled=False)
    caches = caches if caches is not None else ScreeningCaches(
        pad_grid=(backend != "cpu"), device=device)
    if caches.memory is not None:
        # every window of the batch must stay resident: LRU eviction
        # below the batch size downgrades a fixed-seed repeat from
        # exact-grade substitution to near-grade re-convergence, which
        # breaks the byte-identical replay contract.  The memory holds
        # one entry per WINDOW (a full-year sample has 12), so n counts
        # windows here, not samples
        caches.memory.ensure_capacity(
            2 * max(n, sum(len(s.windows) for s in scens)) + 64)
    opts = screening_options(solver_opts, spec.screen_tier)
    t_screen = time.perf_counter()
    all_failed = None
    with certify.policy_override(policy):
        try:
            # one wide structure group — split the single batch over the
            # devices rather than handing it to the elastic scheduler
            run_dispatch(scens, backend=backend, solver_opts=opts,
                         solver_cache=caches.tier(spec.screen_tier),
                         supervisor=supervisor, device=device,
                         elastic=False)
        except AggregatedSolverError as e:
            all_failed = e
    screen_s = time.perf_counter() - t_screen
    if all_failed is not None:
        raise SolverError(
            f"monte-carlo: every sample failed screening ({all_failed})")
    rounds = [_round_stats(scens, "screening", screen_s)]
    cert_stamped = any(bool((getattr(s, "certification", None) or {})
                            .get("enabled")) for s in scens)

    screen_obj = np.full(n, np.nan)
    reasons: Dict[int, Optional[str]] = {}
    for idx in indices:
        s = by_idx[idx]
        if s.quarantine is not None:
            reasons[idx] = (f"sample {idx} quarantined: "
                            f"{(s.quarantine or {}).get('reason')}")
        else:
            screen_obj[idx] = score_scenario(s)
            reasons[idx] = None
    finite = [i for i in indices if np.isfinite(screen_obj[i])]
    if len(finite) < 2:
        raise SolverError(
            f"monte-carlo: only {len(finite)}/{n} sample(s) survived "
            "screening — no distribution to publish")

    # --- certified tier: FRESH solves of the quantile-pinning samples
    pinned: List[int] = []
    certified_ids: Dict[int, bool] = {}
    certify_s = 0.0
    if certify_tier:
        pos = pinning_positions(screen_obj[finite], spec.quantiles,
                                spec.alpha)
        pinned = sorted(finite[p] for p in pos)
        final_cache = final_cache if final_cache is not None else \
            SolverCache(pad_grid=(backend != "cpu"), memory=caches.memory,
                        device=device)
        cert_scens = build_sample_scenarios(case, spec, pinned,
                                            request_id=request_id)
        t_cert = time.perf_counter()
        try:
            run_dispatch(cert_scens, backend=backend,
                         solver_opts=solver_opts,
                         solver_cache=final_cache, supervisor=supervisor,
                         device=device)
        except AggregatedSolverError:
            pass    # reported per-sample below, never silently
        certify_s = time.perf_counter() - t_cert
        rounds.append(_round_stats(cert_scens, "certified", certify_s))
        from ..design.frontier import certified_ok
        for idx, s in zip(pinned, cert_scens):
            if s.quarantine is not None:
                certified_ids[idx] = False
                reasons[idx] = (f"sample {idx} certified re-solve "
                                "quarantined: "
                                f"{(s.quarantine or {}).get('reason')}")
            else:
                certified_ids[idx] = certified_ok(s)
                screen_obj[idx] = score_scenario(s)
        by_idx.update(zip(pinned, cert_scens))

    # --- publish: stats recomputed float64 from the published vector
    published = screen_obj
    fin_vals = published[np.isfinite(published)]
    stats = distribution_stats(fin_vals, spec.alpha, spec.quantiles)
    records = []
    for idx in indices:
        tier = "certified" if idx in certified_ids else "screening"
        records.append({
            "sample": idx,
            "objective": float(published[idx]),
            "tier": tier,
            "certified": bool(certified_ids.get(idx, False)),
            "quarantined": reasons[idx] is not None,
            "reason": reasons[idx],
        })
    n_quar = sum(1 for r in records if r["quarantined"])
    tier_mix = {"screening": n - len(pinned), "certified": len(pinned),
                "quarantined": n_quar}
    total_s = time.perf_counter() - t0
    engine = {
        "rounds": rounds,
        "dispatches": sum(r["dispatches"] for r in rounds),
        "compile_events": sum(r["compile_events"] for r in rounds),
        "screen_s": round(screen_s, 3),
        "certify_s": round(certify_s, 3),
        "total_s": round(total_s, 3),
        "samples_per_s_screening": (round(n / screen_s, 2)
                                    if screen_s else None),
        "samples_per_s_certified": (round(len(pinned) / certify_s, 2)
                                    if certify_s else None),
        "certification_stamped_screening": cert_stamped,
    }
    out = MCDistribution(
        samples=pd.DataFrame(records), stats=stats,
        spec=spec.normalized(), tier_mix=tier_mix, engine=engine,
        fidelity=FIDELITY_CERTIFIED if certify_tier else FIDELITY_DEGRADED,
        request_id=request_id)
    if not certify_tier:
        out.resubmit_hint = (
            f"degraded-fidelity monte-carlo answer: {n} screening-tier "
            f"sample(s) (requested {spec.n_samples}), NO certificates — "
            "resubmit (higher priority) for the full certified "
            "distribution")
    s0 = next((by_idx[i] for i in (pinned or indices)
               if by_idx[i].quarantine is None), None)
    if s0 is not None:
        out.solve_ledger = s0.solve_metadata.get("solve_ledger")
    from ..io.summary import run_health_report
    health_scens = {f"s{i:05d}": by_idx[i]
                    for i in (pinned if certify_tier else indices)}
    health = run_health_report(
        {k: getattr(s, "health", {}) for k, s in health_scens.items()},
        {k: s.quarantine for k, s in health_scens.items()
         if s.quarantine is not None},
        certification_by_case={k: getattr(s, "certification", None)
                               for k, s in health_scens.items()})
    health["fidelity"] = out.fidelity
    health["monte_carlo"] = {"tier_mix": tier_mix, "engine": engine}
    out.run_health = health
    TellUser.info(
        f"monte-carlo: {n} sample(s) "
        f"({tier_mix['certified']} certified-pinning, "
        f"{n_quar} quarantined) in {total_s:.2f}s — mean "
        f"{stats['mean']:.0f}, p50 {stats['quantiles'].get('p50', float('nan')):.0f}, "
        f"CVaR{spec.alpha:.2f} {stats['cvar_alpha']:.0f}")
    return out


# ---------------------------------------------------------------------------
# Risk-aware design: per-finalist MC at the screening tier
# ---------------------------------------------------------------------------

def evaluate_finalist_risk(case, finalists, spec: MCSpec, *,
                           backend: str = "torch", device=None,
                           solver_opts=None,
                           caches: Optional[ScreeningCaches] = None,
                           supervisor=None,
                           request_id: Optional[str] = None) -> Dict:
    """Per-finalist Monte-Carlo risk numbers for the design frontier's
    CVaR axis: every (finalist, sample) pair solves in ONE screening-tier
    dispatch (finalists share the samples' window structure, so the
    whole cross product co-batches), then E[operating value] and
    CVaR-alpha are reduced host-side per finalist.

    The risk axis is ORDINAL-tier by design — the finalists' HEADLINE
    values stay the certified solves; the MC cloud only orders them by
    risk.  Returns ``{candidate_index: {"mc_mean", "mc_cvar",
    "mc_samples", "mc_alpha", "mc_quarantined"}}``."""
    from ..design.frontier import candidate_key
    from ..design.population import candidate_case
    from .distribution import cvar as _cvar
    spec.validate()
    device = dispatch_device(backend, device)
    caches = caches if caches is not None else ScreeningCaches(
        pad_grid=(backend != "cpu"), device=device)
    indices = list(range(int(spec.n_samples)))
    scens: List[MicrogridScenario] = []
    keys: List = []     # (candidate_index, sample_idx) per scenario
    for e in finalists:
        ckey = candidate_key(e.candidate)
        cand_case = candidate_case(case, e.candidate,
                                   case_id=f"mcrisk.{ckey}")
        for idx in indices:
            c = sample_case(cand_case, spec, idx,
                            case_id=f"mcrisk.{ckey}.s{idx:05d}")
            s = MicrogridScenario(c)
            if request_id is not None:
                s.request_id = request_id
            scens.append(s)
            keys.append((e.candidate.index, idx))
    if caches.memory is not None:
        # the finalist x sample cross product's windows must fit the
        # warm-start LRU for repeats to exact-substitute (see
        # run_montecarlo)
        caches.memory.ensure_capacity(
            max(len(finalists) * int(spec.n_samples),
                sum(len(s.windows) for s in scens)) + 64)
    policy = dataclasses.replace(certify.policy_from_env(), enabled=False)
    with certify.policy_override(policy):
        try:
            run_dispatch(scens, backend=backend,
                         solver_opts=screening_options(solver_opts,
                                                       spec.screen_tier),
                         solver_cache=caches.tier(spec.screen_tier),
                         supervisor=supervisor, device=device,
                         elastic=False)
        except AggregatedSolverError as e:
            raise SolverError(
                f"design risk: every finalist sample failed ({e})") from e
    values: Dict[int, List[float]] = {}
    quarantined: Dict[int, int] = {}
    for (cand_idx, _idx), s in zip(keys, scens):
        if s.quarantine is not None:
            quarantined[cand_idx] = quarantined.get(cand_idx, 0) + 1
        else:
            values.setdefault(cand_idx, []).append(score_scenario(s))
    out: Dict = {}
    for e in finalists:
        ci = e.candidate.index
        v = np.asarray(values.get(ci, ()), dtype=np.float64)
        out[ci] = {
            "mc_mean": float(v.mean()) if v.size else float("nan"),
            "mc_cvar": (_cvar(v, spec.alpha) if v.size
                        else float("nan")),
            "mc_samples": int(v.size),
            "mc_alpha": float(spec.alpha),
            "mc_quarantined": int(quarantined.get(ci, 0)),
        }
    return out
