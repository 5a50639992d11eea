"""Distributional results: quantiles, mean, CVaR — and the MC answer.

Every statistic is recomputed HOST-SIDE in float64 from the per-sample
objective vector (the device solves produce the objectives; the
distribution math never runs on the accelerator), so the published
numbers are independent of batch width, padding, or device count — and
a test can re-derive them to 1e-9 from the published samples alone.

CVaR definition (documented for the README and pinned by tests): the
objectives are COSTS (lower is better), so the risk tail is the UPPER
tail — ``cvar_alpha = mean of the worst ceil((1 - alpha) * n) sample
objectives``, i.e. the expected cost GIVEN the (1 - alpha) worst
outcomes.  ``var_alpha`` is the plain ``alpha`` quantile (linear
interpolation, numpy default).

:class:`MCDistribution` mirrors the serving layer's ``Result`` contract
(``fidelity`` / ``resubmit_hint`` / ``request_id`` /
``request_latency_s`` / ``run_health`` / ``solve_ledger`` /
``save_as_csv``) so a Monte-Carlo request rides the same spool delivery
path as every other request type.  ``mc_distribution.json`` holds ONLY
deterministic content (spec, per-sample records, statistics — no
timings, no compile counts), so a fixed-seed rerun is byte-identical.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import pandas as pd

from ..utils.errors import TellUser

FIDELITY_CERTIFIED = "certified"
FIDELITY_DEGRADED = "degraded"


def cvar(values, alpha: float) -> float:
    """Upper-tail conditional value-at-risk of a COST sample vector in
    float64: the mean of the worst ``ceil((1 - alpha) * n)`` values.
    The tail size is rounded through a 1e-12 guard so alpha values that
    are exact in decimal (0.95 of 1024 -> 51.2 -> 52) never flip on
    binary representation error."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    n = v.size
    k = max(1, int(math.ceil(round((1.0 - float(alpha)) * n, 12))))
    return float(v[-k:].mean())


def distribution_stats(objectives, alpha: float,
                       quantiles: Sequence[float]) -> Dict:
    """The full distributional summary of one objective vector, all
    float64 host math."""
    v = np.asarray(objectives, dtype=np.float64)
    qs = sorted(float(q) for q in set(quantiles))
    return {
        "n": int(v.size),
        "mean": float(v.mean()),
        "std": float(v.std(ddof=0)),
        "min": float(v.min()),
        "max": float(v.max()),
        "quantiles": {f"p{100.0 * q:g}": float(np.quantile(v, q))
                      for q in qs},
        "alpha": float(alpha),
        "var_alpha": float(np.quantile(v, float(alpha))),
        "cvar_alpha": cvar(v, alpha),
    }


def pinning_positions(objectives, quantiles: Sequence[float],
                      alpha: float) -> List[int]:
    """Positions (into ``objectives``) of the QUANTILE-PINNING samples:
    the order statistics each requested quantile (and the VaR level)
    interpolates between, plus the entire CVaR tail.  These are the
    samples whose values the published statistics actually depend on
    most — they get the full certified re-solve while the sample mass
    stays at the screening tier."""
    v = np.asarray(objectives, dtype=np.float64)
    n = v.size
    order = np.argsort(v, kind="stable")
    picks = set()
    for q in tuple(quantiles) + (alpha,):
        pos = float(q) * (n - 1)
        picks.add(int(order[int(math.floor(pos))]))
        picks.add(int(order[int(math.ceil(pos))]))
    k = max(1, int(math.ceil(round((1.0 - float(alpha)) * n, 12))))
    picks.update(int(i) for i in order[n - k:])
    return sorted(picks)


class MCDistribution:
    """A Monte-Carlo valuation request's answer: the per-sample record
    table, the float64 distributional statistics, and the engine's
    observability surface."""

    def __init__(self, *, samples: pd.DataFrame, stats: Dict, spec: Dict,
                 tier_mix: Dict, engine: Optional[Dict] = None,
                 fidelity: str = FIDELITY_CERTIFIED,
                 request_id: Optional[str] = None):
        self.samples = samples      # sample/objective/tier/certified/...
        self.stats = stats          # distribution_stats() output
        self.spec = spec            # MCSpec.normalized()
        self.tier_mix = tier_mix    # deterministic per-tier counts
        self.engine = engine or {}  # rounds/dispatches/compiles/timing
        self.fidelity = fidelity
        self.resubmit_hint: Optional[str] = None
        self.request_id = request_id
        self.request_latency_s: Optional[float] = None
        self.run_health: Optional[Dict] = None
        self.solve_ledger: Optional[Dict] = None

    # ------------------------------------------------------------------
    @property
    def pinning_all_certified(self) -> bool:
        """Did every quantile-pinning sample end with an accepted
        certificate?  (Vacuously False for a degraded answer — nothing
        was ever certified.)"""
        pinned = self.samples[self.samples["tier"] == "certified"]
        return bool(len(pinned)) and bool(pinned["certified"].all())

    def as_dict(self) -> Dict:
        """The ``mc_distribution.json`` payload — DETERMINISTIC content
        only (a fixed-seed rerun must serialize byte-identical, so no
        wall-clock, no compile/dispatch counts in here)."""
        records = []
        for row in self.samples.sort_values("sample").itertuples():
            records.append({
                "sample": int(row.sample),
                "objective": (None if not np.isfinite(row.objective)
                              else float(row.objective)),
                "tier": row.tier,
                "certified": bool(row.certified),
                "quarantined": bool(row.quarantined),
                "reason": row.reason,
            })
        return {
            "request_id": self.request_id,
            "fidelity": self.fidelity,
            "resubmit_hint": self.resubmit_hint,
            "spec": self.spec,
            "stats": self.stats,
            "tier_mix": self.tier_mix,
            "samples": records,
        }

    def to_json(self) -> str:
        """Canonical serialization: sorted keys, fixed indent — the
        byte-identity surface the determinism tests and the smoke gate
        compare."""
        return json.dumps(self.as_dict(), indent=2, sort_keys=True)

    def save_as_csv(self, out_dir=None) -> None:
        """Results-layer serialization: the canonical distribution JSON,
        the per-sample table as CSV, plus run-health/ledger artifacts —
        all atomic writes (same discipline as every other result
        type)."""
        from ..io.summary import run_artifact_name
        from ..utils.supervisor import atomic_output, atomic_write
        out = Path(out_dir or "Results")
        out.mkdir(parents=True, exist_ok=True)
        atomic_write(out / "mc_distribution.json", self.to_json())
        with atomic_output(out / "mc_samples.csv") as tmp:
            self.samples.sort_values("sample").to_csv(tmp, index=False)
        if self.run_health is not None:
            atomic_write(out / run_artifact_name("run_health.json",
                                                 self.request_id),
                         json.dumps(self.run_health, indent=2,
                                    default=str))
        if self.request_id is not None and self.solve_ledger is not None:
            atomic_write(out / run_artifact_name("solve_ledger.json",
                                                 self.request_id),
                         json.dumps(self.solve_ledger, indent=2,
                                    default=str))
        TellUser.info(f"mc distribution saved to {out}")
