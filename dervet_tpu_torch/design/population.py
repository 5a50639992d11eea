"""Candidate-population generation for the BOOST design service.

Ordinal optimization (PAPERS.md: arxiv 2501.10842) wants a LARGE
candidate population — orders of magnitude past what an exact sweep
could afford — because the screening tier only has to get the ORDER
roughly right, and the probability that the true optimum's neighborhood
survives a top-k cut grows with population density.  This module turns a
:class:`DesignSpec` (per-DER size bounds plus optional budget/coupling
constraints) into that population:

* **Low-discrepancy sampling** — a Halton sequence over the bounded size
  dimensions (deterministic: the same spec always generates the same
  population, so screening results are reproducible run over run and the
  service's poison/fingerprint machinery can key on the spec alone).
* **Optional explicit grid** — callers that want specific candidates
  evaluated (the ``sizing_sweep`` compatibility shim, a refinement pass
  around a previous winner) append exact points; duplicates are removed
  and the grid is sorted so results can never be tie-dependent on input
  order (the old sweep solved duplicate ``(kW, kWh)`` pairs twice).
* **Coupling** — an ESS duration box (``duration_hours``) samples energy
  as ``kW x duration`` so the population concentrates on physically
  sensible designs instead of wasting screening budget on 100-hour
  batteries; a capex ``budget`` cap is applied by the screening layer
  (capex needs constructed DERs) with the dropped count reported, never
  silently.

Every candidate shares the base case's window STRUCTURE (fixed-size
builds differ only in bounds/rhs/costs), which is exactly what the
batched dispatch pipeline wants: thousands of candidates ride the batch
axis in a handful of device dispatches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.params import CaseParams
from ..utils.errors import ParameterError

# rating keys a candidate's (kw, kwh) assignment writes into the DER's
# key dict, per technology tag; tags absent here accept only a kw bound
# (rated_capacity) — a kwh bound on them is a spec error caught below
_ESS_TAGS = ("Battery", "CAES")
_KW_ONLY_KEYS = ("rated_capacity",)
_ESS_KW_KEYS = ("ch_max_rated", "dis_max_rated")
_ESS_KWH_KEYS = ("ene_max_rated",)


@dataclasses.dataclass(frozen=True)
class DERBounds:
    """Size bounds for one DER: ``kw=(lo, hi)`` and, for storage,
    ``kwh=(lo, hi)``.  A ``None`` dimension is left at the case's value."""
    kw: Optional[Tuple[float, float]] = None
    kwh: Optional[Tuple[float, float]] = None


@dataclasses.dataclass
class DesignSpec:
    """One design request: which DERs to size, over what bounds, how many
    candidates to screen, and how many finalists to certify."""
    bounds: Dict[Tuple[str, str], DERBounds]
    population: int = 512
    top_k: int = 8
    # capex cap across the sized DERs (screening drops and reports
    # over-budget candidates); None = unconstrained
    budget: Optional[float] = None
    # ESS coupling: sample energy as kW x duration within this box
    # (intersected with the kwh bounds) instead of independently
    duration_hours: Optional[Tuple[float, float]] = None
    # explicit (kW, kWh) candidates appended to the sampled population —
    # single-sized-DER specs only (the sizing_sweep shim's grid)
    grid: Optional[Sequence[Tuple[float, float]]] = None
    # ordinal refinement: after the loose screen, the best
    # ``refine_keep`` fraction re-screens at the next tighter tolerance
    # tier, ``refine_rounds`` times, before the top-k are certified
    refine_rounds: int = 1
    refine_keep: float = 0.25
    # solver step variant for the SCREENING tiers only (ops/pdhg.py
    # PDHG_VARIANTS): screening solves are hard-budget truncated, so a
    # faster-converging variant buys ranking fidelity at the same
    # candidate cost.  None inherits the base solver options (the
    # certified finalist tier always uses those unchanged).
    screen_variant: Optional[str] = None
    # risk-aware mode: a Monte-Carlo sampler spec (the dict form
    # stochastic.sampler.mc_spec_from_dict accepts — samples/seed/alpha/
    # sigmas) evaluated per FINALIST after certification, adding
    # E[operating value] and CVaR columns + a (capex, E[value], CVaR)
    # Pareto axis to the frontier.  None = deterministic frontier.
    risk: Optional[Dict] = None

    def risk_spec(self):
        """The risk mode's :class:`~dervet_tpu_torch.stochastic.sampler.MCSpec`
        (validated), or None.  Imported lazily — stochastic imports the
        design package, so a module-scope import here would cycle.
        Unless the request names a sample count, the per-finalist cloud
        defaults to 256 draws (top_k x n_samples scenarios ride ONE
        screening dispatch, so this stays a single batch)."""
        if self.risk is None:
            return None
        if not isinstance(self.risk, dict):
            raise ParameterError(
                "design spec: risk must be an object of Monte-Carlo "
                "sampler fields (samples/seed/alpha/...)")
        from ..stochastic.sampler import mc_spec_from_dict
        d = dict(self.risk)
        if "samples" not in d and "n_samples" not in d:
            d["samples"] = 256
        return mc_spec_from_dict(d)

    def validate(self) -> "DesignSpec":
        self.risk_spec()        # raises on a malformed risk block
        if not self.bounds and not self.grid:
            raise ParameterError("design spec: no size bounds and no "
                                 "explicit grid — nothing to design")
        if self.screen_variant is not None:
            from ..ops.pdhg import PDHG_VARIANTS
            if self.screen_variant not in PDHG_VARIANTS:
                raise ParameterError(
                    f"design spec: screen_variant "
                    f"{self.screen_variant!r} is not one of "
                    f"{PDHG_VARIANTS}")
        for (tag, der_id), b in self.bounds.items():
            if b.kw is None and b.kwh is None:
                raise ParameterError(
                    f"design spec: {tag} id={der_id!r} has no bounded "
                    "dimension")
            for name, dim in (("kw", b.kw), ("kwh", b.kwh)):
                if dim is None:
                    continue
                lo, hi = float(dim[0]), float(dim[1])
                if not (np.isfinite(lo) and np.isfinite(hi)) or lo < 0 \
                        or hi < lo:
                    raise ParameterError(
                        f"design spec: {tag} id={der_id!r} {name} bounds "
                        f"({lo}, {hi}) must satisfy 0 <= lo <= hi")
            if b.kwh is not None and tag not in _ESS_TAGS:
                raise ParameterError(
                    f"design spec: {tag} has no energy rating — kwh "
                    "bounds apply to storage tags only")
        if self.grid is not None and not self.bounds:
            raise ParameterError(
                "design spec: an explicit grid needs bounds naming the "
                "sized DER")
        if self.grid is not None and len(self.bounds) > 1:
            raise ParameterError(
                "design spec: an explicit grid names (kW, kWh) pairs for "
                "ONE sized DER; multi-DER specs must sample")
        if self.population < 0 or (self.population == 0 and not self.grid):
            raise ParameterError("design spec: population must be > 0 "
                                 "(or an explicit grid supplied)")
        if self.top_k < 1:
            raise ParameterError("design spec: top_k must be >= 1")
        if self.refine_rounds < 0 or not 0.0 < self.refine_keep <= 1.0:
            raise ParameterError("design spec: refine_rounds >= 0 and "
                                 "0 < refine_keep <= 1 required")
        if self.duration_hours is not None:
            lo, hi = self.duration_hours
            if not 0 < float(lo) <= float(hi):
                raise ParameterError(
                    f"design spec: duration_hours box ({lo}, {hi}) must "
                    "satisfy 0 < lo <= hi")
            for (tag, der_id), b in self.bounds.items():
                if b.kwh is not None and b.kw is None:
                    raise ParameterError(
                        "design spec: duration_hours coupling needs kw "
                        f"bounds on {tag} id={der_id!r}")
        return self

    def normalized(self) -> Dict:
        """Deterministic JSON-able summary — the fingerprint/manifest
        form of the spec."""
        return {
            "bounds": {f"{tag}:{der_id or '1'}":
                       {"kw": list(b.kw) if b.kw else None,
                        "kwh": list(b.kwh) if b.kwh else None}
                       for (tag, der_id), b in sorted(self.bounds.items())},
            "population": int(self.population),
            "top_k": int(self.top_k),
            "budget": self.budget,
            "duration_hours": (list(self.duration_hours)
                               if self.duration_hours else None),
            "grid": ([[float(a), float(b)] for a, b in self.grid]
                     if self.grid is not None else None),
            "refine_rounds": int(self.refine_rounds),
            "refine_keep": float(self.refine_keep),
            "risk": (self.risk_spec().normalized()
                     if self.risk is not None else None),
        }


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One sized design: ``sizes`` assigns (kw, kwh) per target DER
    (kwh ``None`` for power-only technologies)."""
    index: int
    sizes: Tuple[Tuple[str, str, float, Optional[float]], ...]
    source: str = "halton"      # "halton" | "grid"

    def label(self) -> str:
        return ", ".join(
            f"{tag}:{der_id or '1'} {kw:.0f} kW"
            + (f" / {kwh:.0f} kWh" if kwh is not None else "")
            for tag, der_id, kw, kwh in self.sizes)


# ---------------------------------------------------------------------------
# Low-discrepancy sampling
# ---------------------------------------------------------------------------

_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def _van_der_corput(idx: np.ndarray, base: int) -> np.ndarray:
    """Radical-inverse of ``idx`` in ``base`` (vectorized)."""
    i = np.asarray(idx, dtype=np.int64).copy()
    out = np.zeros(i.shape, dtype=np.float64)
    f = 1.0 / base
    while np.any(i > 0):
        out += f * (i % base)
        i //= base
        f /= base
    return out


def halton(n: int, dims: int, skip: int = 20) -> np.ndarray:
    """(n, dims) Halton points in [0, 1) — deterministic low-discrepancy
    coverage (the first ``skip`` points are dropped; early Halton points
    cluster near the origin)."""
    if dims > len(_PRIMES):
        raise ParameterError(
            f"design population: {dims} sampled dimensions exceeds the "
            f"supported {len(_PRIMES)} (too many sized DERs)")
    idx = np.arange(skip + 1, skip + n + 1)
    return np.stack([_van_der_corput(idx, _PRIMES[d])
                     for d in range(dims)], axis=1)


def generate_population(spec: DesignSpec) -> List[Candidate]:
    """The spec's candidate population: Halton samples over the bounded
    dimensions plus any explicit grid points, deduplicated and
    deterministic."""
    spec.validate()
    targets = sorted(spec.bounds.items())
    out: List[Candidate] = []
    if spec.population > 0 and targets:
        # sampled dimensions, in target order: kw then (kwh | duration)
        dims = []
        for (tag, der_id), b in targets:
            if b.kw is not None:
                dims.append((tag, der_id, "kw", b.kw))
            if b.kwh is not None:
                if spec.duration_hours is not None:
                    dims.append((tag, der_id, "dur", spec.duration_hours))
                else:
                    dims.append((tag, der_id, "kwh", b.kwh))
        pts = halton(spec.population, len(dims))
        for i in range(spec.population):
            sizes = []
            for (tag, der_id), b in targets:
                kw = kwh = None
                for d, (t, di, kind, (lo, hi)) in enumerate(dims):
                    if (t, di) != (tag, der_id):
                        continue
                    v = float(lo) + pts[i, d] * (float(hi) - float(lo))
                    if kind == "kw":
                        kw = v
                    elif kind == "kwh":
                        kwh = v
                    else:           # duration coupling: kwh = kw x hours
                        klo, khi = b.kwh
                        kwh = float(np.clip(kw * v, float(klo),
                                            float(khi)))
                sizes.append((tag, der_id, kw, kwh))
            out.append(Candidate(index=i, sizes=tuple(sizes),
                                 source="halton"))
    if spec.grid is not None:
        (tag, der_id), b = targets[0] if targets else ((None, None), None)
        if tag is None:
            raise ParameterError("design spec: an explicit grid needs "
                                 "bounds naming the sized DER")
        # dedupe + sort: duplicate pairs would solve twice and make the
        # winner tie-dependent on input order (the old sizing_sweep bug)
        kwh_applies = tag in _ESS_TAGS
        pairs = sorted({(float(kw), float(kwh)) for kw, kwh in spec.grid})
        base = len(out)
        for j, (kw, kwh) in enumerate(pairs):
            out.append(Candidate(
                index=base + j,
                sizes=((tag, der_id, kw, kwh if kwh_applies else None),),
                source="grid"))
    if not out:
        raise ParameterError("design population: spec generated no "
                             "candidates")
    return out


# ---------------------------------------------------------------------------
# Candidate cases
# ---------------------------------------------------------------------------

def candidate_case(case: CaseParams, cand: Candidate,
                   case_id=None) -> CaseParams:
    """A :class:`CaseParams` clone with the candidate's ratings written
    into the target DERs' keys.  The referenced data FRAMES are shared
    (read-only through the assembly path — a 512-candidate population
    must not hold 512 copies of a year of time series); the mutable
    containers (key dicts, scenario/finance dicts, the Datasets holder
    itself) are copied per candidate."""
    ders = []
    matched = set()
    for tag, der_id, keys in case.ders:
        k = dict(keys)
        for (t, di, kw, kwh) in cand.sizes:
            if t != tag or (di or "1") != (der_id or "1"):
                continue
            matched.add((t, di))
            if kw is not None:
                for key in (_ESS_KW_KEYS if tag in _ESS_TAGS
                            else _KW_ONLY_KEYS):
                    k[key] = kw
            if kwh is not None:
                for key in _ESS_KWH_KEYS:
                    k[key] = kwh
        ders.append((tag, der_id, k))
    missing = [(t, di) for (t, di, _, _) in cand.sizes
               if (t, di) not in matched]
    if missing:
        t, di = missing[0]
        raise ParameterError(f"design population: no {t} id={di!r} in "
                             "the case")
    return dataclasses.replace(
        case,
        case_id=case.case_id if case_id is None else case_id,
        scenario=dict(case.scenario), finance=dict(case.finance),
        results=dict(case.results),
        streams={t: dict(v) for t, v in case.streams.items()},
        ders=ders, datasets=dataclasses.replace(case.datasets))


def guard_design_case(scenario) -> None:
    """The fixed-size contract: a candidate scenario must not carry size
    VARIABLES (zero ratings elsewhere in the case would silently add
    them) and must not use the binary formulation (the batched screening
    path would rank candidates on LP-relaxation objectives the binary
    formulation never attains — same prohibition as the reference's
    binary+sizing error, MicrogridPOI.py:132-147)."""
    if scenario.poi.is_sizing_optimization:
        raise ParameterError(
            "design population drives FIXED-size candidates; zero "
            "ratings elsewhere in the case would add size variables — "
            "bound every sized DER explicitly")
    if scenario.incl_binary:
        raise ParameterError(
            "design screening cannot rank candidates under the binary "
            "formulation (scenario binary=1): the batched screen would "
            "silently solve the LP relaxation of the on/off windows.  "
            "Set binary=0 (reference forbids binary+sizing, "
            "MicrogridPOI.py:132-147)")
