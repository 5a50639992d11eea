"""Deterministic seeded scenario sampler for Monte-Carlo valuation.

Every sample is a perturbation of the base case's time-series frame
under three per-stream models:

* **price level/shape shocks** — one mean-one lognormal LEVEL shock per
  sample (systematic year-wide price move) times per-hour multiplicative
  SHAPE noise (hour-to-hour dispersion around the moved level);
* **load noise** — per-hour multiplicative noise on every load column,
  clipped non-negative;
* **solar availability draws** — one per-sample availability factor in
  [0, 1] scaling every generation column (a derate year: soiling, haze,
  curtailment — availability can only remove energy, never add it).

Determinism contract: every draw derives from ``sha256(seed | sample
index)`` — never wall-clock, never global RNG state — so a fixed user
seed reproduces the exact sample set across runs, processes, and batch
orderings, and the request-cache key can be built from (case digest,
spec digest) alone.

Frame sharing (the PR-7 discipline): only ``time_series`` is copied per
sample (its values differ); monthly/tariff/yearly/cycle-life frames are
shared read-only across the whole sample population, so 10^4 samples do
not hold 10^4 copies of the reference data.  Window STRUCTURE is
identical across samples by construction (same index, same columns,
values only), which is exactly what the batched dispatch pipeline
wants: the entire sample mass rides the device batch axis as ONE
structure group.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, Optional, Tuple

import numpy as np

from ..io.params import CaseParams
from ..utils.errors import ParameterError

# admission cap on the sample axis (env-tunable; validate-time check so
# a fat-fingered 10^9-sample request dies at submit, not mid-batch)
MC_MAX_SAMPLES_ENV = "DERVET_TPU_MC_MAX_SAMPLES"
_MC_MAX_SAMPLES_DEFAULT = 65536


def max_samples() -> int:
    try:
        return int(os.environ.get(MC_MAX_SAMPLES_ENV,
                                  _MC_MAX_SAMPLES_DEFAULT))
    except ValueError:
        return _MC_MAX_SAMPLES_DEFAULT


@dataclasses.dataclass
class MCSpec:
    """One Monte-Carlo valuation request: how many samples, seeded how,
    which distribution statistics to pin, and the per-stream
    perturbation magnitudes."""
    n_samples: int = 1024
    seed: int = 0
    # CVaR level: cvar_alpha = mean of the worst ceil((1-alpha)*n)
    # sample objectives (objectives are COSTS, so the upper tail)
    alpha: float = 0.95
    quantiles: Tuple[float, ...] = (0.05, 0.25, 0.5, 0.75, 0.95)
    # per-stream perturbation model (see module docstring)
    price_sigma: float = 0.10        # lognormal level-shock sigma
    price_shape_sigma: float = 0.02  # per-hour shape-noise sigma
    load_sigma: float = 0.05         # per-hour load-noise sigma
    solar_sigma: float = 0.10        # availability-draw sigma
    # screening tier for the sample mass (design/screen.SCREEN_TIERS
    # index — the quantile-pinning samples always re-solve certified)
    screen_tier: int = 0

    def validate(self) -> "MCSpec":
        if int(self.n_samples) < 2:
            raise ParameterError("mc spec: n_samples must be >= 2 "
                                 "(a distribution needs samples)")
        cap = max_samples()
        if int(self.n_samples) > cap:
            raise ParameterError(
                f"mc spec: n_samples {self.n_samples} exceeds the "
                f"{cap} cap ({MC_MAX_SAMPLES_ENV} raises it)")
        if not 0.0 < float(self.alpha) < 1.0:
            raise ParameterError(
                f"mc spec: alpha {self.alpha} must be in (0, 1)")
        if not self.quantiles:
            raise ParameterError("mc spec: at least one quantile")
        for q in self.quantiles:
            if not 0.0 < float(q) < 1.0:
                raise ParameterError(
                    f"mc spec: quantile {q} must be in (0, 1)")
        for name in ("price_sigma", "price_shape_sigma", "load_sigma",
                     "solar_sigma"):
            v = float(getattr(self, name))
            if not np.isfinite(v) or v < 0.0:
                raise ParameterError(
                    f"mc spec: {name} {v} must be finite and >= 0")
        from ..design.screen import SCREEN_TIERS
        if not 0 <= int(self.screen_tier) < len(SCREEN_TIERS):
            raise ParameterError(
                f"mc spec: screen_tier {self.screen_tier} out of range "
                f"[0, {len(SCREEN_TIERS) - 1}]")
        return self

    def normalized(self) -> Dict:
        """Deterministic JSON-able form — the fingerprint/cache-key
        material of the spec (includes the seed: two requests differing
        only in seed must never share a cache entry)."""
        return {
            "n_samples": int(self.n_samples),
            "seed": int(self.seed),
            "alpha": float(self.alpha),
            "quantiles": sorted(float(q) for q in set(self.quantiles)),
            "price_sigma": float(self.price_sigma),
            "price_shape_sigma": float(self.price_shape_sigma),
            "load_sigma": float(self.load_sigma),
            "solar_sigma": float(self.solar_sigma),
            "screen_tier": int(self.screen_tier),
        }


def mc_spec_from_dict(d: Dict) -> MCSpec:
    """Build + validate an :class:`MCSpec` from a request-payload dict
    (the spool/CLI/DesignSpec.risk surface).  ``samples`` is accepted as
    an alias for ``n_samples``."""
    if not isinstance(d, dict):
        raise ParameterError("mc spec: expected an object of sampler "
                             "fields")
    known = {f.name for f in dataclasses.fields(MCSpec)}
    kwargs = {}
    for k, v in d.items():
        key = "n_samples" if k == "samples" else str(k)
        if key not in known:
            raise ParameterError(f"mc spec: unknown field {k!r}")
        kwargs[key] = (tuple(v) if key == "quantiles" else v)
    return MCSpec(**kwargs).validate()


def sample_seed(seed: int, idx: int) -> int:
    """The derived RNG seed of sample ``idx``: a cryptographic digest of
    (user seed, sample index) — per-sample independence without any
    sequential RNG state, so samples can be generated in any order."""
    digest = hashlib.sha256(f"mc|{int(seed)}|{int(idx)}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


def perturb_time_series(ts, spec: MCSpec, rng: np.random.Generator):
    """One sample's perturbed time-series frame (a new frame; the base
    is never mutated).  Column classes are matched by name — the
    reference column vocabulary ("... Price ...", "... Load ...",
    "... Gen ...") — and the draw ORDER is fixed by the frame's column
    order, so a given (seed, index) always produces the same frame."""
    out = ts.copy()
    n = len(out)
    # systematic draws first (sample-level), then per-hour noise, in
    # fixed column order — the determinism contract
    price_level = float(np.exp(spec.price_sigma * rng.standard_normal()
                               - 0.5 * spec.price_sigma ** 2))
    solar_avail = float(np.clip(1.0 + spec.solar_sigma
                                * rng.standard_normal(), 0.0, 1.0))
    for col in out.columns:
        name = str(col)
        vals = out[col].to_numpy(dtype=np.float64, copy=True)
        if "Price" in name:
            shape = 1.0 + spec.price_shape_sigma * rng.standard_normal(n)
            vals = np.maximum(vals * price_level * shape, 0.0)
        elif "Load" in name:
            noise = 1.0 + spec.load_sigma * rng.standard_normal(n)
            vals = np.maximum(vals * noise, 0.0)
        elif "Gen" in name:
            vals = vals * solar_avail
        else:
            continue
        out[col] = vals
    return out


def sample_case(case: CaseParams, spec: MCSpec, idx: int,
                case_id=None) -> CaseParams:
    """Sample ``idx``'s :class:`CaseParams`: the base case with a
    perturbed ``time_series`` frame.  Mutable containers (key dicts,
    scenario/finance dicts, the Datasets holder) are copied per sample;
    every OTHER referenced frame is shared across the population."""
    ts = case.datasets.time_series if case.datasets is not None else None
    if ts is None:
        raise ParameterError(
            "monte-carlo sampling needs a time_series frame on the case")
    rng = np.random.default_rng(sample_seed(spec.seed, idx))
    new_ts = perturb_time_series(ts, spec, rng)
    # bad_sample drill: NaN-poison exactly this sample's trajectory so
    # the pre-dispatch input guards must quarantine it (sample-labeled)
    # while the rest of the batch completes
    from ..utils import faultinject
    faultinject.maybe_bad_sample(idx, new_ts)
    return dataclasses.replace(
        case,
        case_id=f"s{idx:05d}" if case_id is None else case_id,
        scenario=dict(case.scenario), finance=dict(case.finance),
        results=dict(case.results),
        streams={t: dict(v) for t, v in case.streams.items()},
        ders=[(tag, der_id, dict(keys))
              for tag, der_id, keys in case.ders],
        datasets=dataclasses.replace(case.datasets, time_series=new_ts))
