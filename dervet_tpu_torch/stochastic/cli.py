"""``python -m dervet_tpu_torch montecarlo CASE --samples N --seed S``.

The no-service entry point to the Monte-Carlo valuation engine: load
one model-parameters case, draw the seeded sample set, solve the whole
mass at the screening tier plus the quantile-pinning samples at the
certified tier, and write the distribution artifacts
(``mc_distribution.json`` / ``mc_samples.csv``).  Exit-code mapping
matches ``solve``: 0 on success, 75 (EX_TEMPFAIL) on preemption,
argparse's 2 on bad arguments.
"""
from __future__ import annotations

import argparse
from typing import Optional, Tuple

from ..utils.errors import ParameterError, PreemptedError, TellUser
from .sampler import MCSpec


def _quantiles(text: Optional[str]) -> Optional[Tuple[float, ...]]:
    if text is None:
        return None
    try:
        vals = tuple(float(p) for p in str(text).split(",") if p.strip())
    except ValueError:
        raise ParameterError(
            f"--quantiles: expected comma-separated fractions, got "
            f"{text!r}")
    if not vals:
        raise ParameterError("--quantiles: no values given")
    return vals


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="dervet_tpu_torch montecarlo",
        description="Batched Monte-Carlo valuation under price/load/"
                    "solar uncertainty: solve the whole sample mass at "
                    "the screening tier, re-solve the quantile-pinning "
                    "samples certified, report quantiles and CVaR")
    parser.add_argument("parameters_filename",
                        help="model parameters CSV/JSON file (one case)")
    parser.add_argument("--samples", type=int, default=1024,
                        help="Monte-Carlo sample count (default 1024)")
    parser.add_argument("--seed", type=int, default=0,
                        help="sampler seed — the whole sample set is a "
                             "pure function of it (default 0)")
    parser.add_argument("--alpha", type=float, default=0.95,
                        help="CVaR confidence level (default 0.95)")
    parser.add_argument("--quantiles", default=None,
                        help="comma-separated quantile fractions "
                             "(default 0.05,0.25,0.5,0.75,0.95)")
    parser.add_argument("--price-sigma", type=float, default=None,
                        help="lognormal price LEVEL shock sigma "
                             "(default 0.10)")
    parser.add_argument("--price-shape-sigma", type=float, default=None,
                        help="per-step price SHAPE noise sigma "
                             "(default 0.02)")
    parser.add_argument("--load-sigma", type=float, default=None,
                        help="per-step load noise sigma (default 0.05)")
    parser.add_argument("--solar-sigma", type=float, default=None,
                        help="solar availability draw sigma "
                             "(default 0.10)")
    parser.add_argument("--screen-tier", type=int, default=0,
                        help="screening-ladder tier for the sample mass "
                             "(default 0 — loosest/fastest)")
    parser.add_argument("--screening-only", action="store_true",
                        help="skip the certified quantile-pinning tier "
                             "(the result is marked degraded, never "
                             "cert-stamped)")
    parser.add_argument("--backend", default="torch",
                        choices=["torch", "cpu"],
                        help="dispatch backend (default torch — a "
                             "sample mass is exactly the batched workload "
                             "the GPU path exists for; cpu = exact "
                             "HiGHS)")
    parser.add_argument("--device", default=None,
                        help="device of the torch backend (default: the "
                             "first GPU; 'cpu' runs the plain PyTorch "
                             "path on the CPU)")
    parser.add_argument("--base-path", default=None,
                        help="root for relative referenced-data paths")
    parser.add_argument("--out", default=None,
                        help="output directory for the distribution "
                             "artifacts (default: the case's results "
                             "directory)")
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser


def montecarlo_main(argv=None) -> int:
    from ..io.params import Params
    from ..utils.supervisor import EXIT_PREEMPTED, RunSupervisor
    from .engine import run_montecarlo

    args = build_parser().parse_args(argv)
    kwargs = dict(n_samples=args.samples, seed=args.seed,
                  alpha=args.alpha, screen_tier=args.screen_tier)
    q = _quantiles(args.quantiles)
    if q is not None:
        kwargs["quantiles"] = q
    for field, val in (("price_sigma", args.price_sigma),
                       ("price_shape_sigma", args.price_shape_sigma),
                       ("load_sigma", args.load_sigma),
                       ("solar_sigma", args.solar_sigma)):
        if val is not None:
            kwargs[field] = val
    spec = MCSpec(**kwargs).validate()
    cases = Params.initialize(args.parameters_filename,
                              base_path=args.base_path,
                              verbose=args.verbose)
    if len(cases) != 1:
        raise ParameterError(
            f"{args.parameters_filename} expands to {len(cases)} "
            "sensitivity cases — an MC run values ONE case (drop the "
            "Sensitivity-Parameters fan-out)")
    case = cases[min(cases)]
    try:
        # same preemption contract as solve: SIGTERM mid-run exits 75 so
        # schedulers requeue instead of reporting failure (the fixed
        # seed replays the identical sample set on resubmission)
        with RunSupervisor() as sup:
            res = run_montecarlo(
                case, spec, backend=args.backend, device=args.device,
                supervisor=sup,
                certify_tier=not args.screening_only)
    except PreemptedError as e:
        import sys
        print(f"preempted: {e}", file=sys.stderr)
        return EXIT_PREEMPTED
    out = args.out or case.results.get("dir_absolute_path") or "Results"
    res.save_as_csv(out)
    s = res.stats
    TellUser.info(
        f"montecarlo: {s['n']} samples, mean {s['mean']:.2f}, "
        f"p50 {s['quantiles'].get('p50', float('nan')):.2f}, "
        f"CVaR{s['alpha']:g} {s['cvar_alpha']:.2f} "
        f"({res.tier_mix['certified']} certified, "
        f"{res.tier_mix['quarantined']} quarantined, "
        f"fidelity {res.fidelity})")
    return 0
