"""``python -m dervet_tpu_torch design CASE --bounds kw=LO:HI,kwh=LO:HI``.

The no-service entry point to the BOOST engine: load one model-
parameters case, generate/screen the population, certify the top-k, and
write the frontier artifacts.  Exit-code mapping matches ``solve``:
0 on success, 75 (EX_TEMPFAIL) on preemption, argparse's 2 on bad
arguments.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Tuple

from ..utils.errors import ParameterError, PreemptedError, TellUser
from .population import DERBounds, DesignSpec


def parse_bounds(text: str) -> Dict[str, Tuple[float, float]]:
    """``"kw=200:2000,kwh=500:8000"`` -> {"kw": (200, 2000), ...}."""
    out: Dict[str, Tuple[float, float]] = {}
    for part in str(text).split(","):
        part = part.strip()
        if not part:
            continue
        key, eq, rng = part.partition("=")
        lo, colon, hi = rng.partition(":")
        if not eq or not colon or key.strip().lower() not in ("kw", "kwh"):
            raise ParameterError(
                f"--bounds: cannot parse {part!r} (expected "
                "kw=LO:HI[,kwh=LO:HI])")
        out[key.strip().lower()] = (float(lo), float(hi))
    if not out:
        raise ParameterError("--bounds: no dimensions given")
    return out


def _pair(text: Optional[str], what: str) -> Optional[Tuple[float, float]]:
    if text is None:
        return None
    lo, colon, hi = str(text).partition(":")
    if not colon:
        raise ParameterError(f"{what}: expected LO:HI, got {text!r}")
    return (float(lo), float(hi))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="dervet_tpu_torch design",
        description="BOOST ordinal-optimization sizing: screen a large "
                    "candidate population cheaply, certify the top-k, "
                    "return a ranked certified frontier")
    parser.add_argument("parameters_filename",
                        help="model parameters CSV/JSON file (one case)")
    parser.add_argument("--bounds", required=True,
                        help="size bounds for the target DER, e.g. "
                             "kw=200:2000,kwh=500:8000")
    parser.add_argument("--der", default="Battery",
                        help="sized DER technology tag (default Battery)")
    parser.add_argument("--der-id", default="1")
    parser.add_argument("--population", type=int, default=512,
                        help="screened candidate count (default 512)")
    parser.add_argument("--top-k", type=int, default=8,
                        help="finalists to certify (default 8)")
    parser.add_argument("--budget", type=float, default=None,
                        help="capex cap over the sized DERs ($)")
    parser.add_argument("--duration-hours", default=None,
                        help="ESS duration box LO:HI — energy samples as "
                             "kW x hours inside it")
    parser.add_argument("--refine-rounds", type=int, default=1,
                        help="ordinal refinement re-screens (default 1)")
    parser.add_argument("--risk-samples", type=int, default=None,
                        help="enable risk-aware mode: Monte-Carlo "
                             "samples per finalist — the frontier gains "
                             "mc_mean/mc_cvar columns and a (capex, "
                             "E[value], CVaR) Pareto axis")
    parser.add_argument("--risk-seed", type=int, default=0,
                        help="risk-mode sampler seed (default 0)")
    parser.add_argument("--risk-alpha", type=float, default=0.95,
                        help="risk-mode CVaR level (default 0.95)")
    parser.add_argument("--backend", default="torch",
                        choices=["torch", "cpu"],
                        help="screening/certification dispatch backend "
                             "(default torch — a population is exactly "
                             "the batched workload the GPU path exists "
                             "for; cpu = exact HiGHS)")
    parser.add_argument("--device", default=None,
                        help="device of the torch backend (default: the "
                             "first GPU; 'cpu' runs the plain PyTorch "
                             "path on the CPU)")
    parser.add_argument("--base-path", default=None,
                        help="root for relative referenced-data paths")
    parser.add_argument("--out", default=None,
                        help="output directory for the frontier "
                             "artifacts (default: the case's results "
                             "directory)")
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser


def design_main(argv=None) -> int:
    from ..io.params import Params
    from ..utils.supervisor import EXIT_PREEMPTED, RunSupervisor
    from .frontier import run_design

    args = build_parser().parse_args(argv)
    dims = parse_bounds(args.bounds)
    spec = DesignSpec(
        bounds={(args.der, args.der_id): DERBounds(kw=dims.get("kw"),
                                                   kwh=dims.get("kwh"))},
        population=args.population, top_k=args.top_k, budget=args.budget,
        duration_hours=_pair(args.duration_hours, "--duration-hours"),
        refine_rounds=args.refine_rounds,
        risk=(None if args.risk_samples is None
              else {"samples": args.risk_samples, "seed": args.risk_seed,
                    "alpha": args.risk_alpha})).validate()
    cases = Params.initialize(args.parameters_filename,
                              base_path=args.base_path,
                              verbose=args.verbose)
    if len(cases) != 1:
        raise ParameterError(
            f"{args.parameters_filename} expands to {len(cases)} "
            "sensitivity cases — a design run sizes ONE case (drop the "
            "Sensitivity-Parameters fan-out)")
    case = cases[min(cases)]
    try:
        # same preemption contract as solve: SIGTERM mid-run exits 75 so
        # schedulers requeue instead of reporting failure
        with RunSupervisor() as sup:
            frontier = run_design(case, spec, backend=args.backend,
                                  device=args.device, supervisor=sup)
    except PreemptedError as e:
        import sys
        print(f"preempted: {e}", file=sys.stderr)
        return EXIT_PREEMPTED
    out = args.out or case.results.get("dir_absolute_path") or "Results"
    frontier.save_as_csv(out)
    w = frontier.winner
    TellUser.info(
        f"design: winner {w.get('kW', float('nan')):.0f} kW"
        + (f" / {w['kWh']:.0f} kWh" if "kWh" in w else "")
        + f", certified total {w['total']:.0f}, rank correlation "
        f"{frontier.rank_correlation}")
    return 0
