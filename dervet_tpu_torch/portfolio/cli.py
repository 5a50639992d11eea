"""``python -m dervet_tpu_torch portfolio REQUEST.json``: one-shot
coupled-portfolio
solve — parse the spool-format request payload, run the dual loop,
write the artifact set (portfolio.json + aggregate CSV).  Exit codes
match ``solve``: 0 ok, 75 preempted, 2 infeasible/failed."""
from __future__ import annotations

import argparse
import json
import sys


def portfolio_main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="dervet_tpu_torch portfolio",
        description="coupled-portfolio co-optimization: dual-decomposed "
                    "fleet solve with shared coupling constraints")
    parser.add_argument("request",
                        help="portfolio request JSON (top-level "
                             "'portfolio' object; see "
                             "portfolio.service.parse_portfolio_request)")
    parser.add_argument("--backend", default="torch",
                        choices=["torch", "cpu"],
                        help="inner solves: torch = batched PDHG on the "
                             "device, cpu = exact HiGHS")
    parser.add_argument("--device", default=None,
                        help="device of the torch backend (default: the "
                             "first GPU, and no GPU is an error; 'cpu' "
                             "runs the kernels' plain versions)")
    parser.add_argument("--base-path", default=None,
                        help="root for relative member parameter paths")
    parser.add_argument("--out", default="Results/portfolio",
                        help="output directory")
    args = parser.parse_args(argv)

    from ..utils.errors import (PortfolioInfeasibleError, PreemptedError,
                                RequestFailedError)
    from ..utils.supervisor import EXIT_PREEMPTED, RunSupervisor
    from .service import parse_portfolio_request
    from .solve import solve_portfolio

    with open(args.request) as f:
        payload = json.load(f)
    spec = parse_portfolio_request(payload, base_path=args.base_path)
    try:
        with RunSupervisor() as sup:
            result = solve_portfolio(spec, backend=args.backend,
                                     supervisor=sup, device=args.device)
    except PreemptedError as e:
        print(f"preempted: {e}", file=sys.stderr)
        return EXIT_PREEMPTED
    except PortfolioInfeasibleError as e:
        print(f"infeasible: {e}", file=sys.stderr)
        print(json.dumps(e.as_dict(), indent=2), file=sys.stderr)
        return 2
    except RequestFailedError as e:
        # a member site quarantined (or the restricted master failed):
        # the documented typed exit, not a raw traceback
        print(f"failed: {e}", file=sys.stderr)
        print(json.dumps(e.as_dict(), indent=2), file=sys.stderr)
        return 2
    result.save_as_csv(args.out)
    print(json.dumps({
        "sites": len(result.per_site),
        "converged": result.converged,
        "outer_rounds": result.outer_rounds,
        "gap_rel": result.gap_rel,
        "objective_total": result.objective_total,
        "verdict": result.certification.get("verdict"),
        "out": str(args.out),
    }))
    return 0
