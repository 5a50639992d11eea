"""``python -m dervet_tpu_torch`` console entry (mirrors reference
run_DERVET.py:73-92 and ``python -m dervet_tpu``'s solve path).

    python -m dervet_tpu_torch PARAMS.csv [--backend auto|torch|cpu]
                                          [--device cuda:0] [--out DIR]

    python -m dervet_tpu_torch design PARAMS.csv --bounds kw=LO:HI,...
    python -m dervet_tpu_torch montecarlo PARAMS.csv --samples N --seed S
    python -m dervet_tpu_torch serve SPOOL_DIR [--once] [--device cuda:0]
    python -m dervet_tpu_torch status SPOOL_DIR [SPOOL_DIR...]
    python -m dervet_tpu_torch trace RID DIR [DIR...]
    python -m dervet_tpu_torch portfolio REQUEST.json [--device cuda:0]
    python -m dervet_tpu_torch fleet FLEET_DIR [--replicas N]

``design`` runs a one-shot BOOST sizing frontier
(``design.cli.design_main``), ``montecarlo`` a one-shot Monte-Carlo
valuation (``stochastic.cli.montecarlo_main``); both take ``--backend
{torch,cpu}`` and ``--device``.  ``serve`` starts the persistent scenario
service over a file spool (``service.server.serve_main``; exit 0 after a
drain), ``status`` and ``trace`` are the ops views of its published
telemetry (``telemetry.ops``).  ``portfolio`` runs a one-shot coupled
portfolio co-optimization (``portfolio.cli.portfolio_main``), ``fleet``
N supervised serve replicas behind the fleet router, all on one device
by default (``service.lifecycle.fleet_main``)."""
from __future__ import annotations

import argparse
import sys

# subcommands of ``python -m dervet_tpu`` whose modules are not ported:
# none (``portfolio`` and ``fleet`` were the last)
UNPORTED_SUBCOMMANDS = ()


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "serve":
        # persistent scenario service over a file spool: drops in
        # SPOOL/incoming/ become requests; SIGTERM drains and exits 0
        from .service.server import serve_main
        raise SystemExit(serve_main(argv[1:]))
    if argv and argv[0] == "portfolio":
        # one-shot coupled-portfolio co-optimization: dual-decomposed
        # fleet solve against shared coupling constraints (exit 0 ok,
        # 75 preempted, 2 infeasible/failed)
        from .portfolio.cli import portfolio_main
        raise SystemExit(portfolio_main(argv[1:]))
    if argv and argv[0] == "fleet":
        # supervised multi-replica fleet: spawn N serve replicas behind
        # the router, respawn the dead ones (exit 0 on SIGTERM/SIGINT or
        # --duration-s)
        from .service.lifecycle import fleet_main
        raise SystemExit(fleet_main(argv[1:]))
    if argv and argv[0] == "status":
        # live status from the serve loops' published telemetry
        from .telemetry.ops import status_main
        raise SystemExit(status_main(argv[1:]))
    if argv and argv[0] == "trace":
        # one request's stitched span tree (journals when no export)
        from .telemetry.ops import trace_main
        raise SystemExit(trace_main(argv[1:]))
    if argv and argv[0] == "design":
        # one-shot BOOST sizing: screen a candidate population, certify
        # the top-k, write the ranked frontier — exit codes match solve
        # (0 ok, 75 preempted)
        from .design.cli import design_main
        raise SystemExit(design_main(argv[1:]))
    if argv and argv[0] == "montecarlo":
        # one-shot Monte-Carlo valuation: seeded sample mass at the
        # screening tier, quantile-pinning samples certified, CVaR +
        # quantile distribution artifacts (exit 0 ok, 75 preempted)
        from .stochastic.cli import montecarlo_main
        raise SystemExit(montecarlo_main(argv[1:]))

    from .api import DERVET

    parser = argparse.ArgumentParser(
        prog="dervet_tpu_torch",
        description="GPU DER valuation: dispatch optimization, sizing, "
                    "reliability, and cost-benefit analysis")
    parser.add_argument("parameters_filename",
                        help="model parameters CSV/JSON file")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("--backend", default="auto",
                        choices=["auto", "torch", "cpu"],
                        help="dispatch solver backend (auto = torch for "
                             "large dispatches, cpu below the measured "
                             "crossover; torch = batched PDHG on the GPU; "
                             "cpu = scipy HiGHS cross-validation path)")
    parser.add_argument("--device", default=None,
                        help="device of the torch backend and of "
                             "Reliability's outage walks (default: the "
                             "first GPU; 'cpu' runs the plain PyTorch "
                             "path on the CPU)")
    parser.add_argument("--base-path", default=None,
                        help="root for relative referenced-data paths "
                             "(default: the parameters file's directory)")
    parser.add_argument("--out", default=None,
                        help="override results output directory")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="directory for per-window solve checkpoints "
                             "(resume an interrupted run from here)")
    # reference-CLI compatibility (run_DERVET.py:53-54): the reference
    # prompts for input unless --gitlab-ci is given; this CLI never
    # prompts, so the flag is accepted as a no-op
    parser.add_argument("--gitlab-ci", action="store_true",
                        help="accepted for reference-CLI compatibility "
                             "(this CLI is always non-interactive)")
    args = parser.parse_args(argv)

    from .utils.errors import PreemptedError
    from .utils.supervisor import EXIT_PREEMPTED

    case = DERVET(args.parameters_filename, verbose=args.verbose,
                  base_path=args.base_path)
    try:
        results = case.solve(backend=args.backend,
                             checkpoint_dir=args.checkpoint_dir,
                             device=args.device)
    except PreemptedError as e:
        # distinct exit code (75, EX_TEMPFAIL) so job schedulers can tell
        # "requeue me" from a real failure; checkpoints + run_manifest.json
        # were already flushed by the supervisor before this propagated
        print(f"preempted: {e}", file=sys.stderr)
        raise SystemExit(EXIT_PREEMPTED)
    results.save_as_csv(args.out)
    return results


if __name__ == "__main__":
    main()
