"""One month's window of a synthetic fan-out, solved by both PDHG solvers.

Builds the window LP of month ``--month`` for the chosen cases of
``synthetic_sensitivity_cases(--cases-of, retail=..., multi_der=...,
reliability=...)`` once through ``dervet_tpu`` (JAX) and once through
``dervet_tpu_torch`` (the port), checks that the two LPs are byte-equal,
and solves the batch with each package's ``CompiledLPSolver`` on the CPU,
both with ``cpu_rescue_after=None`` (no HiGHS inside the solve).  Prints
per instance the iterations, convergence, status and objective of each
side, and one JSON line at the end.

``--kind northstar`` takes the month's window of ``bench.py``'s ICE + CHP
sweep instead (``build_window_lps(synthetic_case(multi_der=True))``) and
solves ``--scenarios`` lognormal price draws of it
(``scenario_price_batch``, ``--seed``; the same bytes in both packages).
``--certify`` adds each answer's float64 certificate verdict and the row
group it grades worst (each package's own ``certify_solution``, with the
duals).

    python scripts/compare_pdhg_tail.py --kind retail --month 2 --cases 0 1
    python scripts/compare_pdhg_tail.py --cases 54 --sides torch \
        --opt variant=halpern          # one side, other solver options
    python scripts/compare_pdhg_tail.py --kind northstar --month 9 \
        --scenarios 4 --max-iters 65536 --certify

Demand-charge windows take tens of thousands of iterations; on two CPU
threads a monthly one runs at a few milliseconds an iteration.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np

KINDS = {"retail": dict(retail=True),
         "microgrid": dict(multi_der=True, reliability=True),
         "northstar": dict(multi_der=True)}


def _jax_case(case):
    from dervet_tpu.io import params as jax_params
    case = copy.deepcopy(case)
    fields = {f.name: getattr(case, f.name)
              for f in dataclasses.fields(case)}
    fields["datasets"] = jax_params.Datasets(**vars(case.datasets))
    return jax_params.CaseParams(**fields)


def _window(scen, month):
    scen.prepare_dispatch("cpu")
    return scen.build_window_lp(scen.windows[month - 1],
                                scen._annuity_scalar, scen._requirements)


def _sweep_window(benchlib, month):
    """Month ``month``'s LP of the ICE + CHP sweep, from its length group."""
    scen, groups = benchlib.build_window_lps(
        benchlib.synthetic_case(**KINDS["northstar"]))
    lens = [ctx.T for ctx in scen.windows]
    T = lens[month - 1]
    return groups[T][lens[:month - 1].count(T)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kind", choices=sorted(KINDS), default="retail")
    ap.add_argument("--month", type=int, default=2)
    ap.add_argument("--cases", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--cases-of", type=int, default=64,
                    help="size of the fan-out the cases are taken from")
    ap.add_argument("--max-iters", type=int, default=400_000)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--scenarios", type=int, default=4,
                    help="northstar: price draws of the window")
    ap.add_argument("--seed", type=int, default=23,
                    help="northstar: the price draws' seed")
    ap.add_argument("--certify", action="store_true",
                    help="grade each answer with the float64 certificate")
    ap.add_argument("--sides", nargs="+", choices=("jax", "torch"),
                    default=["jax", "torch"])
    ap.add_argument("--opt", nargs="*", default=[], metavar="KEY=VALUE",
                    help="further PDHGOptions fields, for both sides "
                         "(numbers and strings)")
    args = ap.parse_args()
    extra = {}
    for kv in args.opt:
        k, v = kv.split("=", 1)
        try:
            extra[k] = float(v) if "." in v or "e" in v else int(v)
        except ValueError:
            extra[k] = v

    import jax
    jax.config.update("jax_platforms", "cpu")
    import torch
    torch.set_num_threads(args.threads)
    from dervet_tpu import benchlib as jax_benchlib
    from dervet_tpu.ops import certify as jax_certify
    from dervet_tpu.ops import pdhg as jax_pdhg
    from dervet_tpu.scenario.scenario import MicrogridScenario as JaxScen
    from dervet_tpu_torch import benchlib
    from dervet_tpu_torch.ops import certify, pdhg
    from dervet_tpu_torch.scenario.scenario import MicrogridScenario

    if args.kind == "northstar":
        # one window, its price scenarios in place of the cases
        args.cases = list(range(args.scenarios))
        a, b = (_sweep_window(m, args.month)
                for m in (benchlib, jax_benchlib))
        C = benchlib.scenario_price_batch(a, args.scenarios, args.seed)
        ours = [dataclasses.replace(a, c=c) for c in C]
        ref = [dataclasses.replace(b, c=c) for c in C]
    else:
        fan = benchlib.synthetic_sensitivity_cases(args.cases_of,
                                                   **KINDS[args.kind])
        ours, ref = [], []
        for i in args.cases:
            ours.append(_window(MicrogridScenario(copy.deepcopy(fan[i])),
                                args.month))
            ref.append(_window(JaxScen(_jax_case(fan[i])), args.month))
    for a, b in zip(ours, ref):
        for part in ("data", "indices", "indptr"):
            assert getattr(a.K, part).tobytes() == \
                getattr(b.K, part).tobytes(), part
        for v in ("c", "q", "l", "u"):
            assert getattr(a, v).tobytes() == getattr(b, v).tobytes(), v
    lp = ours[0]
    batch = {v: np.stack([getattr(w, v) for w in ours])
             for v in ("c", "q", "l", "u")}
    print(f"{args.kind} month {args.month}: m={lp.m} n={lp.n} "
          f"cases {args.cases} (LPs byte-equal)", flush=True)

    out = {}
    for name, mod, cert, kw in (
            ("jax", jax_pdhg, jax_certify, {}),
            ("torch", pdhg, certify, {"device": "cpu"})):
        if name not in args.sides:
            continue
        opts = mod.PDHGOptions(cpu_rescue_after=None,
                               max_iters=args.max_iters, **extra)
        t0 = time.perf_counter()
        solver = mod.CompiledLPSolver(lp, opts, **kw)
        res = solver.solve(**batch)
        secs = time.perf_counter() - t0
        op = type(solver.op).__name__
        f = {k: np.asarray(getattr(res, k)).tolist()
             for k in ("iters", "converged", "status", "obj")}
        if args.certify:
            certs = [cert.certify_solution(
                w, np.asarray(res.x[j]), float(res.obj[j]),
                y=np.asarray(res.y[j])) for j, w in enumerate(ours)]
            f["verdict"] = [c.verdict for c in certs]
            f["worst_group"] = [c.worst_group for c in certs]
            f["worst_rel"] = [c.rel_viol[c.worst_class] for c in certs]
        out[name] = dict(op=op, seconds=round(secs, 1), **f)
        for j, i in enumerate(args.cases):
            print(f"  {name:5s} case {i}: iters {f['iters'][j]} converged "
                  f"{f['converged'][j]} status {f['status'][j]} obj "
                  f"{f['obj'][j]!r}"
                  + (f" certificate {f['verdict'][j]} (worst "
                     f"{f['worst_group'][j]} {f['worst_rel'][j]:.2e})"
                     if args.certify else ""), flush=True)
        print(f"  {name}: {op}, {secs:.1f} s", flush=True)
    if len(out) == 2:
        out["obj_rel_diff"] = [abs(a - b) / (1 + abs(b)) for a, b in
                               zip(out["torch"]["obj"], out["jax"]["obj"])]
    print(json.dumps({"kind": args.kind, "month": args.month,
                      "cases": args.cases, "m": lp.m, "n": lp.n,
                      "options": extra, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
