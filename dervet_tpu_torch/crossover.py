"""Where the card overtakes the exact CPU solver, for ``backend="auto"``.

Run from the repository root on a machine with a GPU:

    python -m dervet_tpu_torch.crossover [--reps 2]

Times ``DERVET.from_cases(cases).solve(backend=...)`` with ``"torch"``
(PDHG on the card) and ``"cpu"`` (exact HiGHS) on fan-outs of the
synthetic Battery+PV+DA case with daily-cycle rows: one case of 1, 3 and
12 monthly windows, then 2 to 32 cases of 12.  Both backends run in one
process, alternating, after one warm-up solve on the card that pays for
the CUDA context and the kernel build; each size keeps the fastest of
``--reps`` walls per backend.  Prints one JSON line per size, then a
summary line with ``torch_from_windows``: the fewest windows from which
the card was faster at that size and every larger one measured (null
when it never was).  ``api.DERVET.AUTO_TORCH_MIN_WINDOWS`` is set from it.
"""
from __future__ import annotations

import argparse
import json
import logging
import time

# (cases, months): windows = cases x months
SIZES = ((1, 1), (1, 3), (1, 12), (2, 12), (4, 12), (8, 12), (16, 12),
         (32, 12))


def solve_wall(n_cases: int, months: int, backend: str) -> float:
    from . import benchlib
    from .api import DERVET
    cases = benchlib.synthetic_sensitivity_cases(
        n_cases, months=months if months < 12 else 0, daily_cycle_limit=1)
    t0 = time.perf_counter()
    res = DERVET.from_cases(cases).solve(backend=backend)
    wall = time.perf_counter() - t0
    cert = res.run_health["certification"]["windows"]
    n = n_cases * months
    if cert["certified"] + cert["certified_loose"] != n:
        raise AssertionError(f"{backend} {n_cases}x{months}: {cert}")
    return wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("crossover: no CUDA device is visible")
    logging.getLogger().setLevel(logging.WARNING)
    solve_wall(1, 1, "torch")                       # CUDA init + build
    rows = []
    for n_cases, months in SIZES:
        walls = {"torch": [], "cpu": []}
        for _ in range(args.reps):
            for backend in ("torch", "cpu"):
                walls[backend].append(solve_wall(n_cases, months, backend))
        row = {"cases": n_cases, "months": months,
               "windows": n_cases * months,
               "torch_s": min(walls["torch"]), "cpu_s": min(walls["cpu"]),
               "torch_all_s": walls["torch"], "cpu_all_s": walls["cpu"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    from_windows = None
    for row in reversed(rows):
        if row["torch_s"] >= row["cpu_s"]:
            break
        from_windows = row["windows"]
    print(json.dumps({"torch_from_windows": from_windows,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
