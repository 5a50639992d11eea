"""Does a batched PDHG solve on the card give an instance the same answer
wherever it sits in the batch?

Takes structure groups of the retail TOU + demand-charge deployment
(``benchmark/configs/retail_tou_dcm.json``: a fan-out's 24 cases, one
month's window LP) as ``DERVET.solve`` forms them, and solves each group
on the card (``--device``, cuda:0) with ``CompiledLPSolver`` in the
order the program gave it, again in that order, and in the reverse
order: through the chunk kernels
(the program's path on the card), and through the plain PyTorch window
on the same card (``_Solver.use_kernel`` off, as on the CPU).  Each pair
of solves is compared instance by instance: x and y bit for bit, the
iterations, the restarts and the status.  Equal bits across orders mean
no instance reads another's data; a pair that differs in the same order
means the solve is not repeatable at all.  To tell a read across
instances from rounding that depends on a row's place in memory, it also
solves the batch rolled by a few positions (``--shifts``), solves one
instance copied into every position, and compares the per-instance norms
the solve takes in PyTorch across the same rolls.

    python3 scripts/order_probe.py [--groups 0 11] [--max-iters 400000]
        [--plain-max-iters 100000] [--out Results/order_probe.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def capture_groups(device):
    """The (lp0, lps) of a fan-out's first solves, as ``DERVET.solve``
    forms its structure groups, from a screening solve of the cell's
    first fan-out with the certification off (only the LPs are kept)."""
    from benchmark import tariff
    from benchmark.drivers import fanout_pool
    from dervet_tpu_torch.api import DERVET
    from dervet_tpu_torch.io.params import CaseParams, Datasets
    from dervet_tpu_torch.ops.pdhg import PDHGOptions
    from dervet_tpu_torch.scenario import scenario as sc

    cfg = json.loads((ROOT / "benchmark/configs/retail_tou_dcm.json")
                     .read_text())
    mix = json.loads((ROOT / "benchmark/traffic/fanout_pool-24.json")
                     .read_text())
    cases = fanout_pool._cases(cfg, mix, 2 ** 31 + 11, 0)
    params = [tariff.case_params(c, i, CaseParams, Datasets)
              for i, c in enumerate(cases)]
    got, solve_group = [], sc.solve_group

    def keep(lp0, lps, *a, **kw):
        if kw.get("seeds") is None:
            got.append((lp0, list(lps)))
        return solve_group(lp0, lps, *a, **kw)

    os.environ["DERVET_TPU_CERT"] = "0"
    sc.solve_group = keep
    try:
        DERVET.from_cases(params).solve(
            backend="torch", device=device,
            solver_opts=PDHGOptions.screening(
                PDHGOptions(**cfg["solver"])))
    finally:
        sc.solve_group = solve_group
        os.environ.pop("DERVET_TPU_CERT")
    return got


def solve(lp0, arrays, order, kernel, max_iters, device):
    """One solve of the group's instances in ``order``; the results put
    back in the group's own order."""
    import torch
    from dervet_tpu_torch.ops.pdhg import (CompiledLPSolver, PDHGOptions,
                                           to_host)
    opts = PDHGOptions(cpu_rescue_after=None, max_iters=max_iters)
    sv = CompiledLPSolver(lp0, opts, device=device)
    if not kernel:
        sv._solver.use_kernel = False
    c, q, l, u = (a[order] if a.ndim == 2 else a for a in arrays)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: 0)
    sync()
    t0 = time.perf_counter()
    r = sv.solve(c=c, q=q, l=l, u=u)
    sync()
    sec = time.perf_counter() - t0
    back = np.argsort(order)
    return {"seconds": sec,
            "kernel": bool(sv._solver.use_kernel),
            "x": to_host(r.x)[back], "y": to_host(r.y)[back],
            "iters": to_host(r.iters)[back].astype(int),
            "restarts": to_host(r.restarts)[back].astype(int),
            "status": to_host(r.status)[back].astype(int)}


def compare(a, b) -> dict:
    same_x = [bool(np.array_equal(a["x"][i], b["x"][i]))
              for i in range(len(a["x"]))]
    same_y = [bool(np.array_equal(a["y"][i], b["y"][i]))
              for i in range(len(a["y"]))]
    return {"x_bit_equal": int(sum(same_x)),
            "y_bit_equal": int(sum(same_y)),
            "instances": len(same_x),
            "x_max_abs_diff": float(np.max(np.abs(a["x"] - b["x"]))),
            "iters_equal": int(np.sum(a["iters"] == b["iters"])),
            "restarts_equal": int(np.sum(a["restarts"] == b["restarts"])),
            "status_equal": int(np.sum(a["status"] == b["status"])),
            "iters_sum": [int(a["iters"].sum()), int(b["iters"].sum())],
            "seconds": [round(a["seconds"], 3), round(b["seconds"], 3)]}


def norm_bits(lp0, arrays, device, shifts) -> dict:
    """The per-instance norms the solve's context takes in PyTorch
    (``_Solver._context``: ||c * dc||, ||q * dr||, ||c||, ||q||), of the
    batch in its own order and rolled by each of ``shifts`` positions:
    how many instances' norms differ in their bits once put back."""
    import torch
    from dervet_tpu_torch.ops.pdhg import CompiledLPSolver, _norm
    sv = CompiledLPSolver(lp0, device=device)
    B = max(a.shape[0] for a in arrays if a.ndim == 2)
    c, q = (torch.as_tensor(np.broadcast_to(a, (B, a.shape[-1])).copy(),
                            device=device) for a in arrays[:2])
    rows = {"c_scaled": c * sv.dc, "q_scaled": q * sv.dr, "c": c, "q": q}
    out = {}
    for name, v in rows.items():
        base = _norm(v).cpu().numpy()
        for k in shifts:
            order = np.roll(np.arange(B), k)
            got = _norm(v[torch.as_tensor(order, device=device)]
                        ).cpu().numpy()[np.argsort(order)]
            out[f"{name}_roll{k}"] = int(np.sum(got != base))
    return out


def replicated(lp0, arrays, row, device, max_iters) -> dict:
    """One instance in every position of the batch: the positions that
    come back with the same x bits, grouped."""
    B = max(a.shape[0] for a in arrays if a.ndim == 2)
    rep = tuple(np.repeat(a[row:row + 1], B, axis=0) if a.ndim == 2 else a
                for a in arrays)
    r = solve(lp0, rep, np.arange(B), True, max_iters, device)
    classes: dict = {}
    for p in range(B):
        classes.setdefault(r["x"][p].tobytes(), []).append(p)
    return {"row": int(row), "classes": sorted(classes.values()),
            "iters": r["iters"].tolist()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", type=int, nargs="*", default=None,
                    help="ranks of the groups by window width (default: "
                         "the narrowest and the widest)")
    ap.add_argument("--max-iters", type=int, default=400_000)
    ap.add_argument("--plain-max-iters", type=int, default=100_000)
    ap.add_argument("--out", default="Results/order_probe.json")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--shifts", type=int, nargs="*", default=[1, 4],
                    help="also solve the batch rolled by these positions")
    args = ap.parse_args(argv)
    import torch
    from dervet_tpu_torch.scenario.scenario import _stack_group_data
    device = torch.device(args.device)
    got = capture_groups(device)
    # the shortest window (February) and the widest (a 31-day summer
    # month, three demand periods), unless --groups names others
    order = sorted(range(len(got)), key=lambda i: (got[i][0].n, got[i][0].m))
    pick = [order[i] for i in args.groups] if args.groups \
        else [order[0], order[-1]]
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    report = {"device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "shapes": sorted((g[0].m, g[0].n, len(g[1])) for g in got),
              "groups": []}
    for gi in pick:
        lp0, lps = got[gi]
        k_same = all((lp.K != lp0.K).nnz == 0 for lp in lps)
        arrays = _stack_group_data(lps, np.float32)
        B = len(lps)
        fwd = np.arange(B)
        orders = {"same_order": fwd, "reversed_order": fwd[::-1].copy()}
        orders.update({f"rolled_{k}": np.roll(fwd, k) for k in args.shifts})
        entry = {"m": int(lp0.m), "n": int(lp0.n), "batch": B,
                 "K_equal_across_members": bool(k_same),
                 "norm_bits_differ": norm_bits(lp0, arrays, device,
                                               args.shifts)}
        report["groups"].append(entry)
        print(f"group m={lp0.m} n={lp0.n} B={B} K equal {k_same} "
              f"norms {entry['norm_bits_differ']}", flush=True)
        for kernel, it in ((True, args.max_iters),
                           (False, args.plain_max_iters)):
            a = solve(lp0, arrays, fwd, kernel, it, device)
            name = "kernel" if kernel else "plain"
            entry[name] = {"ran_kernel": a["kernel"], "max_iters": it,
                           "iters": a["iters"].tolist(),
                           "restarts": a["restarts"].tolist()}
            for label, order in orders.items():
                entry[name][label] = compare(
                    a, solve(lp0, arrays, order, kernel, it, device))
            print(name, json.dumps({k: entry[name][k] for k in orders}),
                  flush=True)
            out.write_text(json.dumps(report, indent=1))
        slow = int(np.argmax(entry["kernel"]["iters"]))
        entry["replicated"] = replicated(lp0, arrays, slow, device,
                                         args.max_iters)
        print("replicated", json.dumps(entry["replicated"]["classes"]),
              flush=True)
        out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
