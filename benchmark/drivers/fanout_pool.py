"""The pool-spanning fan-out (traffic kind ``fanout_pool``): DER-VET's
product entry valuing N cases at once,
``DERVET.from_cases(cases).solve(backend="torch")``, fan-outs back to
back, as ``fanout`` runs them, and at least the mix's ``min_fanouts``
whole ones a window however long they take; here each fan-out spans
every series of the mix's pool (see :func:`_cases`), so every seed
solves the same LPs, in another order.  The configuration's ``tariff`` reaches the program as
the cases' ``Datasets.tariff`` (``benchmark/tariff.py``).

Each fan-out keeps :data:`PICKS` (case, window) answers a window, the
cases drawn from (seed, k): the dispatch, the reported objective and the
program's bill for the window's month.  The check after the window takes
``check_windows`` of them, as many from each window as it can (see
:func:`_chosen`), so every window LP of the year, and so every structure
group, is judged.  Beside the window's optimum, the reference bills each
judged dispatch itself (``reference/billing.py``) and holds the
program's energy and demand charges for that month to it: an answer
whose ``bill_gap`` passes :data:`BILL_GAP` is rejected, as one past a
limit of the cell's is.

Each fan-out also keeps the instances its solves left at the iteration
limit (the ledger's ``at_limit``, summed over the groups' first solves),
and the traced fan-out the work its solves needed (``roofline.solve_work``
from each group's LP and iterations, the escalation ladder's device rungs
included) and the device time of the solver's kernels, for
``pdhg_roofline``.  A program whose ledger lacks those counters leaves
them out.

The warm-up is one call of three cases, one a series outside the pool
(:func:`_warm_cases`), at ``PDHGOptions.screening`` with the
certification off: it warms the process (imports, the kernels' build,
the device) and nothing more, for every call builds its own solvers.
"""
from __future__ import annotations

import gc
import os
import time

import numpy as np

from .. import roofline, series, tariff, trace
from ..reference import lp as ref
from ..reference import billing
from .fanout import _answers

# answers a fan-out keeps of each window, each of another case
PICKS = 2
# the most a judged answer's bill may differ from the reference's bill of
# the same dispatch, over max(|bill|, 1): both sum the same float64
# numbers (sound runs read 1.5e-16 to 3.1e-16), a float32 bill of a
# site's month misses by 4e-9 to 9e-8
BILL_GAP = 1e-10
# the solver's own kernels: the chunk kernels, the check and status kernels
KERNELS = ("chunk_kernel", "check_window_kernel", "window_status_kernel")


def _cases(cfg, mix, seed, k):
    """Fan-out k's cases: the mix's sweep on each series of the pool, as
    many sizes a series as ``cases`` over the pool asks (the last series
    cut short where it does not divide), in an order drawn from (seed,
    k)."""
    pool, n = int(mix["series_pool"]), int(mix["cases"])
    per = -(-n // pool)
    cases = []
    for s in range(pool):
        base = tariff.case_dict(cfg, int(cfg["series_seed"]) + 1 + s)
        cases += series.sensitivity(base, mix["sweep"], per)
    cases = cases[:n]
    perm = np.random.default_rng(series.stream_seed(seed, k)).permutation(n)
    return [cases[i] for i in perm]


def _warm_cases(cfg, mix):
    """The warm-up's cases: one a series, at the configured ratings, on
    as many series outside the pool as the pool holds."""
    pool = int(mix["series_pool"])
    return [tariff.case_dict(cfg, int(cfg["series_seed"]) + 1 + s)
            for s in range(pool, 2 * pool)]


def _device_solves(res):
    """The ledger entries of the groups' solves on the card: first
    solves and the ladder's retry rungs (not its CPU fallback)."""
    led = getattr(res, "solve_ledger", None) or {}
    return [g for g in led.get("groups", ()) if g.get("backend") != "cpu"]


def _first_solves(groups):
    """Of :func:`_device_solves`, the groups' first solves."""
    return [g for g in groups if g.get("rung", "initial") == "initial"]


def _limit_exits(groups):
    if not groups or any("at_limit" not in g for g in groups):
        return None
    return sum(int(g["at_limit"]) for g in groups)


def _work(groups):
    """(operations, bytes) the solves ``groups`` needed, or None where the
    ledger lacks the LPs' non-zeros or the iterations."""
    need = ("m", "n", "nnz", "iters_sum", "batch")
    if not groups or any(k not in g for g in groups for k in need):
        return None
    ops = nbytes = 0.0
    for g in groups:
        b = int(g["batch"])
        o, nb = roofline.solve_work(np.full(b, g["iters_sum"] / b), g["m"],
                                    g["n"], g["nnz"])
        ops, nbytes = ops + o, nbytes + nb
    return ops, nbytes


class KernelSlice(trace.Slice):
    """``trace.Slice`` that also keeps ``kernel_s``: the device time the
    solver's kernels (:data:`KERNELS`) covered, overlaps counted once."""

    def _read(self):
        out = super()._read()
        if out is None:
            return None
        from torch.autograd import DeviceType
        iv = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA or not any(
                    k in ev.name() for k in KERNELS):
                continue
            try:
                s, d = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
            except AttributeError:
                s, d = ev.start_us() * 1e-6, ev.duration_us() * 1e-6
            iv.append((s, s + d))
        busy = trace.union(np.asarray(iv, float).reshape(-1, 2))
        out["kernel_s"] = float((busy[:, 1] - busy[:, 0]).sum())
        return out


def _bills(res, cases, picks):
    """(case, window) -> the program's (energy, demand) charges ($) for
    the window's month, from the case's ``simple_monthly_bill``."""
    out = {}
    for i, w in picks:
        inst = res.instances.get(i)
        if inst is None:
            continue
        start, _ = ref.windows(cases[i])[w]
        month = str(cases[i]["time_series"].index[start].to_period("M"))
        row = inst.drill_down_dict["simple_monthly_bill"].loc[month]
        out[(i, w)] = (float(row["Energy Charge ($)"]),
                       float(row["Demand Charge ($)"]))
    return out


def _chosen(keys, budget, rng):
    """``budget`` of the answers ``keys`` ((k, case, window)), taken a
    window at a time in turn, each window's in an order drawn from
    ``rng``, so each window is judged as often as its answers allow."""
    by_w: dict = {}
    for key in sorted(keys):
        by_w.setdefault(key[2], []).append(key)
    queues = [[ks[j] for j in rng.permutation(len(ks))]
              for _, ks in sorted(by_w.items())]
    chosen = []
    while len(chosen) < budget and any(queues):
        for q in queues:
            if q and len(chosen) < budget:
                chosen.append(q.pop())
    return sorted(chosen)


def run(cell, rec) -> dict:
    from dervet_tpu_torch.api import DERVET
    from dervet_tpu_torch.io.params import CaseParams, Datasets
    from dervet_tpu_torch.ops.pdhg import PDHGOptions
    cfg, mix, args = cell.config, cell.traffic, rec.args
    opts = PDHGOptions(**cfg["solver"])
    if rec.control == "screening":
        opts = PDHGOptions.screening(opts)
        os.environ["DERVET_TPU_CERT"] = "0"
    n_cases = int(mix["cases"])
    n_windows = len(ref.windows(series.case_dict(cfg, 0)))
    # whole fan-outs a window holds at least: the mix's, and in a traced
    # run one unprofiled before the profiled one
    min_fanouts = max(int(mix.get("min_fanouts", 1)), 2 if rec.trace else 1)

    def fanout(cases, traced, solver_opts=opts):
        params = [tariff.case_params(c, i, CaseParams, Datasets)
                  for i, c in enumerate(cases)]
        t0 = time.perf_counter()
        with trace.span("DERVET.solve", traced):
            res = DERVET.from_cases(params).solve(
                backend="torch", solver_opts=solver_opts, device=rec.device)
        t1 = time.perf_counter()
        return cases, res, t0, t1

    # warms the process: imports, the kernels' build, the device
    cert = os.environ.get("DERVET_TPU_CERT")
    os.environ["DERVET_TPU_CERT"] = "0"
    try:
        fanout(_warm_cases(cfg, mix), False, PDHGOptions.screening(opts))
    finally:
        if cert is None:
            os.environ.pop("DERVET_TPU_CERT")
        else:
            os.environ["DERVET_TPU_CERT"] = cert
    gc.collect()
    data = rec.start_window()
    fanouts, answers, bills = [], {}, {}
    k = 0
    while True:
        traced = rec.trace and k == 1
        if traced:
            with KernelSlice() as slicer:
                cases, res, t0, t1 = fanout(_cases(cfg, mix, args.seed, k),
                                            True)
            data["trace"] = slicer.result
        else:
            cases, res, t0, t1 = fanout(_cases(cfg, mix, args.seed, k),
                                        False)
        health = res.run_health
        win = health["windows"]
        objs = [inst.objective_values["Total Objective"]
                for inst in res.instances.values()]
        missing = n_cases - sum(int(len(o) == n_windows and o.notna().all())
                                for o in objs)
        rng = np.random.default_rng(series.stream_seed(args.seed, k, 7))
        picks = {(int(i), w) for w in range(n_windows)
                 for i in rng.choice(n_cases, min(PICKS, n_cases),
                                     replace=False)}
        for key, val in _answers(res, cases, picks).items():
            answers[(k,) + key] = val
        for key, val in _bills(res, cases, picks).items():
            bills[(k,) + key] = val
        groups = _device_solves(res)
        first = _first_solves(groups)
        if traced and _work(groups) is not None:
            data["solve_work"] = _work(groups)
        fanouts.append({"t0": t0, "t1": t1, "cases": n_cases,
                        "profiled": traced,
                        "phase_seconds": dict(res.phase_seconds),
                        "limit_exits": _limit_exits(first),
                        "failed": missing + health["certification"][
                            "windows"]["rejected_final"],
                        "cpu_fallback": win["cpu_fallback"],
                        "retried": win["retried"]})
        # the next fan-out starts on a collected heap, as each would in
        # a process of its own
        del res
        gc.collect()
        k += 1
        if t1 - data["t_window"] >= args.seconds and k >= min_fanouts:
            break
    rec.close_window()
    data["fanouts"] = fanouts
    numbers, rejected, checked = _check(cfg, mix, args.seed, answers, bills,
                                        cell.limits, int(mix["check_windows"]))
    failed = sum(f["failed"] for f in fanouts) + rejected
    return {"data": data, "numbers": numbers,
            "attempted": n_cases * len(fanouts), "failed": failed,
            "notes": {"fanouts": len(fanouts), "checked": len(checked),
                      "rejected": rejected,
                      "program_failed": failed - rejected,
                      "walls_s": [round(f["t1"] - f["t0"], 3)
                                  for f in fanouts],
                      "batches": sorted(int(g["batch"]) for g in first),
                      "kernels": sorted({str(g.get("kernel"))
                                         for g in first}),
                      "limit_exits": [f["limit_exits"] for f in fanouts],
                      "retried": sum(f["retried"] for f in fanouts),
                      "cpu_fallback": sum(f["cpu_fallback"]
                                          for f in fanouts),
                      "checked_windows": sorted({w for _, _, w in checked}),
                      "obj_gap": numbers["obj_gap"],
                      "prim_viol": numbers["prim_viol"],
                      "bill_gap": numbers["bill_gap"]}}


def _check(cfg, mix, seed, answers, bills, limits, budget):
    """``fanout``'s check over :func:`_chosen`'s answers; a stream part
    with ``complete`` (DCM's peaks) adds to each answer the variables its
    dispatch implies.  ``bill_gap``: the program's energy and demand
    charges for the window's month against the reference's bill of the
    same dispatch, the larger difference over max(|bill|, 1)."""
    rng = np.random.default_rng(series.stream_seed(seed, 1 << 21))
    chosen = _chosen(answers, budget, rng)
    worst = {"obj_gap": 0.0, "prim_viol": 0.0, "bill_gap": 0.0}
    rejected = 0
    cache: dict = {}
    for k, i, w in chosen:
        if k not in cache:
            cache = {k: _cases(cfg, mix, seed, k)}
        case = cache[k][i]
        req = ref.horizon_requirements(case)
        start, T = ref.windows(case)[w]
        rl = ref.build(case, start, T, req)
        best, _ = ref.solve(rl)
        named, obj = answers[(k, i, w)]
        named = dict(named)
        for tag in case["streams"]:
            fn = getattr(ref.part(tag), "complete", None)
            if fn is not None:
                fn(rl, named)
        nums = ref.judge(rl, rl.vector(named), best, reported=obj)
        nums["bill_gap"] = _bill_gap(case, start, rl, named,
                                     bills.get((k, i, w)))
        if any(nums[n] > limits[n] for n in limits) \
                or nums["bill_gap"] > BILL_GAP:
            rejected += 1
        for n in worst:
            worst[n] = max(worst[n], nums[n])
    return worst, rejected, chosen


def _bill_gap(case, start, rl, named, program) -> float:
    """How far the program's (energy, demand) charges for the window's
    month lie from the reference's bill of the dispatch ``named``; inf
    where the program gave no bill."""
    if program is None:
        return float("inf")
    ts = case["time_series"].iloc[start:start + rl.T]
    load = (ts["Site Load (kW)"].to_numpy(float)
            if case["scenario"].get("incl_site_load") else np.zeros(rl.T))
    energy, demand = billing.bill(case["tariff"], ts.index, load - sum(
        sign * np.asarray(named[name], float)
        for name, sign in rl.power.items()), rl.dt)
    return max(abs(program[0] - energy), abs(program[1] - demand)) / max(
        abs(energy) + abs(demand), 1.0)
