"""The sensitivity fan-out (traffic kind ``fanout``): DER-VET's product
entry valuing N cases of one deployment at once,
``DERVET.from_cases(cases).solve(backend="torch")``, fan-outs back to
back.

Fan-out k (k = 0, 1, ... in the window; one more before it, at set-up,
warms the process) sweeps one DER key over its cases as the mix says, on
one series of the mix's pool (see :func:`_cases`).  Each fan-out keeps,
for the check after the window, a few (case, window) answers drawn from
the seed: the dispatch the case's results hold for that window and its
reported objective.  The reference rebuilds those windows from the
cases' inputs and judges them.
"""
from __future__ import annotations

import gc
import os
import time

import numpy as np

from .. import series, trace
from ..reference import lp as ref

PER_FANOUT = 4


def _cases(cfg, mix, seed, k):
    """Fan-out k's cases: the sensitivity sweep over one series of the
    mix's pool, the pool visited in an order drawn from the seed, and the
    cases in an order drawn from (seed, k); so every seed runs the same
    work in another order.  The warm-up (k < 0) takes a series of its
    own."""
    pool = int(mix["series_pool"])
    order = np.random.default_rng(series.stream_seed(seed, 1 << 22)
                                  ).permutation(pool)
    which = pool if k < 0 else int(order[k % pool])
    base = series.case_dict(cfg, int(cfg["series_seed"]) + 1 + which)
    cases = series.sensitivity(base, mix["sweep"], int(mix["cases"]))
    perm = np.random.default_rng(series.stream_seed(seed, k)).permutation(
        len(cases))
    return [cases[i] for i in perm]


def _answers(res, cases, picks):
    """(case, window) -> the program's dispatch by variable and its
    reported objective, read from the case's results."""
    out = {}
    for i, w in picks:
        inst = res.instances.get(i)
        if inst is None:
            continue
        case = cases[i]
        start, T = ref.windows(case)[w]
        ts = inst.time_series_data.iloc[start:start + T]
        named = {}
        for tag, der_id, keys in case["ders"]:
            part = ref.part(tag)
            for short, col in part.RESULTS.items():
                named[f"{tag}-{der_id}/{short}"] = ts[
                    f"{tag.upper()}: {keys['name']} {col}"].to_numpy(float)
        obj = inst.objective_values["Total Objective"].iloc[w]
        out[(i, w)] = (named, float(obj))
    return out


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

    def fanout(k, traced):
        cases = _cases(cfg, mix, args.seed, k)
        params = [series.case_params(c, i, CaseParams, Datasets)
                  for i, c in enumerate(cases)]
        t0 = time.perf_counter()
        with trace.span("DERVET.solve", traced):
            res = DERVET.from_cases(params).solve(
                backend="torch", solver_opts=opts, device=rec.device)
        t1 = time.perf_counter()
        return cases, res, t0, t1

    fanout(-1, False)                      # warms the process
    data = rec.start_window()
    fanouts, answers = [], {}
    k = 0
    while True:
        traced = rec.trace and k == 1
        if traced:
            with trace.Slice() as slicer:
                cases, res, t0, t1 = fanout(k, True)
            data["trace"] = slicer.result
        else:
            cases, res, t0, t1 = fanout(k, False)
        health = res.run_health
        win = health["windows"]
        objs = [inst.objective_values["Total Objective"]
                for inst in res.instances.values()]
        missing = n_cases - sum(int(len(o) == n_windows and o.notna().all())
                                for o in objs)
        rng = np.random.default_rng(series.stream_seed(args.seed, k, 7))
        picks = {(int(rng.integers(n_cases)), int(rng.integers(n_windows)))
                 for _ in range(PER_FANOUT)}
        for key, val in _answers(res, cases, picks).items():
            answers[(k,) + key] = val
        fanouts.append({"t0": t0, "t1": t1, "cases": n_cases,
                        "profiled": traced,
                        "phase_seconds": dict(res.phase_seconds),
                        "failed": missing + health["certification"][
                            "windows"]["rejected_final"],
                        "cpu_fallback": win["cpu_fallback"],
                        "retried": win["retried"]})
        # the next fan-out starts on a collected heap, as each would in
        # a process of its own
        del res
        gc.collect()
        k += 1
        if t1 - data["t_window"] >= args.seconds and (not rec.trace or k > 1):
            break
    rec.close_window()
    data["fanouts"] = fanouts
    numbers, rejected, checked = _check(cfg, mix, args.seed, answers,
                                        cell.limits, int(mix["check_windows"]))
    failed = sum(f["failed"] for f in fanouts) + rejected
    return {"data": data, "numbers": numbers,
            "attempted": n_cases * len(fanouts), "failed": failed,
            "notes": {"fanouts": len(fanouts), "checked": checked,
                      "rejected": rejected,
                      "program_failed": failed - rejected,
                      "walls_s": [round(f["t1"] - f["t0"], 3)
                                  for f in fanouts],
                      "retried": sum(f["retried"] for f in fanouts),
                      "cpu_fallback": sum(f["cpu_fallback"]
                                          for f in fanouts),
                      "obj_gap": numbers["obj_gap"]}}


def _check(cfg, mix, seed, answers, limits, budget):
    rng = np.random.default_rng(series.stream_seed(seed, 1 << 21))
    keys = sorted(answers)
    chosen = [keys[i] for i in sorted(rng.choice(
        len(keys), size=min(budget, len(keys)), replace=False))]
    worst = {"obj_gap": 0.0, "prim_viol": 0.0}
    rejected = 0
    cache: dict = {}
    for k, i, w in chosen:
        if k not in cache:
            cache = {k: _cases(cfg, mix, seed, k)}
        case = cache[k][i]
        req = ref.horizon_requirements(case)
        rl = ref.build(case, *ref.windows(case)[w], req)
        best, _ = ref.solve(rl)
        named, obj = answers[(k, i, w)]
        nums = ref.judge(rl, rl.vector(named), best, reported=obj)
        if any(nums[n] > limits[n] for n in limits):
            rejected += 1
        for n in worst:
            worst[n] = max(worst[n], nums[n])
    return worst, rejected, len(chosen)
