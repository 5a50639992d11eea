"""The price-scenario sweep (traffic kind ``sweep``): DER-VET's north star
as ``bench.py`` shapes it, a year of monthly window LPs x N lognormal
price scenarios, solved in passes back to back.

Set-up builds the configuration's window LPs with the program's
``benchlib.build_window_lps``, one ``CompiledLPSolver`` a window-length
group, and places each group's base costs, Q, L and U on the card once
(window-major, each window repeated N times).  A pass then draws, on the
card, one lognormal multiplier (sigma from the mix) for every priced
coefficient of every instance, keyed by the variable and hour it prices,
and solves each group with ``solver.solve(c=C, q=Q, l=L, u=U)``.  Warm-up
passes run until every compaction bucket the traffic reaches is
captured.

Each pass keeps, for the check after the window, one instance a group
drawn from the seed and the group's instance with the most iterations:
its answer and its multipliers.  The reference rebuilds those windows
from the case's inputs, prices them with the same multipliers and judges
the answers.
"""
from __future__ import annotations

import time

import numpy as np

from .. import roofline, series, trace
from ..reference import lp as ref

TRACED_PASSES = (1, 2)


def _groups(case: dict, device, opts):
    """One job a window-length group: solver, placed inputs, the priced
    blocks and the calendar index of each of its windows."""
    import torch
    from dervet_tpu_torch import benchlib
    from dervet_tpu_torch.io.params import CaseParams, Datasets
    from dervet_tpu_torch.ops.pdhg import CompiledLPSolver
    _, groups = benchlib.build_window_lps(
        series.case_params(case, 0, CaseParams, Datasets))
    calendar = ref.windows(case)
    jobs = []
    for T, lps in sorted(groups.items()):
        lp = lps[0]
        priced = [name for name, r in lp.var_refs.items()
                  if any(np.any(x.c[r.sl] != 0) for x in lps)]
        cols = np.concatenate([np.arange(lp.var_refs[p].start,
                                         lp.var_refs[p].start + T)
                               for p in priced])
        for x in lps:
            rest = np.ones(x.n, bool)
            rest[cols] = False
            if np.any(x.c[rest] != 0) or any(
                    lp.var_refs[p].size != T for p in priced):
                raise ValueError("a priced coefficient lies outside the "
                                 "per-hour blocks the draw keys")

        def placed(name):
            return torch.as_tensor(np.stack([getattr(x, name) for x in lps]),
                                   dtype=torch.float32, device=device)
        jobs.append({
            "T": T, "m": lp.m, "n": lp.n,
            "nnz": int(np.count_nonzero(lp.K.data)),
            "solver": CompiledLPSolver(lp, opts, device=device),
            "c": placed("c"), "q": placed("q"), "l": placed("l"),
            "u": placed("u"), "priced": priced,
            "cols": torch.as_tensor(cols, device=device),
            "var_refs": {k: (r.start, r.size) for k, r in lp.var_refs.items()},
            "calendar": [i for i, (_, t) in enumerate(calendar) if t == T]})
    return jobs


def _place(jobs, S: int) -> None:
    for job in jobs:
        for k in ("c", "q", "l", "u"):
            job[k + "_rep"] = job[k].repeat_interleave(S, dim=0)


def _draw(job, seed: int, p: int, gi: int, sigma: float):
    """(C, M): the pass's costs and the multipliers of every priced
    coefficient, (B, priced blocks x T), from one generator on the card."""
    import torch
    c = job["c_rep"]
    gen = torch.Generator(device=c.device)
    gen.manual_seed(series.stream_seed(seed, p, gi))
    M = torch.randn((c.shape[0], job["cols"].numel()), generator=gen,
                    device=c.device, dtype=c.dtype)
    M = torch.exp(sigma * M)
    C = c.clone()
    C[:, job["cols"]] = c[:, job["cols"]] * M
    return C, M


def run(cell, rec) -> dict:
    import torch
    from dervet_tpu_torch.ops.pdhg import PDHGOptions, SolveStats
    cfg, mix, args = cell.config, cell.traffic, rec.args
    dev, on_card = rec.device, rec.device.type == "cuda"
    S, sigma = int(mix["scenarios"]), float(mix["sigma"])
    opts = PDHGOptions(**cfg["solver"])
    if rec.control == "screening":
        opts = PDHGOptions.screening(opts)
    case = series.case_dict(cfg, cfg["series_seed"])
    jobs = _groups(case, dev, opts)
    _place(jobs, S)
    rng = np.random.default_rng(series.stream_seed(args.seed, 1 << 20))

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def one_pass(p: int, traced: bool, stats_sink: list):
        kept, uncon, iters = [], [], []
        t0 = time.perf_counter()
        for gi, job in enumerate(jobs):
            with trace.span("draw", traced):
                C, M = _draw(job, args.seed, p, gi, sigma)
            st = SolveStats()
            with trace.span(f"solve/T={job['T']}", traced):
                res = job["solver"].solve(c=C, q=job["q_rep"],
                                          l=job["l_rep"], u=job["u_rep"],
                                          stats=st)
                if traced:
                    sync()
            stats_sink.append(st)
            # one instance drawn from the seed and the one with the most
            # iterations, gathered on the card (no host read in the pass)
            r = int(rng.integers(C.shape[0]))
            top = torch.argmax(res.iters).view(1)
            kept.append((gi, r, top) + tuple(
                torch.cat([a[r:r + 1], a.index_select(0, top)])
                for a in (res.x, M, res.iters)))
            uncon.append((~res.converged).sum())
            if traced:
                iters.append(res.iters)
        sync()
        t1 = time.perf_counter()
        return t0, t1, kept, uncon, iters

    # warm-up: until a pass captures no graph the traffic needs
    for k in range(int(mix.get("warmup_passes", 0))):
        stats = []
        one_pass(-1 - k, False, stats)
        if k and not sum(st.graph_captures for st in stats):
            break

    data = rec.start_window()
    passes, kept, stats, uncon, iters_traced = [], [], [], 0, []
    work = [0.0, 0.0]
    p, slicer = 0, None
    while True:
        traced = rec.trace and p in TRACED_PASSES
        if traced and slicer is None:
            slicer = trace.Slice().__enter__()
        t0, t1, kept_p, uncon_p, iters_p = one_pass(p, traced, stats)
        if traced and p == TRACED_PASSES[-1]:
            slicer.__exit__(None, None, None)
            data["trace"] = slicer.result
        passes.append((t0, t1, sum(j["c_rep"].shape[0] for j in jobs)))
        uncon += int(sum(int(u) for u in uncon_p))
        for gi, r, top, x, M, it in kept_p:
            x, M, it = (a.cpu().numpy() for a in (x, M, it))
            for j, inst in enumerate((r, int(top))):
                kept.append({"pass": p, "group": gi, "inst": inst,
                             "x": x[j].astype(np.float64),
                             "M": M[j].astype(np.float64),
                             "iters": int(it[j])})
        for gi, it in enumerate(iters_p):
            it = it.cpu().numpy()
            iters_traced.append(it)
            job = jobs[gi]
            ops, nbytes = roofline.solve_work(it, job["m"], job["n"],
                                              job["nnz"])
            work[0] += ops
            work[1] += nbytes
        p += 1
        if t1 - data["t_window"] >= args.seconds and (
                not rec.trace or p > TRACED_PASSES[-1]):
            break
    rec.close_window()
    data["passes"] = passes
    data["capture_s"] = float(sum(st.capture_s for st in stats))
    if iters_traced:
        data["iters_traced"] = np.concatenate(iters_traced)
        data["solve_work"] = tuple(work)
    attempted = sum(n for _, _, n in passes)
    numbers, rejected = _check(case, jobs, kept, S, cell.limits, rng,
                               int(mix["check_instances"]))
    return {"data": data, "numbers": numbers, "attempted": attempted,
            "failed": uncon + rejected,
            "notes": {"unconverged": uncon, "rejected": rejected,
                      "checked": numbers.pop("checked")}}


def _check(case, jobs, kept, S, limits, rng, budget):
    """The reference's verdict on the kept answers: the hardest instance of
    each group in the window and others drawn from the seed, up to
    ``budget``.  Returns the worst of each number and how many answers a
    limit rejected."""
    order = sorted(range(len(kept)), key=lambda i: -kept[i]["iters"])
    hardest = {}
    for i in order:
        hardest.setdefault(kept[i]["group"], i)
    rest = [i for i in range(len(kept)) if i not in hardest.values()]
    extra = rng.choice(rest, size=min(len(rest), max(budget - len(hardest),
                                                     0)), replace=False)
    chosen = sorted(set(hardest.values()) | set(int(i) for i in extra))
    req = ref.horizon_requirements(case)
    calendar = ref.windows(case)
    built: dict = {}
    worst = {"obj_gap": 0.0, "prim_viol": 0.0}
    rejected = 0
    for i in chosen:
        k = kept[i]
        job = jobs[k["group"]]
        w = job["calendar"][k["inst"] // S]
        if w not in built:
            built[w] = ref.build(case, *calendar[w], req)
        rl = built[w]
        c = rl.matrices()[0].copy()
        T = job["T"]
        for j, name in enumerate(job["priced"]):
            s, size = rl.blocks[name]
            c[s:s + size] *= k["M"][j * T:(j + 1) * T]
        best, _ = ref.solve(rl, c)
        x = rl.vector({name: k["x"][s:s + size]
                       for name, (s, size) in job["var_refs"].items()})
        nums = ref.judge(rl, x, best, c=c)
        if any(nums[n] > limits[n] for n in limits):
            rejected += 1
        for n in worst:
            worst[n] = max(worst[n], nums[n])
    worst["checked"] = len(chosen)
    return worst, rejected
