#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``dervet_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --profile   # + the device's busy share in phase 3

Phases:
  1. build   — compile ``dervet_tpu_torch/ops/csrc/fused_chunk.cu`` (nvcc,
               sm_90a) and print ptxas's register/shared-memory report;
  2. kernels — each chunk kernel against its plain PyTorch version after
               one chunk of 32 iterations, at every shape phases 3 and 4
               run (at their batch, and at B = 1 and 129) and at two more
               (all-equality rows without the wide-row pair; mixed
               equality/inequality rows on the dense op), three step
               variants each: from the solver's mid-solve state, and from
               an arbitrary state against the float64 plain run; then
               each kernel's and its plain version's time at its main
               shape (CUDA events, warm) beside the least time the card
               could take for the work the function needs, and for the
               work as the kernel computes it (dense W and K, zeros too);
  3. main    — ``DERVET.from_cases(synthetic_sensitivity_cases(128,
               daily_cycle_limit=1)).solve(backend="torch")``: 128 cases x
               12 monthly windows; every window certified, no CPU-fallback
               window, every group on the banded kernel at a shape phase 2
               checked, and its launches;
  4. dense   — eight weekly-window cases (``n=168``) through the same entry,
               riding the dense kernel at shapes phase 2 checked;
  5. check   — the first 4 cases of phase 3 on exact HiGHS
               (``backend="cpu"``): per-window objective rel < 1e-3.

It exits non-zero on any failure, and without a result when no GPU is
visible or when the package is missing.  The last two lines are the
``kernels`` JSON line and the device JSON line; the card's name and power
limit come just before them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# the card's published peaks (H100 SXM data sheet: HBM3 rate, fp32 rate
# outside the tensor cores), for the bound each kernel is held against
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# kernel vs plain after one 32-iteration chunk from the solver's own
# mid-solve state: max |kernel - plain| over (1 + max |plain|).  The
# kernel fuses multiply-adds (FMA) and sums the wide-row and dense
# products in another order than the plain version's matmuls: fp32
# rounding of ~1e-7 relative per iteration, which such a state does not
# amplify much.
KERNEL_RTOL = 1e-4
# From an arbitrary state the chunk amplifies fp32 rounding (most on
# all-equality rows, and there in a few instances), so there the kernel
# is held against the float64 run of the plain version: it passes when
# its gap, tensor by tensor, is at most ROUNDING_FACTOR times the largest
# gap of the fp32 plain version run on the same inputs and on
# ROUNDING_RUNS copies moved by one ulp, plus ROUNDING_FLOOR.
ROUNDING_FACTOR = 4.0
ROUNDING_FLOOR = 1e-6
ROUNDING_RUNS = 4
CHUNK_ITERS = 32
# iterations the kernel checks start from (see chunk_inputs)
WARM_ITERS = 256
MAIN_CASES = 128
WEEKLY_CASES = 8
OBJ_RTOL = 1e-3


def log(*a):
    print(*a, flush=True)


def check(ok, what) -> None:
    """A phase's assertion (raised even under ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def window_lps(n, daily_cycle_limit):
    """{T: the first window LP of length ``T`` hours} of the synthetic
    case with window scheme ``n``."""
    from dervet_tpu_torch import benchlib
    from dervet_tpu_torch.scenario.scenario import MicrogridScenario
    scen = MicrogridScenario(benchlib.synthetic_case(
        n=n, daily_cycle_limit=daily_cycle_limit))
    scen.prepare_dispatch("torch")
    out = {}
    for ctx in scen.windows:
        if ctx.T not in out:
            out[ctx.T] = scen.build_window_lp(ctx, scen._annuity_scalar,
                                              scen._requirements)
    return out


def chunk_inputs(solver, B, seed, warm_iters=WARM_ITERS):
    """One batch of scaled chunk inputs as the main path meets them:
    per-instance price noise, then the solver's own cold start advanced
    ``warm_iters`` iterations (restarts, primal-weight updates and all),
    so the chunk runs from a realistic mid-solve state.  Returns the
    context and (omega, x, y, x_sum, y_sum, inner count, anchors)."""
    import numpy as np
    import torch
    lp, dev = solver.lp, solver.device
    rng = np.random.default_rng(seed)
    mult = rng.lognormal(0.0, 0.15, (B, lp.n))
    C = torch.as_tensor(np.where(lp.c != 0, mult * lp.c, 0.0),
                        dtype=torch.float32, device=dev)
    Q, L, U = (torch.as_tensor(np.broadcast_to(a, (B, a.shape[0])).copy(),
                               dtype=torch.float32, device=dev)
               for a in (lp.q, lp.l, lp.u))
    sv = solver._solver
    args = (solver.op, C, Q, L, U, solver.dr, solver.dc)
    st = sv.run_chunk(*args, solver.eta, sv.init_state(*args), warm_iters)
    t = sv._context(C, Q, L, U, solver.dr, solver.dc)
    # a mid-window halpern inner count (the state may sit at a restart)
    k = st.inner + torch.as_tensor(rng.integers(0, 64, B), dtype=torch.int32,
                                   device=dev)
    return (t, st.omega, st.x, st.y, st.x_sum, st.y_sum, k,
            st.x_restart, st.y_restart)


def random_inputs(solver, B, seed):
    """Chunk inputs from an arbitrary state rather than a mid-solve one:
    x and the primal anchor uniform in the box (infinite sides cut at
    +-10), y, the dual anchor and the running sums standard normal,
    primal weights lognormal(0, 1), halpern inner counts in [0, 64)."""
    import numpy as np
    import torch
    lp, dev = solver.lp, solver.device
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=dev)

    C, Q, L, U = (f32(np.broadcast_to(a, (B, a.shape[0])))
                  for a in (lp.c, lp.q, lp.l, lp.u))
    t = solver._solver._context(C, Q, L, U, solver.dr, solver.dc)
    l_s, u_s = t.l_s.cpu().numpy(), t.u_s.cpu().numpy()
    lo = np.where(np.isfinite(l_s), l_s, -10.0)
    hi = np.where(np.isfinite(u_s), u_s, 10.0)
    x, ax = (f32(lo + (hi - lo) * rng.random((B, lp.n))) for _ in range(2))
    y, ay, ys = (f32(rng.standard_normal((B, lp.m))) for _ in range(3))
    xs = f32(rng.standard_normal((B, lp.n)))
    omega = f32(rng.lognormal(0.0, 1.0, B))
    k = torch.as_tensor(rng.integers(0, 64, B), dtype=torch.int32,
                        device=dev)
    return (t, omega, x, y, xs, ys, k, ax, ay)


def plain_chunk(solver, inputs, variant, alpha, dtype):
    """The kernel's plain version on ``inputs`` cast to ``dtype`` (the
    step sizes are the kernel's float32 ones, cast)."""
    import torch
    from dervet_tpu_torch.ops import fused_chunk as fc
    from dervet_tpu_torch.ops.pdhg import BandedOp
    t, omega, x, y, xs, ys, k, ax, ay = inputs
    op, n_eq = solver.op, solver.lp.n_eq
    tau = (solver.eta / omega).float()
    sig = (solver.eta * omega).float()
    extra = ((k.float(), ax, ay) if variant == fc.HALPERN
             else (None, None, None))
    cast = [None if v is None else v.to(dtype) for v in
            (t.c_s, t.q_s, t.l_s, t.u_s, tau, sig, x, y, xs, ys, *extra)]
    if isinstance(op, BandedOp):
        W = None if op.wide_w is None else op.wide_w.to(dtype)
        out = fc.banded_chunk_plain(*cast[:10], op.diags.to(dtype),
                                    op.offsets_t, op.wide_rows, W, n_eq,
                                    CHUNK_ITERS, variant, alpha, *cast[10:])
    else:
        out = fc.dense_chunk_plain(*cast[:10], op.Kh.to(dtype), n_eq,
                                   CHUNK_ITERS, variant, alpha, *cast[10:])
    torch.cuda.synchronize()
    return out


def rounding_runs(solver, inputs, variant, alpha):
    """The float32 plain version on ``inputs`` and on ROUNDING_RUNS
    copies whose x and y are moved by one ulp at random (seeded): the
    spread of float32 answers that rounding alone gives."""
    import numpy as np
    import torch
    yield plain_chunk(solver, inputs, variant, alpha, torch.float32)
    rng = np.random.default_rng(0)
    t, omega, x, y, xs, ys, k, ax, ay = inputs

    def nudge(v):
        sign = torch.as_tensor(rng.integers(-1, 2, tuple(v.shape)),
                               dtype=v.dtype, device=v.device)
        return (v * (1.0 + sign * 2.0 ** -23)).contiguous()

    for _ in range(ROUNDING_RUNS):
        yield plain_chunk(solver, (t, omega, nudge(x), nudge(y), xs, ys, k,
                                   ax, ay), variant, alpha, torch.float32)


def kernel_chunk(solver, inputs, variant, alpha):
    import torch
    from dervet_tpu_torch.ops import fused_chunk as fc
    t, omega, x, y, xs, ys, k, ax, ay = inputs
    out = fc.batched_chunk(solver.op, t.c_s, t.q_s, t.l_s, t.u_s, omega,
                           solver.eta, x, y, xs, ys, solver.lp.n_eq,
                           CHUNK_ITERS, variant, alpha, k, ax, ay)
    torch.cuda.synchronize()
    return out


def rel_gap(a, ref) -> float:
    """max |a - ref| / (1 + max |ref|), in float64."""
    a, ref = a.double(), ref.double()
    return ((a - ref).abs().max() / (1.0 + ref.abs().max())).item()


def matrix_nnz(op) -> int:
    """Non-zeros of the scaled K the op carries (bands + wide pair, or
    the dense K)."""
    from dervet_tpu_torch.ops.pdhg import BandedOp
    if isinstance(op, BandedOp):
        nnz = int((op.diags != 0).sum())
        if op.wide_w is not None:
            nnz += int((op.wide_w != 0).sum())
        return nnz
    return int((op.Kh != 0).sum())


def bound(kname, op, B, m, n, variant, nnz=None):
    """(bound ms, bound_by, bytes, operations) of one launch."""
    from dervet_tpu_torch.ops import fused_chunk as fc
    from dervet_tpu_torch.ops.pdhg import BandedOp
    banded = isinstance(op, BandedOp)
    r = 0 if not banded or op.wide_w is None else int(op.wide_w.shape[0])
    nbytes, ops = fc.chunk_cost(kname, B, m, n, CHUNK_ITERS,
                                nb=len(op.offsets) if banded else 0, r=r,
                                variant=variant, nnz=nnz)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def time_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase():
    """Returns ({kernel name: record} for the kernels JSON line,
    {kernel name: set of (m, n) checked})."""
    import torch
    from dervet_tpu_torch.ops import fused_chunk as fc
    from dervet_tpu_torch.ops.pdhg import (BandedOp, CompiledLPSolver,
                                           PDHGOptions)
    alpha_of = {fc.VANILLA: 1.0, fc.REFLECTED: 1.8, fc.HALPERN: 2.0}
    monthly, weekly = window_lps("month", 1), window_lps(168, 0)
    # (name, lp, the path's batch, timed for the kernels line): the groups
    # the main path runs (31-, 30- and 28-day months x MAIN_CASES) and the
    # weekly run's (52 weeks and the 24-hour remainder x WEEKLY_CASES),
    # then two shapes neither runs, for coverage: the monthly op with
    # all-equality rows (no wide pair) and the weekly op with mixed
    # equality/inequality rows
    shapes = [
        ("banded 31d", monthly[744], 7 * MAIN_CASES, True),
        ("banded 30d", monthly[720], 4 * MAIN_CASES, False),
        ("banded 28d", monthly[672], MAIN_CASES, False),
        ("dense 7d", weekly[168], 52 * WEEKLY_CASES, True),
        ("dense 24h", weekly[24], WEEKLY_CASES, False),
        ("banded all-eq", window_lps("month", 0)[744], 7 * MAIN_CASES,
         False),
        ("dense mixed", window_lps(168, 1)[168], 52 * WEEKLY_CASES, False),
    ]
    records, checked, failures = {}, {k: set() for k in fc.KERNELS}, []
    for name, lp, b_main, timed in shapes:
        solver = CompiledLPSolver(lp, PDHGOptions(), device="cuda")
        op = solver.op
        kname = fc.kernel_for(op)
        banded = isinstance(op, BandedOp)
        r = 0 if not banded or op.wide_w is None else int(op.wide_w.shape[0])
        nnz = matrix_nnz(op)
        log(f"[kernels] {name}: m={lp.m} n={lp.n} n_eq={lp.n_eq} "
            f"{kname} nnz(K)={nnz}"
            + (f" nb={len(op.offsets)} r={r}" if banded else ""))
        check(fc.supports(op, fc.REFLECTED), f"{name}: kernel declines")
        checked[kname].add((lp.m, lp.n))
        worst_abs, worst_rand = 0.0, (0.0, 0.0)
        for variant in fc.VARIANTS:
            alpha = alpha_of[variant]
            # from the solver's own mid-solve state
            for B in sorted({1, 129, b_main}):
                inputs = chunk_inputs(solver, B, seed=B)
                kern = kernel_chunk(solver, inputs, variant, alpha)
                plain = plain_chunk(solver, inputs, variant, alpha,
                                    torch.float32)
                abs_err = max((a - b).abs().max().item()
                              for a, b in zip(kern, plain))
                rel_err = max(rel_gap(a, b) for a, b in zip(kern, plain))
                finite = all(torch.isfinite(a).all().item() for a in kern)
                log(f"[kernels]   {variant:9s} B={B:4d} max_abs={abs_err:.3e}"
                    f" max_rel={rel_err:.3e} finite={finite}")
                if not finite or rel_err > KERNEL_RTOL:
                    failures.append(f"{name} {variant} B={B}: rel "
                                    f"{rel_err:.3e}")
                worst_abs = max(worst_abs, abs_err)
            # from an arbitrary state, against the float64 plain run
            inputs = random_inputs(solver, 129, seed=3)
            kern = kernel_chunk(solver, inputs, variant, alpha)
            p64 = plain_chunk(solver, inputs, variant, alpha, torch.float64)
            spread = [0.0] * 4
            for run in rounding_runs(solver, inputs, variant, alpha):
                spread = [max(s, rel_gap(o, h))
                          for s, o, h in zip(spread, run, p64)]
            gaps = [rel_gap(a, h) for a, h in zip(kern, p64)]
            gk, g32 = max(gaps), max(spread)
            worst_rand = (max(worst_rand[0], gk), max(worst_rand[1], g32))
            ok = all(g <= ROUNDING_FACTOR * s + ROUNDING_FLOOR
                     for g, s in zip(gaps, spread))
            log(f"[kernels]   {variant:9s} random state B=129: kernel vs "
                f"float64 {gk:.3e}, float32 plain runs vs float64 up to "
                f"{g32:.3e} ({'rounding' if ok else 'BEYOND ROUNDING'})")
            if not ok:
                failures.append(f"{name} {variant} random state: kernel "
                                f"{gk:.3e} vs plain runs {g32:.3e} from "
                                "float64")
        # timing at the path's batch, the product's default variant
        variant = fc.REFLECTED
        inputs = chunk_inputs(solver, b_main, seed=7)
        ms = time_ms(lambda: fc.batched_chunk(
            op, inputs[0].c_s, inputs[0].q_s, inputs[0].l_s, inputs[0].u_s,
            inputs[1], solver.eta, *inputs[2:6], lp.n_eq, CHUNK_ITERS,
            variant, 1.8, *inputs[6:]), 20)
        plain_ms = time_ms(lambda: plain_chunk(solver, inputs, variant, 1.8,
                                               torch.float32), 3)
        need = bound(kname, op, b_main, lp.m, lp.n, variant, nnz=nnz)
        stored = bound(kname, op, b_main, lp.m, lp.n, variant)
        log(f"[kernels] {name} timing B={b_main} {variant} x{CHUNK_ITERS}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound of the "
            f"work needed {need[0]:.4f} ms by {need[1]} ({need[2]} B, "
            f"{need[3]} fp32 ops); bound as computed {stored[0]:.4f} ms by "
            f"{stored[1]} ({stored[2]} B, {stored[3]} fp32 ops)")
        rec = records.setdefault(kname, {
            "name": kname, "route": "cuda",
            "source": "dervet_tpu_torch/ops/csrc/fused_chunk.cu",
            "replaces": ("dervet_tpu/ops/pallas_chunk.py:246"
                         if kname == fc.KERNEL_BANDED
                         else "dervet_tpu/ops/pallas_chunk.py:105"),
            "launches": 0, "max_abs_err": 0.0,
            "random_state_gap": {"kernel": 0.0, "plain_f32_runs": 0.0}})
        rec["max_abs_err"] = max(rec["max_abs_err"], worst_abs)
        rs = rec["random_state_gap"]
        rs["kernel"] = max(rs["kernel"], worst_rand[0])
        rs["plain_f32_runs"] = max(rs["plain_f32_runs"], worst_rand[1])
        if timed:
            rec.update({
                "ms": ms, "plain_ms": plain_ms, "bound_ms": need[0],
                "bound_by": need[1], "library_ms": None,
                "bound_as_computed_ms": stored[0],
                "bound_as_computed_by": stored[1],
                "shape": {"m": lp.m, "n": lp.n, "B": b_main, "nnz": nnz,
                          "iters": CHUNK_ITERS, "variant": variant}})
    if failures:
        raise AssertionError("kernel disagrees with its plain version: "
                             + "; ".join(failures))
    return records, checked


# ---------------------------------------------------------------------------
# phases 3-5: the product path
# ---------------------------------------------------------------------------

def solve_cases(cases, backend):
    from dervet_tpu_torch.api import DERVET
    t0 = time.perf_counter()
    res = DERVET.from_cases(cases).solve(backend=backend)
    return res, time.perf_counter() - t0


def check_certified(res, n_windows, what):
    health = res.run_health
    cert = health["certification"]["windows"]
    log(f"[{what}] windows {health['windows']} certification {cert}")
    check(cert["certified"] + cert["certified_loose"] == n_windows,
          f"{what}: {cert} of {n_windows} windows certified")
    check(health["windows"]["cpu_fallback"] == 0,
          f"{what}: CPU-fallback windows {health['windows']}")
    check(not health["cases_quarantined"], health["quarantine_reasons"])
    check(health["invariant_audit"]["ok"], health["invariant_audit"])


def check_ledger(res, kernel, checked, what):
    """Every device group ran ``kernel`` with no fallback, at a shape
    phase 2 held against the plain version (``checked``: (m, n) set)."""
    from dervet_tpu_torch import benchlib
    led = benchlib.validate_solve_ledger(res.solve_ledger)
    dev_groups = [g for g in led["groups"] if g.get("backend") == "torch"]
    check(dev_groups, f"{what}: no device groups in the ledger")
    for g in dev_groups:
        check(g["kernel"] == kernel and "kernel_fallback" not in g,
              f"{what}: group m={g['m']} n={g['n']} ran {g['kernel']} "
              f"({g.get('kernel_fallback')}: "
              f"{g.get('kernel_fallback_detail')})")
        check((g["m"], g["n"]) in checked,
              f"{what}: group m={g['m']} n={g['n']} runs a shape phase 2 "
              f"did not check ({sorted(checked)})")
    log(f"[{what}] phases {res.phase_seconds}")
    log(f"[{what}] ledger totals {json.dumps(led['totals'])}")
    log(f"[{what}] ledger kernel {json.dumps(led['kernel'])} iters "
        f"{json.dumps(led.get('iters'))}")
    for g in dev_groups:
        log(f"[{what}]   group m={g['m']} n={g['n']} batch={g['batch']} "
            f"solve_s={g['solve_s']} iters_p50={g['iters_p50']} "
            f"max={g['iters_max']} chunks={g['chunks']} "
            f"launches={g['kernel_launches']} compact={g['compact_events']}")


def profiled(fn):
    """Run ``fn`` under torch.profiler and print the device's busy time
    by kernel name and as a share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us:
            rows.append((dev_us, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"[profile] wall {wall:.3f} s, device busy {busy:.3f} s "
        f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for dev_us, count, key in rows[:15]:
        log(f"[profile]   {dev_us / 1e3:10.2f} ms  x{count:<7d} {key[:90]}")
    return out


def main_phases(records, checked, profile=False):
    from dervet_tpu_torch import benchlib
    from dervet_tpu_torch.ops import fused_chunk as fc
    # 3. main path: monthly windows with daily-cycle rows
    cases = benchlib.synthetic_sensitivity_cases(MAIN_CASES,
                                                 daily_cycle_limit=1)
    fc.reset_launch_counts()
    if profile:
        res, wall = profiled(lambda: solve_cases(cases, "torch"))
    else:
        res, wall = solve_cases(cases, "torch")
    launches = dict(fc.LAUNCHES)
    log(f"[main] {MAIN_CASES} cases x 12 months: {wall:.2f} s wall, "
        f"launches {launches}")
    check_certified(res, MAIN_CASES * 12, "main")
    check_ledger(res, fc.KERNEL_BANDED, checked[fc.KERNEL_BANDED], "main")
    check(launches[fc.KERNEL_BANDED] > 0, "banded kernel never launched")
    records[fc.KERNEL_BANDED]["launches"] = launches[fc.KERNEL_BANDED]
    torch_obj = {k: inst.objective_values["Total Objective"]
                 for k, inst in res.instances.items()}
    for k, s in torch_obj.items():
        check(s.notna().all() and len(s) == 12, f"case {k}: {s}")

    # 4. dense path: weekly windows
    weekly = benchlib.synthetic_sensitivity_cases(WEEKLY_CASES, n=168)
    fc.reset_launch_counts()
    res_w, wall_w = solve_cases(weekly, "torch")
    launches_w = dict(fc.LAUNCHES)
    n_weekly = sum(len(inst.objective_values)
                   for inst in res_w.instances.values())
    log(f"[dense] {WEEKLY_CASES} weekly cases ({n_weekly} windows): "
        f"{wall_w:.2f} s "
        f"wall, launches {launches_w}")
    check_certified(res_w, n_weekly, "dense")
    check_ledger(res_w, fc.KERNEL_DENSE, checked[fc.KERNEL_DENSE], "dense")
    check(launches_w[fc.KERNEL_DENSE] > 0, "dense kernel never launched")
    records[fc.KERNEL_DENSE]["launches"] = launches_w[fc.KERNEL_DENSE]

    # 5. cross-check against exact HiGHS on the first 4 cases
    ref_cases = benchlib.synthetic_sensitivity_cases(
        MAIN_CASES, daily_cycle_limit=1)[:4]
    res_c, wall_c = solve_cases(ref_cases, "cpu")
    worst = 0.0
    for k, inst in res_c.instances.items():
        ref = inst.objective_values["Total Objective"]
        got = torch_obj[k].loc[ref.index]
        rel = ((got - ref).abs() / ref.abs().clip(lower=1.0)).max()
        worst = max(worst, float(rel))
    log(f"[check] 4 cases x 12 windows vs HiGHS ({wall_c:.2f} s): max "
        f"per-window objective rel {worst:.3e} (limit {OBJ_RTOL})")
    check(worst < OBJ_RTOL, f"objective rel {worst} vs HiGHS")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the main path with torch.profiler and "
                         "print the device's busy share")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    try:
        from dervet_tpu_torch.ops import fused_chunk as fc
    except ImportError as e:
        print(f"chip_smoke: the dervet_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    so = fc.build()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in fc.BUILD_LOG.splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            log(f"[build] {line.strip()}")
    t0 = time.perf_counter()
    records, checked = kernel_phase()
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    main_phases(records, checked, profile=args.profile)
    log(f"[main] phases 3-5 done in {time.perf_counter() - t0:.1f} s")
    card = card_line()
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
