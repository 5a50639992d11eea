#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (``dervet_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100 and the
CUDA toolkit:

    python3 chip_smoke.py             # every phase
    python3 chip_smoke.py --profile   # + the device's busy share in phase 3
    python3 chip_smoke.py --time DIR  # only time the kernels of DIR's copy

Phases:
  1. build   — compile ``dervet_tpu_torch/ops/csrc/fused_chunk.cu`` (nvcc,
               sm_90a) and print each kernel instance's registers, stack
               and spills from ptxas; fails on a spill;
  2. kernels — each chunk kernel against its plain PyTorch version after
               one chunk of 32 iterations, at every shape phases 3, 4, 6
               and 7 run (at their batch, and at B = 1 and 129) and at five
               more (all-equality rows without the wide-row pair; mixed
               equality/inequality rows on the dense op; the ICE + CHP
               monthly window, 2233 x 5952 with seven bands; and two
               shapes of the shared-state configuration, the DA + FR
               monthly window, 3752 x 4464 with ten bands, and a dense
               block with every entry of K non-zero), three step
               variants each: from the solver's mid-solve state, and from
               an arbitrary state against the float64 plain run; then
               each shape's kernel device time a launch (torch.profiler;
               fails if it records none) and its plain version's (CUDA
               events, warm) beside the least time the card could take
               for the work the function needs (K's non-zeros), and for
               the work as the kernel stores and computes it (padded
               band diagonals, compact forms); then the banded kernel at
               every (structure, batch) pair phases 8 and 9 can launch
               (the three monthly structures x the bucket grid 1-8,192),
               from the mid-solve state and, up to 2,048, from a
               refinement round's seeded start, each pair's device time
               beside its bound, and the widest groups' real batches;
               then the dense kernel at the pairs phases 10-12 launch
               (the weekly structure at the bucket widths 8-512, the
               24-hour remainder at 8, both also with the daily-cycle
               rows, and the service's warm-up LP at 8); and both kernels
               at the widths phase 13 launches (the three monthly
               structures at its elastic groups' 448, 256 and 64, the
               weekly structure at a 208-wide shard);
  3. main    — ``DERVET.from_cases(synthetic_sensitivity_cases(128,
               daily_cycle_limit=1)).solve(backend="torch")``: 128 cases x
               12 monthly windows; every window certified, no CPU-fallback
               window, every group on the banded kernel at a shape phase 2
               checked, and its launches;
  4. dense   — eight weekly-window cases (``n=168``) through the same entry,
               riding the dense kernel at shapes phase 2 checked;
  5. check   — the first 4 cases of phase 3 on exact HiGHS
               (``backend="cpu"``): per-window objective rel < 1e-3;
  6. microgrid — 64 cases x 12 monthly windows of Battery + PV + ICE +
               CHP with DA and Reliability (``synthetic_sensitivity_cases(
               64, multi_der=True, reliability=True)``) through the same
               entry with the solver's CPU straggler rescue off
               (``PDHGOptions(cpu_rescue_after=None)``): every window
               certified, no CPU fallback, no instance rescued on the CPU,
               every group on the banded kernel at a structure phase 2
               checked; the outage walks ran on the card, and their
               coverage, SOE profiles, load-coverage frame and min-SOE
               schedules equal the same stream's on the CPU; the walks'
               device time; the first 4 cases on exact HiGHS;
  7. retail  — 32 cases x 12 monthly windows of Battery + PV billed on a
               time-of-use tariff with demand charges (retailTimeShift +
               DCM): the same checks, every group on the dense kernel, each
               demand-charge group's op, configuration, shape and batch
               logged; the first 4 cases on exact HiGHS;
  8. design  — ``run_design`` on the main case at the JAX package's
               defaults (512 Halton candidates over 0.5-4 MW x 1-16 MWh,
               one refinement round, the top 8 certified; CPU straggler
               rescue off): every group on the banded kernel at a pair
               phase 2 checked, no screening answer certificate-stamped,
               the refinement round seeded from round 0, the 8 finalists
               certified with none rescued on the CPU, their seeded
               iterations below a cold solve of the same finalists, the
               finalists on exact HiGHS within 1e-3 with the same winner;
               then ``sizing_sweep`` on a 4 x 4 grid, whose surface argmin
               is the certified top-1;
  9. montecarlo — ``run_montecarlo`` with 1,024 samples (seed 0): one
               screening dispatch and one certified dispatch of the
               quantile-pinning samples, the same kernel checks, the
               pinned samples on exact HiGHS within 1e-3, the published
               statistics recomputed from the published samples to 1e-9;
               then 256 samples in order and reversed on fresh caches
               within 1e-3 (the largest difference logged), and a rerun
               and a reversed-order run of the first on its caches
               byte-identical.
               Phases 8 and 9 print their wall split (prep_s /
               dispatch_s / post_s), launches and peak device memory;
 10. serve   — the scenario service on the card: ``ScenarioService()``
               (``device=None`` -> cuda:0) warms the card at ``start``
               (the dense kernel at the warm-up LP's pair) and serves,
               each round's ``run_once`` driven on a thread of its own:
               a coalesced round of four requests (48, 32 and 16 monthly
               cases with the daily-cycle rows, 8 weekly cases: both
               kernels), every window certified, none on the CPU, every
               group at a pair phase 2 checked (its padded width and
               each bucket it compacted to), the 16-case request within
               1e-6 of its solo solve on the card and its first 4 cases
               on HiGHS, the padding's kernel time logged; a second mix
               (56 + 24 cases) with no solver built (its first runs of a
               program at a new width logged); an exact repeat that
               substitutes every window, launches nothing and answers
               byte-identically; a near
               request (energy x1.02) that seeds, beside the same cases
               cold on a fresh service; a shed storm (queue of 4) whose
               priority-0 answers are degraded and uncertified, launched
               on the card, and whose priority-1 answer is certified; a
               backend-loss drill (one injected ``DeviceLossError``): one
               re-init, no round lost, the replay within 1e-6 of an
               undisturbed answer; a design request (64 candidates, top
               4) and a Monte-Carlo request (128 samples), each repeated
               with no solver built; then ``python -m dervet_tpu_torch
               serve SPOOL --once`` in a process of its own on two
               pickled payloads and a ``portfolio.json`` (4 sites of two
               weekly windows, answered and certified on the card), and
               ``status SPOOL``.  Each round prints its
               wall split, request latency p50/p99, windows per device
               batch, launches by kernel, solver builds and hits, seeded
               and substituted windows and peak device memory;
 11. fleet   — two replicas (``python -m dervet_tpu_torch serve SPOOL
               --backend torch --device cuda:0``, each a process with a
               CUDA context of its own on the one card, loading phase 1's
               library) behind a ``FleetRouter``: 16 monthly cases and 8
               weekly cases (both with the daily-cycle rows: both
               kernels) go to different replicas, a same-structure
               request follows its structure, an exact repeat is
               answered from the request cache (no replica, byte-
               identical artifacts), a delta re-solves only its edited
               month; then the sticky-fault drill: one replica is
               replaced by one with ``DERVET_TPU_FAULT_DEVICE_LOSS=
               sticky`` in its environment, which dies of a real device-
               side assert on its first solve (exit 69, its request left
               admitted), the router re-routes the request to the
               survivor, which answers it once, certified, within 1e-6 of
               an undisturbed solve; the ``FleetSupervisor`` respawns the
               dead replica at the next epoch with its warm import, and
               it answers a further request (restarts 1, quarantined 0,
               failovers >= 1, no request lost).  Prints each replica's
               spawn-to-first-heartbeat time, the respawn time, each
               request's latency and replica, launches by kernel for each
               replica (from its solve ledgers, every group at a pair
               phase 2 checked), cache hits and each replica's peak
               device memory (from the metrics it writes as it drains);
 12. portfolio — ``solve_portfolio(backend="torch")`` at the JAX
               package's scale shape: 64 sites x 336 hours in weekly
               windows, the export cap from a one-round probe, gap 1e-3,
               at most 40 outer rounds: converged, the portfolio
               certificate accepting, every site's windows certified on
               the card with none on the CPU, every group at a pair phase
               2 checked, no solver built after round 1; each round's
               regime, wall split, launches, dual-iterate seeding,
               iterations and warm-start evictions logged; then 8 sites
               against ``monolithic_reference`` (HiGHS on the coupled LP)
               within the gap tolerance, and 16 sites in 2 shards over
               phase 11's fleet: each shard on one replica round after
               round, objective and duals within 1e-6 of the monolithic
               card solve, bytes on the wire by round logged;
 13. parallel — multi-device dispatch on the one card: the first 64
               of phase 3's cases through the elastic scheduler with one
               worker (every window certified, no CPU rescue; against
               phase 3, whose groups are twice as wide: every case
               bit-equal and a sample of cases' CSVs byte-identical),
               then with two
               workers on cuda:0 (``elastic.visible_devices`` replaced
               by ``[cuda:0, cuda:0]``, each worker on a CUDA stream of
               its own) and slot 1 a straggler
               (``DERVET_TPU_FAULT_STRAGGLER``): at least one steal, every
               case bit-equal to the one-worker run, each slot's groups,
               windows and occupancy logged; every launch of both runs at
               a (structure, batch) pair phase 2 checked;
               ``solve_batch_sharded`` over
               ``[cuda:0, cuda:0]`` on the main 31-day structure at an
               odd batch (895) and the weekly structure (415): objectives
               within 1e-5 of the unsharded card solve (bit-equality
               logged), the same converged count, each shard's launches
               at a pair phase 2 checked; the 5-minute year
               window (T = 105,120) row-sharded at world 1 on NCCL
               (``solve_time_sharded``; its all-reduces counted and timed)
               within 2e-3 of HiGHS, and a 5-minute month at world 2 on
               gloo, both ranks on cuda:0, within 5e-4 (objective) and
               5e-3 (x) of the unsharded card solve; the three ranks run
               at once, beside HiGHS and the unsharded card solves.

It exits non-zero on any failure, and without a result when no GPU is
visible or when the package is missing.  The last two lines are the
``kernels`` JSON line and the device JSON line; the card's name and power
limit come just before them.

``--time DIR`` runs none of the phases: it imports the package under DIR
(an unpacked older commit, say) and prints one JSON line with the card,
and each kernel's device time and call time a launch at its main shape
(32 reflected iterations: banded 776 x 2976 at B = 896, dense 169 x 672
at B = 416), so that two commits are compared in one call, in turns.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
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
# each step variant's relaxation, as the solver runs it
ALPHA = {"vanilla": 1.0, "reflected": 1.8, "halpern": 2.0}
# iterations the kernel checks start from (see chunk_inputs)
WARM_ITERS = 256
MAIN_CASES = 128
WEEKLY_CASES = 8
OBJ_RTOL = 1e-3
# phases 6 and 7: their synthetic_sensitivity_cases options and case counts
# (retail at 32 cases, not 64, so the whole smoke with phases 8 and 9
# stays well inside its time limit: its groups' iteration tail runs to
# the 400,000 limit and took ~460 s at 64 on the H100)
RUNS = {"microgrid": (64, {"multi_der": True, "reliability": True}),
        "retail": (32, {"retail": True})}
# the outage walks on the card against the same functions on CPU tensors
WALK_RTOL = 1e-5
# phases 8 and 9 (the design screen and Monte-Carlo) at the JAX package's
# defaults: population 512, top 8 certified, one refinement round; 1,024
# samples; the sizing sweep's grid; the fresh-cache order comparison
DESIGN_BOUNDS = {"kw": (500.0, 4000.0), "kwh": (1000.0, 16000.0)}
DESIGN_POPULATION, DESIGN_TOP_K = 512, 8
SIZING_GRID = ((500.0, 1500.0, 2500.0, 4000.0),
               (1000.0, 6000.0, 11000.0, 16000.0))
MC_SAMPLES, MC_ORDER_SAMPLES = 1024, 256
# two certified totals this close are a tie for the winner check
TIE_RTOL = 1e-4
# the same samples solved in another batch order on fresh caches
MC_ORDER_RTOL = 1e-3
# the batches a design or Monte-Carlo group launches at: a group of one,
# and the bucket grid it pads to (``scenario.batch_bucket``)
GRID_BATCHES = (1, 8, 32, 128, 512, 2048, 8192)
# the seeded check (a refinement round's start) runs up to this batch:
# the rounds that seed from the solution memory (round 1, the certified
# finalists and the pinned samples) launch at most 2,048 wide
SEEDED_MAX_BATCH = 2048
# real batches of the widest groups, timed beside their padded launch
# (31-day months x 512 candidates and x 1,024 samples; 30-day x 1,024)
REAL_BATCHES = {744: (3584, 7168), 720: (4096,), 672: ()}
# the dense kernel's pairs phase 10 launches: the weekly structure at
# the bucket widths a coalesced round pads its 416 windows to (512) and
# compacts them through, the 24-hour remainder at 8, and the service's
# warm-up LP (``device._warmup_lp``, dense) at its batch of 8
DENSE_PAIRS = {168: (8, 32, 128, 512), 24: (8,)}
# the same windows with the daily-cycle rows (phase 11's weekly request,
# 8 cases: 416 weekly windows padded to 512 and the 24-hour remainder)
DAILY_DENSE_PAIRS = {168: (8, 32, 128, 512), 24: (8,)}
WARMUP_BATCH = 8
# phase 10 (the scenario service, one warm ScenarioService on the card):
# the coalesced round's monthly requests (cases with the daily-cycle
# rows, as phase 3) and its weekly request (phase 4's cases, the dense
# kernel); the second mix; the near request's energy factor; the shed
# storm (three priority-0 requests and one priority-1, SERVE_SHED cases
# each, on a queue of depth 4); the drill's request; the design request
# (population, top k) and the Monte-Carlo request; the spool's two
# pickled payloads
SERVE_ROUND = {"m48": 48, "m32": 32, "m16": 16}
SERVE_WEEKLY = 8
SERVE_MIX = {"x56": 56, "x24": 24}
SERVE_NEAR = 1.02
SERVE_SHED = 8
SERVE_DRILL = 8
SERVE_DESIGN = (64, 4)
SERVE_MC = 128
SERVE_SPOOL = (8, 8)
# monthly windows a served case has (the 2017 year)
SERVE_MONTHS = 12
# the 16-case request against a solo solve of the same cases on the
# card, and the drill's replay against an undisturbed answer
SERVE_RTOL = 1e-6
SERVE_SPOOL_TIMEOUT_S = 300
# the spool's portfolio.json: sites of two weekly windows (phase 12's
# shape), the export cap 500 kW a site under the uncoupled peak
SERVE_PORTFOLIO_SITES = 4
# phase 11 (the fleet): two replicas on the card; the monthly request
# (cases with the daily-cycle rows, banded kernel) and the weekly one
# (also with the daily-cycle rows: a dense structure of its own, so no
# replica holds warm-start entries of the portfolio's sites, whose
# weekly windows have none, before phase 12 shards over them); the
# same-structure request's energy factor; the drill's request (a
# structure of its own: the monthly cases over six months) and the
# further request after the respawn; the armed replica's environment
FLEET_REPLICAS = ("r0", "r1")
FLEET_DEVICE = "cuda:0"
FLEET_MONTHLY, FLEET_WEEKLY = 16, 8
FLEET_NEAR_SCALE = 1.01
FLEET_DELTA_MONTH = 3
FLEET_DRILL_MONTHS, FLEET_DRILL_SCALE = 6, 0.98
FLEET_AFTER, FLEET_AFTER_SCALE = 8, 0.97
FLEET_DRILL_ENV = {"DERVET_TPU_FAULT_DEVICE_LOSS": "sticky"}
FLEET_BEAT_S, FLEET_HEARTBEAT_S = 0.25, 60.0
FLEET_TIMEOUT_S = 600
# phase 12 (the portfolio): the JAX package's scale shape
# (``bench.py`` ``portfolio_scale_leg``, ``BENCH_r08.json``
# ``portfolio_scale``): 64 sites x 336 hours in weekly windows, gap 1e-3,
# at most 40 outer rounds; 8 sites against HiGHS on the monolithic LP;
# 16 sites in 2 shards over phase 11's fleet
PORTFOLIO_SITES, PORTFOLIO_EXACT_SITES, PORTFOLIO_FLEET_SITES = 64, 8, 16
PORTFOLIO_HOURS, PORTFOLIO_WINDOW = 336, 168
PORTFOLIO_SITE_WINDOWS = 2
PORTFOLIO_GAP, PORTFOLIO_MAX_OUTER = 1e-3, 40
PORTFOLIO_SHARDS = 2
# phase 13 (parallel): the first PARALLEL_CASES of phase 3's cases
# through the elastic scheduler with one worker, then two workers on
# cuda:0 (the device seam) with the straggler drill on slot 1, whose
# sleep must outlast the other worker's group so that its queued group
# is stolen; the sharded scenario axis on the main 31-day structure at an
# odd batch and the weekly structure; the time-sharded 5-minute year
# window at world 1 (NCCL) and a 5-minute month at world 2 (gloo, both
# ranks on the one card), against HiGHS and the unsharded card solve.
# The elastic runs take 64 of the 128 cases: the whole smoke with 128
# took 1,069.7 s of its 1,200 s on the H100
PARALLEL_DEVICE = "cuda:0"
PARALLEL_CASES = 64
PARALLEL_CSV_EVERY = 8
PARALLEL_STRAGGLER_S = 12.0
SHARD_BATCHES = {744: 895, 168: 415}
SHARD_RTOL, SHARD_ATOL = 1e-5, 1e-4
TS_YEAR = {"dt": 1 / 12, "n": "year"}
TS_MONTH = {"dt": 1 / 12, "n": "month"}
TS_HIGHS_RTOL = 2e-3
TS_OBJ_RTOL, TS_X_RTOL = 5e-4, 5e-3
TS_TIMEOUT_S = 600
# the widths phase 13 launches at, which phase 2 holds against the plain
# version too: the elastic runs' groups (phase 3's months at
# PARALLEL_CASES; they compact to the bucket grid) and each shard of the
# split batches
SHARDS = 2
PARALLEL_PAIRS = {744: (7 * PARALLEL_CASES, -(-SHARD_BATCHES[744] // SHARDS)),
                  720: (4 * PARALLEL_CASES,), 672: (PARALLEL_CASES,),
                  168: (-(-SHARD_BATCHES[168] // SHARDS),)}


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


def ptxas_report(build_log):
    """One record per compiled kernel instance from ptxas's ``-v``
    report: kernel name, template arguments (variant, threads, columns
    and rows a thread), registers, stack frame and spill bytes."""
    import re
    recs, cur = {}, None
    for line in build_log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\S+?)'?$", line.strip())
        if m:
            cur = None
            k = re.search(r"(banded|dense)_chunk_kernelI((?:Li-?\d+E)+)E",
                          m.group(1))
            if k:
                cur = recs.setdefault(m.group(1), {
                    "kernel": f"{k.group(1)}_chunk_kernel",
                    "template": [int(v) for v in
                                 re.findall(r"Li(-?\d+)E", k.group(2))],
                    "registers": None, "stack": 0, "spill_stores": 0,
                    "spill_loads": 0})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (
                int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return sorted(recs.values(), key=lambda r: (r["kernel"], r["template"]))


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


def run_shapes(kind):
    """[(name, lp, batch, structure key)]: one window LP per structure
    group of run ``kind`` (``RUNS``), with the group's batch (months of
    that structure x cases) and its key (``MicrogridScenario.
    _structure_key``): the shapes its solve gives the kernels."""
    from dervet_tpu_torch import benchlib
    from dervet_tpu_torch.scenario.scenario import MicrogridScenario
    n_cases, kw = RUNS[kind]
    lps = benchlib.window_lps(benchlib.synthetic_case(**kw))
    groups = {}
    for month, lp in enumerate(lps, start=1):
        groups.setdefault(MicrogridScenario._structure_key(lp),
                          []).append((month, lp))
    return [(f"{kind} months {[m for m, _ in g]}", g[0][1], len(g) * n_cases,
             key) for key, g in groups.items()]


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


def chunk_launcher(solver, inputs, variant):
    """A no-argument call of one kernel chunk on ``inputs`` (timing)."""
    from dervet_tpu_torch.ops import fused_chunk as fc
    t, omega, x, y, xs, ys, k, ax, ay = inputs

    def launch():
        fc.batched_chunk(solver.op, t.c_s, t.q_s, t.l_s, t.u_s, omega,
                         solver.eta, x, y, xs, ys, solver.lp.n_eq,
                         CHUNK_ITERS, variant, ALPHA[variant], k, ax, ay)
    return launch


def rel_gap(a, ref) -> float:
    """max |a - ref| / (1 + max |ref|), in float64."""
    a, ref = a.double(), ref.double()
    return ((a - ref).abs().max() / (1.0 + ref.abs().max())).item()


def bound(op, B, m, n, variant, needed):
    """(bound ms, bound_by, bytes, operations) of one launch, K counted
    as the function needs it or as the kernel stores and computes it."""
    from dervet_tpu_torch.ops import fused_chunk as fc
    k_bytes, k_macs = fc.matrix_work(op, needed=needed)
    nbytes, ops = fc.chunk_cost(B, m, n, CHUNK_ITERS, k_bytes, k_macs,
                                variant)
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


def device_ms(fn, reps, name=None, attempts=3):
    """Mean device time of one launch of the kernel whose name contains
    ``name`` over ``reps`` calls of ``fn``, from torch.profiler's CUDA
    activity (the kernel alone, without the wrapper's host work, which
    a stream timer also counts when the kernel is shorter than it); with
    ``name`` None, the device time of every kernel and copy a call of
    ``fn`` runs.  A profile that records nothing is taken again, up to
    ``attempts`` times (one in a few dozen profiles of a long run came
    back empty on the H100); None when none records device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for evt in prof.key_averages():
            if name is None or name in evt.key:
                dev_us = getattr(evt, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(evt, "self_cuda_time_total", 0.0)
                total += dev_us
                count += evt.count
        if name is None:
            count = reps
        if count and total:
            return total / count / 1e3
    return None


def kernel_phase():
    """Returns ({kernel name: record} for the kernels JSON line,
    {kernel name: set of (m, n) checked}, {structure key of a phase 6 or
    7 group: what phase 2 found for that structure})."""
    import torch
    from dervet_tpu_torch.ops import fused_chunk as fc
    from dervet_tpu_torch.ops.pdhg import (BandedOp, CompiledLPSolver,
                                           PDHGOptions)
    from dervet_tpu_torch import benchlib
    monthly, weekly = window_lps("month", 1), window_lps(168, 0)
    # (name, lp, the path's batch, timed for the kernels line): the groups
    # the main path runs (31-, 30- and 28-day months x MAIN_CASES) and the
    # weekly run's (52 weeks and the 24-hour remainder x WEEKLY_CASES),
    # then five shapes neither runs, for coverage: the monthly op with
    # all-equality rows (no wide pair), the weekly op with mixed
    # equality/inequality rows, the ICE + CHP monthly window (the
    # largest register configuration), and two the shared-state
    # configuration takes: the DA + FR monthly window (ten bands) and a
    # dense block (every entry of K non-zero)
    shapes = [
        ("banded 31d", monthly[744], 7 * MAIN_CASES, True),
        ("banded 30d", monthly[720], 4 * MAIN_CASES, False),
        ("banded 28d", monthly[672], MAIN_CASES, False),
        ("dense 7d", weekly[168], 52 * WEEKLY_CASES, True),
        ("dense 24h", weekly[24], WEEKLY_CASES, False),
        ("banded all-eq", window_lps("month", 0)[744], 7 * MAIN_CASES,
         False),
        ("dense mixed", window_lps(168, 1)[168], 52 * WEEKLY_CASES, False),
        ("banded ICE+CHP", benchlib.multi_der_window_lp(), MAIN_CASES,
         False),
        ("banded DA+FR", benchlib.fr_window_lp(), MAIN_CASES, False),
        ("dense block", benchlib.dense_block_lp(), MAIN_CASES, False),
    ]
    shapes = [(*s, None) for s in shapes]
    # every structure group of phases 6 and 7 at its batch
    shapes += [(name, lp, b, False, key) for kind in RUNS
               for name, lp, b, key in run_shapes(kind)]
    records, checked, failures = {}, {k: set() for k in fc.KERNELS}, []
    found = {}
    for name, lp, b_main, timed, structure in shapes:
        solver = CompiledLPSolver(lp, PDHGOptions(), device="cuda")
        op = solver.op
        kname = fc.kernel_for(op)
        banded = isinstance(op, BandedOp)
        part = op.compact
        offsets = op.offsets if banded else ()
        nnz = fc.matrix_work(op, needed=True)[1] // 2
        per_col = torch.diff(part.col_ptr)
        config = fc.config_for(lp.m, lp.n, offsets, part, fc.REFLECTED)
        log(f"[kernels] {name}: m={lp.m} n={lp.n} n_eq={lp.n_eq} "
            f"{kname} nnz(K)={nnz} config={config} "
            f"compact rows={part.indptr.shape[0] - 1} "
            f"entries={part.nnz} most a column="
            f"{int(per_col.max()) if per_col.numel() else 0}"
            + (f" nb={len(op.offsets)}" if banded else ""))
        check(fc.supports(op, fc.REFLECTED), f"{name}: kernel declines")
        checked[kname].add((lp.m, lp.n))
        worst_abs, worst_rel, worst_rand = 0.0, 0.0, (0.0, 0.0)
        for variant in fc.VARIANTS:
            alpha = ALPHA[variant]
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
                worst_rel = max(worst_rel, rel_err)
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
        launch = chunk_launcher(solver, inputs, variant)
        # the kernel's own device time; a stream timer around the call
        # also counts the wrapper's host work, which exceeds a short
        # kernel's time
        call_ms = time_ms(launch, 20)
        ms = device_ms(launch, 20, kname)
        check(ms is not None, f"{name}: the profiler recorded no device "
                              f"time for {kname}")
        plain_ms = time_ms(lambda: plain_chunk(solver, inputs, variant,
                                               ALPHA[variant], torch.float32),
                           3)
        need = bound(op, b_main, lp.m, lp.n, variant, needed=True)
        stored = bound(op, b_main, lp.m, lp.n, variant, needed=False)
        log(f"[kernels] {name} timing B={b_main} {variant} x{CHUNK_ITERS}: "
            f"kernel {ms:.4f} ms (device; {call_ms:.4f} ms a call), plain "
            f"{plain_ms:.4f} ms; bound of the "
            f"work needed {need[0]:.4f} ms by {need[1]} ({need[2]} B, "
            f"{need[3]} fp32 ops); bound as computed {stored[0]:.4f} ms by "
            f"{stored[1]} ({stored[2]} B, {stored[3]} fp32 ops)")
        if structure is not None:
            found[structure] = {"structure": name, "op": type(op).__name__,
                                "config": config, "ms": ms,
                                "bound_ms": need[0], "B": b_main}
        rec = records.setdefault(kname, {
            "name": kname, "route": "cuda",
            "source": "dervet_tpu_torch/ops/csrc/fused_chunk.cu",
            "replaces": ("dervet_tpu/ops/pallas_chunk.py:246"
                         if kname == fc.KERNEL_BANDED
                         else "dervet_tpu/ops/pallas_chunk.py:105"),
            "launches": 0, "max_abs_err": 0.0, "max_rel_err": 0.0,
            "random_state_gap": {"kernel": 0.0, "plain_f32_runs": 0.0}})
        rec["max_abs_err"] = max(rec["max_abs_err"], worst_abs)
        rec["max_rel_err"] = max(rec["max_rel_err"], worst_rel)
        rs = rec["random_state_gap"]
        rs["kernel"] = max(rs["kernel"], worst_rand[0])
        rs["plain_f32_runs"] = max(rs["plain_f32_runs"], worst_rand[1])
        if timed:
            rec.update({
                "ms": ms, "call_ms": call_ms,
                "plain_ms": plain_ms, "bound_ms": need[0],
                "bound_by": need[1], "library_ms": None,
                "bound_as_computed_ms": stored[0],
                "bound_as_computed_by": stored[1],
                "shape": {"m": lp.m, "n": lp.n, "B": b_main, "nnz": nnz,
                          "iters": CHUNK_ITERS, "variant": variant}})
    if failures:
        raise AssertionError("kernel disagrees with its plain version: "
                             + "; ".join(failures))
    return records, checked, found


def seeded_inputs(solver, B, seed):
    """Chunk inputs as a refinement round's first launch meets them: the
    batch (per-instance price noise, as ``chunk_inputs``) solved at the
    loosest screening tier, then its answers taken as the warm-start
    seeds of the next tier (``init_state(x0=, y0=)``: seeds scaled,
    clipped into the box, the restart anchors; running sums and inner
    counts zero), which is what ``solve_group`` hands the solver from
    the solution memory."""
    import numpy as np
    import torch
    from dervet_tpu_torch.design import screening_options
    lp, dev = solver.lp, solver.device
    rng = np.random.default_rng(seed)
    mult = rng.lognormal(0.0, 0.15, (B, lp.n))
    C_np = np.where(lp.c != 0, mult * lp.c, 0.0)
    res = solver.with_options(screening_options(solver.opts, 0)).solve(
        c=C_np)
    C = torch.as_tensor(C_np, dtype=torch.float32, device=dev)
    Q, L, U = (torch.as_tensor(np.broadcast_to(a, (B, a.shape[0])).copy(),
                               dtype=torch.float32, device=dev)
               for a in (lp.q, lp.l, lp.u))
    sv = solver._solver
    st = sv.init_state(solver.op, C, Q, L, U, solver.dr, solver.dc,
                       x0=res.x, y0=res.y)
    t = sv._context(C, Q, L, U, solver.dr, solver.dc)
    return (t, st.omega, st.x, st.y, st.x_sum, st.y_sum, st.inner,
            st.x_restart, st.y_restart)


def pair_phase(records):
    """Phase 2, continued: the banded kernel against its plain version at
    every (structure, batch) pair the design and Monte-Carlo phases can
    launch (the three monthly structures of the main case at each batch
    of ``GRID_BATCHES``), three step variants each, from the solver's
    mid-solve state and, up to ``SEEDED_MAX_BATCH``, from a refinement
    round's seeded start; then each pair's device time a launch beside
    its bound, and the widest groups' real batches timed too (the
    padding's cost); then the dense kernel at the pairs phases 10-12
    launch (``DENSE_PAIRS``, ``DAILY_DENSE_PAIRS``, the warm-up LP), from
    the mid-solve state; both kernels also at the widths phase 13
    launches (``PARALLEL_PAIRS``).  Returns {(m, n, B): record}."""
    import torch
    from dervet_tpu_torch.ops import fused_chunk as fc
    from dervet_tpu_torch.ops.pdhg import CompiledLPSolver, PDHGOptions
    monthly = window_lps("month", 1)
    pairs, failures = {}, []
    rec = records[fc.KERNEL_BANDED]
    for T, days in ((744, 31), (720, 30), (672, 28)):
        lp = monthly[T]
        solver = CompiledLPSolver(lp, PDHGOptions(), device="cuda")
        check(fc.kernel_for(solver.op) == fc.KERNEL_BANDED,
              f"{days}-day window is not banded")
        for B in dict.fromkeys(GRID_BATCHES + REAL_BATCHES[T]
                               + PARALLEL_PAIRS[T]):
            starts = [("mid-solve", chunk_inputs(solver, B, seed=B))]
            if B <= SEEDED_MAX_BATCH:
                starts.append(("seeded", seeded_inputs(solver, B, B + 1)))
            worst = 0.0
            for start, inputs in starts:
                for variant in fc.VARIANTS:
                    alpha = ALPHA[variant]
                    kern = kernel_chunk(solver, inputs, variant, alpha)
                    plain = plain_chunk(solver, inputs, variant, alpha,
                                        torch.float32)
                    abs_err = max((a - b).abs().max().item()
                                  for a, b in zip(kern, plain))
                    rel_err = max(rel_gap(a, b) for a, b in zip(kern, plain))
                    finite = all(torch.isfinite(a).all().item()
                                 for a in kern)
                    if not finite or rel_err > KERNEL_RTOL:
                        failures.append(f"{days}d B={B} {start} {variant}: "
                                        f"rel {rel_err:.3e}")
                    worst = max(worst, rel_err)
                    rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
                    rec["max_rel_err"] = max(rec["max_rel_err"], rel_err)
            inputs = starts[0][1]
            launch = chunk_launcher(solver, inputs, fc.REFLECTED)
            ms, timer = device_ms(launch, 10, fc.KERNEL_BANDED), "device"
            if ms is None:
                # the call on the stream (the kernel plus the wrapper's
                # host work) where the profiler records nothing
                ms, timer = time_ms(launch, 10), "CUDA events, a call"
            plain_ms = time_ms(lambda: plain_chunk(
                solver, inputs, fc.REFLECTED, ALPHA[fc.REFLECTED],
                torch.float32), 2)
            need = bound(solver.op, B, lp.m, lp.n, fc.REFLECTED, needed=True)
            log(f"[pairs] {days}d {lp.m}x{lp.n} B={B}: "
                f"{' + '.join(st for st, _ in starts)} x {len(fc.VARIANTS)} "
                f"variants max_rel={worst:.3e}; kernel {ms:.4f} ms ({timer}), "
                f"plain {plain_ms:.4f} ms, bound {need[0]:.4f} ms by "
                f"{need[1]}")
            pairs[(lp.m, lp.n, B)] = {
                "structure": f"{days}d", "op": solver.op, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": need[0], "timer": timer,
                "seeded": B <= SEEDED_MAX_BATCH,
                "grid": B in GRID_BATCHES, "solver": solver}
    from dervet_tpu_torch.device import _warmup_lp
    weekly = window_lps(168, 0)
    dense = [(f"weekly {T}h", weekly[T],
              DENSE_PAIRS[T] + PARALLEL_PAIRS.get(T, ()))
             for T in DENSE_PAIRS]
    daily = window_lps(168, 1)
    dense += [(f"weekly {T}h, daily-cycle rows", daily[T],
               DAILY_DENSE_PAIRS[T]) for T in DAILY_DENSE_PAIRS]
    dense.append(("warm-up", _warmup_lp(), (WARMUP_BATCH,)))
    rec = records[fc.KERNEL_DENSE]
    for name, lp, batches in dense:
        solver = CompiledLPSolver(lp, PDHGOptions(), device="cuda")
        check(fc.kernel_for(solver.op) == fc.KERNEL_DENSE,
              f"{name} is not dense")
        for B in batches:
            inputs = chunk_inputs(solver, B, seed=B)
            worst = 0.0
            for variant in fc.VARIANTS:
                alpha = ALPHA[variant]
                kern = kernel_chunk(solver, inputs, variant, alpha)
                plain = plain_chunk(solver, inputs, variant, alpha,
                                    torch.float32)
                abs_err = max((a - b).abs().max().item()
                              for a, b in zip(kern, plain))
                rel_err = max(rel_gap(a, b) for a, b in zip(kern, plain))
                if not all(torch.isfinite(a).all().item() for a in kern) \
                        or rel_err > KERNEL_RTOL:
                    failures.append(f"{name} B={B} {variant}: rel "
                                    f"{rel_err:.3e}")
                worst = max(worst, rel_err)
                rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
                rec["max_rel_err"] = max(rec["max_rel_err"], rel_err)
            launch = chunk_launcher(solver, inputs, fc.REFLECTED)
            ms, timer = device_ms(launch, 10, fc.KERNEL_DENSE), "device"
            if ms is None:
                ms, timer = time_ms(launch, 10), "CUDA events, a call"
            plain_ms = time_ms(lambda: plain_chunk(
                solver, inputs, fc.REFLECTED, ALPHA[fc.REFLECTED],
                torch.float32), 2)
            need = bound(solver.op, B, lp.m, lp.n, fc.REFLECTED, needed=True)
            log(f"[pairs] {name} {lp.m}x{lp.n} B={B}: mid-solve x "
                f"{len(fc.VARIANTS)} variants max_rel={worst:.3e}; kernel "
                f"{ms:.4f} ms ({timer}), plain {plain_ms:.4f} ms, bound "
                f"{need[0]:.4f} ms by {need[1]}")
            pairs[(lp.m, lp.n, B)] = {
                "structure": name, "op": solver.op, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": need[0], "timer": timer,
                "seeded": False, "grid": True, "solver": solver}
    if failures:
        raise AssertionError("kernel disagrees with its plain version at "
                             "a phase 8-13 pair: "
                             + "; ".join(failures))
    return pairs


def time_kernels(root, reps=20):
    """``--time``: each kernel's device time and call time a launch at
    its main shape, for the package under ``root``; one JSON line."""
    sys.path.insert(0, root)
    from dervet_tpu_torch.ops import fused_chunk as fc
    from dervet_tpu_torch.ops.pdhg import CompiledLPSolver, PDHGOptions
    check(fc.__file__.startswith(root), f"imported {fc.__file__}")
    fc.build()
    rec = {"card": card_line(), "root": root, "iters": CHUNK_ITERS,
           "kernel_ms": {}, "call_ms": {}}
    for kname, scheme, daily, T, B in (
            (fc.KERNEL_BANDED, "month", 1, 744, 7 * MAIN_CASES),
            (fc.KERNEL_DENSE, 168, 0, 168, 52 * WEEKLY_CASES)):
        lp = window_lps(scheme, daily)[T]
        solver = CompiledLPSolver(lp, PDHGOptions(), device="cuda")
        launch = chunk_launcher(solver, chunk_inputs(solver, B, seed=7),
                                fc.REFLECTED)
        key = f"{kname} {lp.m}x{lp.n} B={B}"
        ms = device_ms(launch, reps, kname)
        check(ms is not None, f"the profiler recorded no time for {kname}")
        rec["kernel_ms"][key] = ms
        rec["call_ms"][key] = time_ms(launch, reps)
    print(json.dumps(rec), flush=True)
    return 0


# ---------------------------------------------------------------------------
# phases 3-5: the product path
# ---------------------------------------------------------------------------

def solve_cases(cases, backend, solver_opts=None):
    from dervet_tpu_torch.api import DERVET
    t0 = time.perf_counter()
    res = DERVET.from_cases(cases).solve(backend=backend,
                                         solver_opts=solver_opts)
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
    for name, n in launches.items():
        records[name].setdefault("launches_by_run", {})["main"] = n
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
    for name, n in launches_w.items():
        records[name].setdefault("launches_by_run", {})["dense"] = n

    # 5. cross-check against exact HiGHS on the first 4 cases
    check_against_highs(benchlib.synthetic_sensitivity_cases(
        MAIN_CASES, daily_cycle_limit=1)[:4], torch_obj, "check")
    return res


def check_against_highs(ref_cases, torch_obj, what):
    """``ref_cases`` on exact HiGHS: each window's objective within
    OBJ_RTOL of the card's (``torch_obj``: case key -> objectives)."""
    res_c, wall_c = solve_cases(ref_cases, "cpu")
    worst = 0.0
    for k, inst in res_c.instances.items():
        ref = inst.objective_values["Total Objective"]
        got = torch_obj[k].loc[ref.index]
        rel = ((got - ref).abs() / ref.abs().clip(lower=1.0)).max()
        worst = max(worst, float(rel))
    log(f"[{what}] {len(ref_cases)} cases x 12 windows vs HiGHS "
        f"({wall_c:.2f} s): max per-window objective rel {worst:.3e} "
        f"(limit {OBJ_RTOL})")
    check(worst < OBJ_RTOL, f"{what}: objective rel {worst} vs HiGHS")


def walk_phase(res, calls, what):
    """The outage walks of the microgrid run: every call ran on the card
    (``calls``: (name, device type, thread) recorded during the run), and
    for the first 4 cases the stream's own walks — the load-coverage walk,
    the load-coverage frame, the min-SOE schedule and, with
    ``min_soe_exact``, the exact recursion's — equal what the same
    stream computes with its device set to the CPU; then each walk's
    device time at the run's size."""
    import numpy as np
    import torch
    devices = sorted({d for _, d, _ in calls})
    threads = sorted({t.split("_")[0] for _, _, t in calls})
    log(f"[{what}] outage walks: {len(calls)} calls on {devices} from "
        f"threads {threads}")
    check(calls and devices == ["cuda"],
          f"{what}: outage walks ran on {devices}")
    check(any(t.startswith("dervet-post") for t in threads),
          f"{what}: no walk ran from the post-processing pool")

    def walk_gap(a, b):
        """max |a - b| / max(|b|, 1) over the finite entries of ``b``,
        which must be where ``a``'s are."""
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        fin = np.isfinite(b)
        check(np.array_equal(fin, np.isfinite(a)), "inf in other places")
        if not fin.any():
            return 0.0
        return float((np.abs(a[fin] - b[fin])
                      / np.maximum(np.abs(b[fin]), 1.0)).max())

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    worst = {"coverage_diff": 0, "soe": 0.0, "min_soe": 0.0,
             "min_soe_exact": 0.0}
    timing = {}
    for key in sorted(res.instances)[:4]:
        inst = res.instances[key]
        s, ts = inst.scenario, inst.time_series_data
        rel = s.streams["Reliability"]
        check(rel.device == cuda, f"{what}: case {key} walked on "
                                  f"{rel.device}")
        mix = rel._der_mix(s.ders)
        L = int(np.round(rel.max_outage_duration / rel.dt))
        init = ts["Aggregated State of Energy (kWh)"].to_numpy()
        card_lcp = inst.drill_down_dict["load_coverage_prob"]
        card_soe = rel.min_soe_df["soe"].to_numpy()
        saved = (rel.min_soe_df, rel.soe_profiles, rel.outage_soe_profile,
                 rel.min_soe_exact)

        def schedule(exact):
            rel.min_soe_exact = exact
            return rel.min_soe_schedule(s.ders, s.index)["soe"].to_numpy()

        walks = {
            f"LCPC walk L={L}": lambda: rel._walk(mix, init, L),
            f"min-SOE schedule L={rel.coverage_steps}":
                lambda: schedule(False),
            f"exact min-SOE schedule L={rel.coverage_steps}":
                lambda: schedule(True)}
        lcpc, walk, exact = walks.values()

        def on(dev, fn):
            rel.device = dev
            try:
                return fn()
            finally:
                rel.device = cuda

        try:
            (cov_d, prof_d), (cov_h, prof_h) = (on(d, lcpc)
                                                for d in (cuda, cpu))
            diff = int((cov_d != cov_h).sum())
            check(diff == 0, f"{what}: case {key}: coverage differs at "
                             f"{diff} starts")
            worst["coverage_diff"] = max(worst["coverage_diff"], diff)
            worst["soe"] = max(worst["soe"], walk_gap(prof_d, prof_h))
            check(on(cpu, lambda: rel.load_coverage_probability(
                s.ders, ts)).equals(card_lcp),
                f"{what}: case {key}: load coverage differs on CPU")
            worst["min_soe"] = max(worst["min_soe"],
                                   walk_gap(card_soe, on(cpu, walk)))
            worst["min_soe_exact"] = max(worst["min_soe_exact"], walk_gap(
                *(on(d, exact) for d in (cuda, cpu))))
            if not timing:
                # device time of each walk at the run's size (T = 8760
                # starts); the call time counts the copy to the host
                for name, fn in walks.items():
                    dev_ms = device_ms(fn, 10)
                    check(dev_ms is not None, f"the profiler recorded no "
                                              f"device time for the {name}")
                    t0 = time.perf_counter()
                    for _ in range(10):
                        fn()
                    timing[name] = {"device_ms": dev_ms, "call_ms": (
                        time.perf_counter() - t0) * 100}
        finally:
            (rel.min_soe_df, rel.soe_profiles, rel.outage_soe_profile,
             rel.min_soe_exact) = saved
    log(f"[{what}] walks on the card vs on the CPU, 4 cases: {worst} (limit "
        f"{WALK_RTOL} relative)")
    check(max(worst["soe"], worst["min_soe"], worst["min_soe_exact"])
          <= WALK_RTOL, f"{what}: walks differ on the card: {worst}")
    log(f"[{what}] walk times a call, T={len(init)} starts: "
        f"{json.dumps(timing)}")


def run_phase(kind, records, checked, found):
    """Phases 6 and 7: ``RUNS[kind]`` through ``DERVET.solve`` on the
    card with the solver's CPU straggler rescue off, its checks, and the
    first 4 cases on exact HiGHS."""
    from dervet_tpu_torch import benchlib
    from dervet_tpu_torch.models.streams import reliability as relmod
    from dervet_tpu_torch.ops import fused_chunk as fc
    from dervet_tpu_torch.ops.pdhg import PDHGOptions
    from dervet_tpu_torch.scenario import scenario as scen
    n_cases, kw = RUNS[kind]
    kernel = fc.KERNEL_BANDED if kind == "microgrid" else fc.KERNEL_DENSE
    cases = benchlib.synthetic_sensitivity_cases(n_cases, **kw)
    # record where every outage walk of the run computes, and from which
    # thread (the dispatch thread before the solves, the post pool after)
    walk, calls = relmod.simulate_all_outages, []

    def recorded_walk(*a, **k):
        out = walk(*a, **k)
        calls.append(("walk", out[0].device.type,
                      threading.current_thread().name))
        return out

    # tag each group's ledger entries with its structure as phase 2 named
    # it (groups of one shape may differ in structure)
    resolve = scen.resolve_group

    def tagged_resolve(items, *a, ledger_tags=None, **k):
        key = scen.MicrogridScenario._structure_key(items[0][2])
        name = found[key]["structure"] if key in found else "unchecked"
        return resolve(items, *a, ledger_tags={**(ledger_tags or {}),
                                               "structure": name}, **k)

    relmod.simulate_all_outages = recorded_walk
    scen.resolve_group = tagged_resolve
    try:
        fc.reset_launch_counts()
        # no CPU work inside the solve: the straggler rescue, which hands
        # the last few unconverged instances to HiGHS, is off
        res, wall = solve_cases(cases, "torch",
                                PDHGOptions(cpu_rescue_after=None))
        launches = dict(fc.LAUNCHES)
    finally:
        relmod.simulate_all_outages = walk
        scen.resolve_group = resolve
    log(f"[{kind}] {n_cases} cases x 12 months: {wall:.2f} s wall, "
        f"launches {launches}")
    check_certified(res, n_cases * 12, kind)
    check_ledger(res, kernel, checked[kernel], kind)
    rescued = res.solve_ledger["totals"].get("cpu_rescued", 0)
    check(rescued == 0, f"{kind}: {rescued} instances solved on the CPU")
    check(launches[kernel] > 0, f"{kind}: {kernel} never launched")
    for name, n in launches.items():
        records[name].setdefault("launches_by_run", {})[kind] = n
    names = {f["structure"]: f for f in found.values()}
    for g in res.solve_ledger["groups"]:
        if g.get("backend") == "torch":
            check(g.get("structure") in names, f"{kind}: group m={g['m']} "
                  f"n={g['n']} has a structure phase 2 did not check")
            log(f"[{kind}]   group {g['structure']} ({g.get('rung')}) B="
                f"{g['batch']} launches={g['kernel_launches']}: "
                f"{json.dumps(names[g['structure']])}")
    if kind == "microgrid":
        walk_phase(res, calls, kind)
    torch_obj = {k: inst.objective_values["Total Objective"]
                 for k, inst in res.instances.items()}
    for k, obj in torch_obj.items():
        check(obj.notna().all() and len(obj) == 12, f"case {k}: {obj}")
    check_against_highs(
        benchlib.synthetic_sensitivity_cases(n_cases, **kw)[:4], torch_obj,
        f"{kind} check")


# ---------------------------------------------------------------------------
# phases 8-9: the design screen, the sizing sweep and Monte-Carlo
# ---------------------------------------------------------------------------

class DispatchLog:
    """While open, records every ``run_dispatch`` the design and
    Monte-Carlo engines make: its scenarios, wall time, the host time
    before it since the previous one ended (case and scenario building:
    the entry point's prep), its LP assembly and solve seconds, and the
    dispatch's solve ledger.  ``times()`` splits the entry point's wall
    into prep_s / dispatch_s / post_s."""
    MODULES = ("dervet_tpu_torch.design.screen",
               "dervet_tpu_torch.design.frontier",
               "dervet_tpu_torch.stochastic.engine")

    def __init__(self, extra=()):
        # more modules whose ``run_dispatch`` to record (the service's
        # batch round: ``dervet_tpu_torch.service.batcher``)
        self.modules = self.MODULES + tuple(extra)

    def __enter__(self):
        import importlib
        self.calls, self._saved = [], []
        for name in self.modules:
            mod = importlib.import_module(name)
            self._saved.append((mod, mod.run_dispatch))
            mod.run_dispatch = self._wrap(mod.run_dispatch)
        self.t_last = time.perf_counter()
        self.t_start = self.t_last
        return self

    def _wrap(self, real):
        def run_dispatch(scenarios, *a, **k):
            t0 = time.perf_counter()
            try:
                return real(scenarios, *a, **k)
            finally:
                t1 = time.perf_counter()
                meta = scenarios[0].solve_metadata if scenarios else {}
                self.calls.append({
                    "scenarios": len(scenarios), "gap_s": t0 - self.t_last,
                    "wall_s": t1 - t0,
                    "assembly_s": meta.get("dispatch_assembly_s"),
                    "solve_s": meta.get("dispatch_solve_s"),
                    "ledger": meta.get("solve_ledger")})
                self.t_last = t1
        return run_dispatch

    def __exit__(self, *exc):
        for mod, real in self._saved:
            mod.run_dispatch = real
        self.t_end = time.perf_counter()

    def times(self):
        return {"wall_s": round(self.t_end - self.t_start, 3),
                "prep_s": round(sum(c["gap_s"] for c in self.calls), 3),
                "dispatch_s": round(sum(c["wall_s"] for c in self.calls), 3),
                "post_s": round(self.t_end - self.t_last, 3)}


def check_pairs(call, pairs, what):
    """Every device group of one logged dispatch ran the banded kernel
    with no fallback at a (structure, batch) pair phase 2 checked, batch
    being the width it launched at (``padded_to``, else its members).
    Logs each group's real and padded batch, its launches, iterations
    and warm-start split, and the kernel's device ms a launch at the
    padded batch beside the bound of its real instances."""
    from dervet_tpu_torch import benchlib
    from dervet_tpu_torch.ops import fused_chunk as fc
    led = benchlib.validate_solve_ledger(call["ledger"])
    dev_groups = [g for g in led["groups"] if g.get("backend") == "torch"]
    check(dev_groups, f"{what}: no device groups in the ledger")
    for g in dev_groups:
        pad = g.get("padded_to", g["batch"])
        key = (g["m"], g["n"], pad)
        check(g["kernel"] == fc.KERNEL_BANDED and "kernel_fallback" not in g,
              f"{what}: group m={g['m']} n={g['n']} ran {g['kernel']} "
              f"({g.get('kernel_fallback')})")
        check(key in pairs, f"{what}: group {key} (m, n, batch) is a pair "
                            "phase 2 did not check")
        p = pairs[key]
        warm = g.get("warm") or {}
        split = {k: warm.get(k) for k in (
            "seeded", "cold", "substituted", "iters_p50_seeded",
            "iters_p50_cold")}
        real = g["batch"] - int(warm.get("substituted") or 0)
        real_bound = (bound(p["op"], real, g["m"], g["n"], fc.REFLECTED,
                            needed=True)[0] if real else 0.0)
        log(f"[{what}]   group {p['structure']} ({g.get('rung')}) batch "
            f"{g['batch']} padded to {pad} (device members {real}): "
            f"launches={g['kernel_launches']} iters p50/p99/max="
            f"{g['iters_p50']}/{g['iters_p99']}/{g['iters_max']} "
            f"solve_s={g['solve_s']} warm={json.dumps(split)}; "
            f"kernel {p['ms']:.4f} ms a launch at B={pad}, bound of the "
            f"{real} real instances {real_bound:.4f} ms")
    return led


def check_no_ladder(call, what):
    """A screening dispatch accepts what its hard budget reached
    (``inaccurate_factor`` 1e6): no group may climb the escalation
    ladder."""
    rungs = sorted({str(g.get("rung")) for g in call["ledger"]["groups"]})
    check(set(rungs) <= {"None", "initial"},
          f"{what}: screening groups climbed the ladder ({rungs})")


def log_dispatch(call, what):
    led = call["ledger"] or {}
    totals = led.get("totals") or {}
    log(f"[{what}] {call['scenarios']} scenarios: dispatch "
        f"{call['wall_s']:.3f} s (LP assembly {call['assembly_s']} s, "
        f"solve {call['solve_s']} s), {call['gap_s']:.3f} s of host work "
        f"before it; windows {totals.get('windows')}, launches "
        f"{(led.get('kernel') or {}).get('launches')}, iters "
        f"{json.dumps(led.get('iters'))}, warm start "
        f"{json.dumps(led.get('warm_start'))}, cpu_rescued "
        f"{totals.get('cpu_rescued')}")


def design_phase(records, pairs):
    """Phase 8: ``run_design`` at the JAX package's defaults on the main
    case, the finalists on exact HiGHS, a cold control of the finalists,
    then ``sizing_sweep`` on a 4 x 4 grid."""
    import numpy as np
    import torch
    from dervet_tpu_torch import benchlib, design, sizing
    from dervet_tpu_torch.design import frontier as dfrontier
    from dervet_tpu_torch.design.screen import ScreenedCandidate, \
        score_scenario
    from dervet_tpu_torch.ops import fused_chunk as fc
    from dervet_tpu_torch.ops.pdhg import PDHGOptions
    from dervet_tpu_torch.scenario.scenario import (MicrogridScenario,
                                                    SolverCache)
    case = benchlib.synthetic_case(n="month", daily_cycle_limit=1)
    n_win = len(MicrogridScenario(case).windows)
    spec = design.DesignSpec(
        bounds={("Battery", "1"): design.DERBounds(**DESIGN_BOUNDS)},
        population=DESIGN_POPULATION, top_k=DESIGN_TOP_K, refine_rounds=1)
    # the certified tier with no CPU work inside the solve (phases 6-7)
    opts = PDHGOptions(cpu_rescue_after=None)
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    with DispatchLog() as dl:
        front = design.run_design(case, spec, backend="torch",
                                  solver_opts=opts)
    launches = dict(fc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"[design] run_design {DESIGN_POPULATION} candidates, top "
        f"{DESIGN_TOP_K}: {json.dumps(dl.times())}, launches {launches}, "
        f"peak device memory {peak / 2 ** 30:.3f} GiB, screen "
        f"{front.screen['screen_s']} s at {front.screen['candidates_per_s']} "
        f"candidates/s, rank_correlation {front.rank_correlation}")
    check(launches[fc.KERNEL_BANDED] > 0, "design: banded kernel never "
                                          "launched")
    records[fc.KERNEL_BANDED].setdefault("launches_by_run", {})[
        "design"] = launches[fc.KERNEL_BANDED]
    check(len(dl.calls) == 3, f"design: {len(dl.calls)} dispatches, "
                              "expected round 0, round 1, finalists")
    labels = ("round 0", "round 1", "finalists")
    for label, call, rnd in zip(labels, dl.calls,
                                front.screen["rounds"] + [None]):
        led = check_pairs(call, pairs, f"design {label}")
        log_dispatch(call, f"design {label}")
        if rnd is not None:
            check_no_ladder(call, f"design {label}")
            # the ledger counts real members only: padding duplicates are
            # trimmed before scoring
            check(led["totals"]["windows"] == rnd["candidates"] * n_win,
                  f"design {label}: {led['totals']['windows']} windows for "
                  f"{rnd['candidates']} candidates")
            log(f"[design] {label}: {rnd['candidates']} candidates in "
                f"{rnd['round_s']} s ({rnd['candidates'] / rnd['round_s']:.1f}"
                f" candidates/s), eps_rel {rnd['eps_rel']}, budget "
                f"{rnd['max_iters']}, windows seeded {rnd['seeded']} cold "
                f"{rnd['cold']}")
            # the refinement round seeds every survivor from round 0
            check(rnd["round"] == 0 or rnd["seeded"] == rnd["windows"],
                  f"design {label}: {rnd['seeded']} of {rnd['windows']} "
                  "windows seeded")
    check(front.screen["certification_stamped"] is False,
          "design: a screening answer carries a certificate")
    f = front.frontier
    check(len(f) == DESIGN_TOP_K and front.all_finalists_certified,
          f"design: finalists certified {list(f['certified'])}")
    fin_led = dl.calls[2]["ledger"]
    check(fin_led["totals"]["cpu_rescued"] == 0,
          f"design: {fin_led['totals']['cpu_rescued']} finalist instances "
          "solved on the CPU")
    # seeded finalists against a cold solve of the same finalists
    pop = {c.index: c for c in design.generate_population(spec)}
    finalists = [ScreenedCandidate(candidate=pop[int(i)])
                 for i in f["candidate"]]
    with DispatchLog() as cold:
        # padded as the finalists' round is, but with no solution memory
        design.certify_finalists(
            case, finalists, backend="torch", solver_opts=opts,
            solver_cache=SolverCache(pad_grid=True, device="cuda"))
    check_pairs(cold.calls[0], pairs, "design cold finalists")
    seeded_p50 = (fin_led.get("warm_start") or {}).get("iters_p50_seeded")
    cold_p50 = cold.calls[0]["ledger"]["iters"]["p50"]
    log(f"[design] finalists: seeded iterations p50 {seeded_p50} against "
        f"{cold_p50} cold (the same finalists, no solution memory)")
    check(seeded_p50 is not None and seeded_p50 < cold_p50,
          f"design: seeded finalists p50 {seeded_p50} not below cold "
          f"{cold_p50}")
    # the finalists on exact HiGHS
    t0 = time.perf_counter()
    host = design.certify_finalists(case, finalists, backend="cpu")
    ops = np.array([score_scenario(host[int(i)]) for i in f["candidate"]])
    rel = np.abs(f["operating_value"].to_numpy() - ops) / np.maximum(
        np.abs(ops), 1.0)
    totals = ops + f["capex"].to_numpy()
    win = int(np.argmin(totals))
    tie = abs(totals[win] - totals[0]) / max(abs(totals[win]), 1.0)
    log(f"[design] finalists vs HiGHS ({time.perf_counter() - t0:.2f} s): "
        f"max operating-value rel {rel.max():.3e} (limit {OBJ_RTOL}); "
        f"HiGHS winner candidate {int(f['candidate'].iloc[win])}, card's "
        f"{int(f['candidate'].iloc[0])} (total gap {tie:.2e})")
    check(rel.max() < OBJ_RTOL, f"design: finalists rel {rel.max()} vs "
                                "HiGHS")
    check(win == 0 or tie <= TIE_RTOL, "design: HiGHS picks another winner")

    # the legacy sizing sweep: a 4 x 4 grid at full fidelity
    captured, real = {}, dfrontier.run_design

    def capture(*a, **k):
        captured["frontier"] = real(*a, **k)
        return captured["frontier"]

    dfrontier.run_design = capture
    fc.reset_launch_counts()
    try:
        with DispatchLog() as sweep_log:
            surface = sizing.sizing_sweep(case, *SIZING_GRID,
                                          solver_opts=opts)
    finally:
        dfrontier.run_design = real
    log(f"[design] sizing_sweep 4 x 4: {json.dumps(sweep_log.times())}, "
        f"launches {dict(fc.LAUNCHES)}")
    for i, call in enumerate(sweep_log.calls):
        check_pairs(call, pairs, f"sizing dispatch {i}")
    check(len(surface) == 16 and surface.converged.all(),
          f"sizing: {len(surface)} rows, converged {list(surface.converged)}")
    best = surface.loc[surface.total.idxmin()]
    w = captured["frontier"].winner
    gap = abs(float(w["total"]) - float(best["total"])) / max(
        abs(float(best["total"])), 1.0)
    log(f"[design] sizing surface argmin {best['kW']:.0f} kW / "
        f"{best['kWh']:.0f} kWh (total {best['total']:.2f}); certified "
        f"top-1 {w['kW']:.0f} kW / {w['kWh']:.0f} kWh (total "
        f"{w['total']:.2f}, certified {w['certified']})")
    check(bool(w["certified"]), "sizing: top-1 not certified")
    check((float(w["kW"]), float(w["kWh"])) == (float(best["kW"]),
                                                float(best["kWh"]))
          or gap <= TIE_RTOL, "sizing: certified top-1 is not the "
                              "surface argmin")


def montecarlo_phase(records, pairs):
    """Phase 9: ``run_montecarlo`` with 1,024 samples on the main case,
    the pinned samples on exact HiGHS, the statistics recomputed, then
    256 samples in both orders on fresh caches, and the replay and
    reversed replay of the first of them on its caches."""
    import numpy as np
    import torch
    from dervet_tpu_torch import benchlib, design, stochastic
    from dervet_tpu_torch.design.screen import score_scenario
    from dervet_tpu_torch.ops import fused_chunk as fc
    from dervet_tpu_torch.ops.pdhg import PDHGOptions
    from dervet_tpu_torch.scenario.scenario import (MicrogridScenario,
                                                    SolverCache, run_dispatch)
    from dervet_tpu_torch.stochastic.engine import build_sample_scenarios
    case = benchlib.synthetic_case(n="month", daily_cycle_limit=1)
    n_win = len(MicrogridScenario(case).windows)
    spec = stochastic.MCSpec(n_samples=MC_SAMPLES, seed=0)
    opts = PDHGOptions(cpu_rescue_after=None)

    def caches():
        c = design.ScreeningCaches(device="cuda")
        return c, SolverCache(pad_grid=True, memory=c.memory, device="cuda")

    shared, final = caches()
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    with DispatchLog() as dl:
        r1 = stochastic.run_montecarlo(case, spec, backend="torch",
                                       solver_opts=opts, caches=shared,
                                       final_cache=final)
    launches = dict(fc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    engine = {k: r1.engine[k] for k in (
        "screen_s", "certify_s", "total_s", "samples_per_s_screening",
        "samples_per_s_certified")}
    log(f"[montecarlo] {MC_SAMPLES} samples: {json.dumps(dl.times())}, "
        f"engine {json.dumps(engine)}, "
        f"launches {launches}, peak device memory {peak / 2 ** 30:.3f} GiB, "
        f"tier mix {r1.tier_mix}")
    check(launches[fc.KERNEL_BANDED] > 0,
          "montecarlo: banded kernel never launched")
    records[fc.KERNEL_BANDED].setdefault("launches_by_run", {})[
        "montecarlo"] = launches[fc.KERNEL_BANDED]
    check([r["tier"] for r in r1.engine["rounds"]] == ["screening",
                                                       "certified"]
          and len(dl.calls) == 2,
          f"montecarlo: rounds {r1.engine['rounds']}")
    for label, call in zip(("screening", "certified"), dl.calls):
        check_pairs(call, pairs, f"montecarlo {label}")
        log_dispatch(call, f"montecarlo {label}")
    check_no_ladder(dl.calls[0], "montecarlo screening")
    check(dl.calls[0]["ledger"]["totals"]["windows"] == MC_SAMPLES * n_win,
          "montecarlo: padding duplicates counted as windows")
    check(not r1.engine["certification_stamped_screening"],
          "montecarlo: a screening answer carries a certificate")
    check(r1.pinning_all_certified and r1.tier_mix["quarantined"] == 0,
          f"montecarlo: pinned samples not all certified ({r1.tier_mix})")
    check(dl.calls[1]["ledger"]["totals"]["cpu_rescued"] == 0,
          "montecarlo: pinned instances solved on the CPU")
    # the published statistics from the published samples alone
    v = np.array([row["objective"] for row in r1.as_dict()["samples"]])
    s = np.sort(v)
    k = int(np.ceil(round((1.0 - spec.alpha) * v.size, 12)))
    want = {"mean": v.mean(), "cvar_alpha": s[-k:].mean(),
            "var_alpha": np.quantile(v, spec.alpha),
            **{f"p{100 * q:g}": np.quantile(v, q) for q in spec.quantiles}}
    got = {**{k: r1.stats[k] for k in ("mean", "cvar_alpha", "var_alpha")},
           **r1.stats["quantiles"]}
    stat_rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    log(f"[montecarlo] stats {json.dumps(got)}; recomputed from the "
        f"published samples: max rel {stat_rel:.2e}")
    check(stat_rel <= 1e-9, f"montecarlo: statistics recompute {stat_rel}")
    # the pinned samples on exact HiGHS
    pinned = [int(i) for i in r1.samples.loc[
        r1.samples["tier"] == "certified", "sample"]]
    t0 = time.perf_counter()
    host = build_sample_scenarios(case, spec, pinned)
    run_dispatch(host, backend="cpu")
    ref = np.array([score_scenario(h) for h in host])
    rel = np.abs(v[pinned] - ref) / np.maximum(np.abs(ref), 1.0)
    log(f"[montecarlo] {len(pinned)} pinned samples vs HiGHS "
        f"({time.perf_counter() - t0:.2f} s): max rel {rel.max():.3e} "
        f"(limit {OBJ_RTOL})")
    check(rel.max() < OBJ_RTOL, f"montecarlo: pinned rel {rel.max()}")
    # order on fresh caches: kernel blocks are position-independent; are
    # the batched check windows?
    small = stochastic.MCSpec(n_samples=MC_ORDER_SAMPLES, seed=0)
    backwards = list(range(MC_ORDER_SAMPLES))[::-1]
    fresh = [caches(), caches()]
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    runs = [stochastic.run_montecarlo(
        case, small, backend="torch", solver_opts=opts, caches=c,
        final_cache=f, sample_order=order)
        for (c, f), order in zip(fresh, (None, backwards))]
    a, b = (r.samples for r in runs)
    diff = (np.abs(a["objective"] - b["objective"])
            / np.maximum(np.abs(b["objective"]), 1.0)).max()
    log(f"[montecarlo] {MC_ORDER_SAMPLES} samples in order and reversed on "
        f"fresh caches ({time.perf_counter() - t0:.2f} s, launches "
        f"{dict(fc.LAUNCHES)}): largest per-sample rel difference {diff:.3e}"
        f" ({'exactly 0' if diff == 0 else 'not 0'}), tiers equal "
        f"{list(a['tier']) == list(b['tier'])}")
    check(list(a["tier"]) == list(b["tier"]) and diff <= MC_ORDER_RTOL,
          f"montecarlo: order changes the answer by {diff}")
    # the replay contract: rerun and reversed order on the in-order run's
    # caches (its host LP assembly, not the card, is a replay's time: at
    # 1,024 samples the two took 204 s of a 1,198.6 s smoke)
    shared, final = fresh[0]
    fc.reset_launch_counts()
    with DispatchLog() as rl:
        r2 = stochastic.run_montecarlo(case, small, backend="torch",
                                       solver_opts=opts, caches=shared,
                                       final_cache=final)
        r3 = stochastic.run_montecarlo(
            case, small, backend="torch", solver_opts=opts, caches=shared,
            final_cache=final, sample_order=backwards)
    log(f"[montecarlo] replay + reversed replay of the {MC_ORDER_SAMPLES}: "
        f"{json.dumps(rl.times())}, launches {dict(fc.LAUNCHES)}; "
        "substituted windows "
        f"{[[r['substituted'] for r in x.engine['rounds']] for x in (r2, r3)]}"
        f" of {[[r['windows'] for r in x.engine['rounds']] for x in (r2, r3)]}"
        f"; memory {json.dumps(shared.memory.snapshot())}")
    check(runs[0].to_json() == r2.to_json() == r3.to_json(),
          "montecarlo: the replay is not byte-identical")


# ---------------------------------------------------------------------------
# phase 10: the scenario service
# ---------------------------------------------------------------------------

def served_cases(n_cases, scale=1.0, **kw):
    """{i: case}: ``synthetic_sensitivity_cases(n_cases)`` (monthly
    windows with the daily-cycle rows unless ``kw`` says otherwise), the
    battery's energy rating times ``scale``."""
    from dervet_tpu_torch import benchlib
    kw = {"daily_cycle_limit": 1, **kw}
    cases = benchlib.synthetic_sensitivity_cases(n_cases, **kw)
    for c in cases:
        for tag, _, keys in c.ders:
            if tag == "Battery" and scale != 1.0:
                keys["ene_max_rated"] = float(keys["ene_max_rated"]) * scale
    return dict(enumerate(cases))


class ServeRound:
    """One ``run_once`` of a service, driven on a thread of its own (not
    the thread that warmed the card, and not the service's batcher
    thread, which catches round errors): the launch counts set to 0
    just before and read just after, peak device memory, the round's
    ``run_dispatch`` calls (``DispatchLog``) and its wall split."""

    def __init__(self, svc, label):
        self.svc, self.label = svc, label

    def run(self):
        import torch
        from dervet_tpu_torch.ops import fused_chunk as fc
        out = {}

        def body():
            try:
                out["served"] = self.svc.run_once()
            except BaseException as e:     # re-raised on the caller
                out["error"] = e
        torch.cuda.reset_peak_memory_stats()
        fc.reset_launch_counts()
        with DispatchLog(extra=("dervet_tpu_torch.service.batcher",)) as dl:
            th = threading.Thread(target=body, name="serve-rounds")
            th.start()
            th.join()
        self.launches = dict(fc.LAUNCHES)
        self.peak = torch.cuda.max_memory_allocated()
        self.dl = dl
        if "error" in out:
            raise out["error"]
        self.served = out["served"]
        return self

    def report(self, ledger=None):
        """The round's line: wall split, latency p50/p99 so far, windows
        per device batch, launches by kernel, solver builds and hits,
        seeded and substituted windows, peak device memory."""
        m = self.svc.metrics()
        led = ledger if ledger is not None else (
            self.svc.last_round_ledger or {})
        initial = [g for g in led.get("groups", ())
                   if g.get("rung") in (None, "initial")
                   and g.get("backend") == "torch"]
        per_batch = (sum(g["batch"] for g in initial) / len(initial)
                     if initial else 0.0)
        warm = led.get("warm_start") or {}
        cc = m["compile_cache"]
        log(f"[serve] {self.label}: {json.dumps(self.dl.times())}, "
            f"latency p50/p99 {m['latency_s']['p50']}/"
            f"{m['latency_s']['p99']} s (n={m['latency_s']['n']}), windows "
            f"per device batch {per_batch:.1f} ({len(initial)} groups), "
            f"launches {self.launches}, solver builds {cc['solver_builds']} "
            f"hits {cc['solver_hits']}, seeded {warm.get('seeded', 0)} "
            f"substituted {warm.get('substituted', 0)}, compile events "
            f"{(led.get('totals') or {}).get('compile_events')}, peak "
            f"device memory {self.peak / 2 ** 30:.3f} GiB")


def check_ledger_groups(led, pairs, what):
    """A solve ledger (a served round's, a replica's request slice, a
    portfolio dispatch's): every device group that launched ran the
    chunk kernel its op takes, with no fallback, on cuda:0, at
    (structure, batch) pairs phase 2 checked — its launch width and
    every bucket it compacted to; none solved on the CPU.  Returns its
    launches by kernel."""
    from dervet_tpu_torch.ops import fused_chunk as fc
    launches = {}
    for g in led.get("groups", ()):
        if g.get("backend") != "torch" or not g.get("kernel_launches"):
            continue
        widths = [g.get("padded_to", g["batch"])] + [
            b for b, _ in g.get("bucket_occupancy") or ()]
        for B in widths:
            key = (g["m"], g["n"], B)
            check(key in pairs, f"{what}: group {key} (m, n, batch) is a "
                                "pair phase 2 did not check")
            check(g["kernel"] == fc.kernel_for(pairs[key]["op"])
                  and "kernel_fallback" not in g,
                  f"{what}: group m={g['m']} n={g['n']} ran {g['kernel']} "
                  f"({g.get('kernel_fallback')})")
        check(g["device"] == FLEET_DEVICE, f"{what}: group on {g['device']}")
        launches[g["kernel"]] = launches.get(g["kernel"], 0) \
            + g["kernel_launches"]
    totals = led.get("round_totals") or led.get("totals") or {}
    check((totals.get("cpu_rescued") or 0) == 0,
          f"{what}: {totals.get('cpu_rescued')} instances solved on the CPU")
    return launches


def check_served_groups(led, pairs, what, launched=True):
    """Every device group of a served round that launched a kernel ran
    the chunk kernel its op takes, with no fallback, on cuda:0, at
    (structure, batch) pairs phase 2 held against the plain version
    (``check_ledger_groups``).  ``launched``: the round must have
    launched."""
    from dervet_tpu_torch import benchlib
    led = benchlib.validate_solve_ledger(led)
    launches = check_ledger_groups(led, pairs, what)
    check(not launched or launches, f"{what}: no group launched a kernel")
    return led


def check_served_certified(res, what):
    """A served scenario answer: certified fidelity, every window
    certified by the float64 certificate, none on the CPU."""
    health = res.run_health
    cert = health["certification"]
    n_win = sum(len(i.scenario.windows) for i in res.instances.values())
    check(res.fidelity == "certified", f"{what}: fidelity {res.fidelity}")
    check(cert["enabled"] and cert["windows_certified"] == n_win
          and cert["windows"]["rejected_final"] == 0,
          f"{what}: {cert['windows']} of {n_win} windows certified")
    check(health["windows"]["cpu_fallback"] == 0,
          f"{what}: CPU-fallback windows {health['windows']}")
    check(not health["cases_quarantined"], health["quarantine_reasons"])
    return n_win


def objectives(res):
    return {k: inst.objective_values["Total Objective"]
            for k, inst in res.instances.items()}


def objective_gap(a, b):
    """(max per-window relative gap, bit-equal) of two answers."""
    import numpy as np
    oa, ob = objectives(a), objectives(b)
    check(sorted(oa) == sorted(ob), "answers hold different cases")
    worst, same = 0.0, True
    for k in oa:
        x, y = oa[k].to_numpy(), ob[k].loc[oa[k].index].to_numpy()
        worst = max(worst, float((np.abs(x - y)
                                  / np.maximum(np.abs(y), 1.0)).max()))
        same = same and x.tobytes() == y.tobytes()
    return worst, same


def new_service(opts, **kw):
    """A ScenarioService on the card (``device=None``), not started: the
    card is warmed as ``start`` warms it (``warmup_device``, recorded as
    its ``device_info``), and the phase drives its rounds itself, with no
    batcher thread to swallow a round's error."""
    from dervet_tpu_torch.device import warmup_device
    from dervet_tpu_torch.service import ScenarioService
    svc = ScenarioService(backend="torch", solver_opts=opts, max_wait_s=0.0,
                          **kw)
    svc.device_info = warmup_device(svc.device)
    return svc


def serve_phase(records, pairs):
    """Phase 10: the scenario service on the card.  A warm service
    (``device=None`` -> cuda:0) serves a coalesced round of four requests
    (monthly and weekly), a second mix, an exact repeat, a near request,
    a design and a Monte-Carlo request and their repeats; fresh services
    give the near request's cold control, the shed storm and the
    backend-loss drill; then ``python -m dervet_tpu_torch serve SPOOL
    --once`` serves two pickled payloads and refuses a portfolio."""
    import os
    import pickle
    import shutil
    import tempfile

    import torch
    from dervet_tpu_torch import design, stochastic
    from dervet_tpu_torch.api import DERVET
    from dervet_tpu_torch.ops import fused_chunk as fc
    from dervet_tpu_torch.ops.pdhg import PDHGOptions
    from dervet_tpu_torch.utils import faultinject
    # the certified tier with no CPU work inside the solve (phases 6-9)
    opts = PDHGOptions(cpu_rescue_after=None)
    total = {k: 0 for k in fc.KERNELS}

    def count(rnd):
        for k, n in rnd.launches.items():
            total[k] += n

    # 1. start: the warm-up on this thread, nvcc's library already built
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    svc = new_service(opts)
    warm = dict(fc.LAUNCHES)
    info = svc.device_info
    log(f"[serve] start: {info} in {time.perf_counter() - t0:.3f} s, "
        f"warm-up launches {warm}, device {svc.device}")
    check(info["platform"] == "gpu" and info["n_devices"] == 1
          and info["device_kind"] == torch.cuda.get_device_name(0)
          and str(svc.device) == "cuda:0", f"serve: device {info}")
    from dervet_tpu_torch.device import _warmup_lp
    wlp = _warmup_lp()
    check(warm[fc.KERNEL_DENSE] > 0
          and (wlp.m, wlp.n, WARMUP_BATCH) in pairs,
          f"serve: the warm-up launched {warm}")
    for k, n in warm.items():
        total[k] += n

    # 2. the coalesced round: four requests, one run_once
    reqs = {rid: served_cases(n) for rid, n in SERVE_ROUND.items()}
    reqs["wk8"] = served_cases(SERVE_WEEKLY, n=168, daily_cycle_limit=0)
    futs = {rid: svc.submit(c, request_id=rid) for rid, c in reqs.items()}
    rnd = ServeRound(svc, "coalesced round").run()
    count(rnd)
    check(rnd.served == len(reqs), f"serve: round served {rnd.served}")
    res = {rid: f.result(0) for rid, f in futs.items()}
    led = check_served_groups(svc.last_round_ledger, pairs, "serve round")
    rnd.report()
    n_win = {rid: check_served_certified(r, f"serve {rid}")
             for rid, r in res.items()}
    cross = [g for g in led["groups"] if len(g.get("requests") or ()) > 1]
    check(cross, "serve: no cross-request group")
    rec = svc.metrics()["resilience"]["backend_recovery"]
    check(rec["losses"] == 0 and rec["rounds_lost"] == 0, f"serve: {rec}")
    check(rnd.launches[fc.KERNEL_BANDED] > 0
          and rnd.launches[fc.KERNEL_DENSE] > 0,
          f"serve: round launches {rnd.launches}")
    log(f"[serve] round: {sum(n_win.values())} windows, "
        f"{len(cross)} cross-request groups")
    for g in led["groups"]:
        pad = g.get("padded_to", g["batch"])
        p = pairs.get((g["m"], g["n"], pad))
        # the padding: duplicates of the last member ride every launch
        # at the padded width until the solver compacts
        extra = ""
        if pad != g["batch"] and p is not None:
            real = device_ms(chunk_launcher(p["solver"], chunk_inputs(
                p["solver"], g["batch"], seed=11), fc.REFLECTED), 10,
                g["kernel"])
            if real is not None:
                extra = (f"; kernel {p['ms']:.4f} ms a launch at {pad} "
                         f"against {real:.4f} ms at {g['batch']}: at most "
                         f"{(p['ms'] - real) * g['kernel_launches']:.1f} ms "
                         "of the group's kernel time is padding")
        log(f"[serve]   group {p['structure'] if p else '?'} m={g['m']} "
            f"n={g['n']} batch {g['batch']} padded to {pad} "
            f"({100 * (pad - g['batch']) / pad:.0f}% duplicates), requests "
            f"{g.get('requests')}, launches {g['kernel_launches']}, iters "
            f"p50/max {g['iters_p50']}/{g['iters_max']}, compactions "
            f"{g.get('bucket_occupancy')}, solve_s {g['solve_s']}{extra}")
    # the smallest request against a solo solve of its cases on the card
    small = min(SERVE_ROUND, key=SERVE_ROUND.get)
    n_small = SERVE_ROUND[small]
    t0 = time.perf_counter()
    solo = DERVET.from_cases(list(served_cases(n_small).values())).solve(
        backend="torch", solver_opts=opts)
    gap, same = objective_gap(res[small], solo)
    log(f"[serve] {small} against a solo solve of its cases on the card "
        f"({time.perf_counter() - t0:.2f} s): max per-window objective rel "
        f"{gap:.3e} (limit {SERVE_RTOL}), bit-equal {same}")
    check(res[small].run_health["windows"] == solo.run_health["windows"],
          "serve: statuses differ from the solo solve")
    check(gap <= SERVE_RTOL, f"serve: {small} vs solo {gap}")
    check_against_highs(list(served_cases(n_small).values())[:4],
                        objectives(res[small]), "serve")

    # 3. a second mix: the same buckets, nothing built
    builds, hits = svc.solver_cache.builds, svc.solver_cache.hits
    futs = {rid: svc.submit(served_cases(n), request_id=rid)
            for rid, n in SERVE_MIX.items()}
    rnd = ServeRound(svc, "second mix").run()
    count(rnd)
    for rid, f in futs.items():
        check_served_certified(f.result(0), f"serve {rid}")
    led = check_served_groups(svc.last_round_ledger, pairs, "serve mix")
    rnd.report()
    check(svc.solver_cache.builds == builds
          and svc.solver_cache.hits > hits,
          f"serve mix: builds {builds} -> {svc.solver_cache.builds}, "
          f"hits {hits} -> {svc.solver_cache.hits}")
    # compile_events (a program's first run at a batch width on a
    # solver) is logged, not gated: a new width builds nothing in the
    # port — the kernels take any batch — and the mix's groups compact
    # through widths its convergence picks
    log(f"[serve] second mix: {led['totals']['compile_events']} first "
        "runs of a program at a new width")

    # 4. the exact repeat: every window from the memory, no launch
    f = svc.submit(served_cases(n_small), request_id="repeat")
    rnd = ServeRound(svc, "exact repeat").run()
    count(rnd)
    rep = f.result(0)
    warm = svc.last_round_ledger["warm_start"]
    rnd.report()
    check(warm["substituted"] == n_win[small]
          and sum(rnd.launches.values()) == 0,
          f"serve repeat: substituted {warm['substituted']} of "
          f"{n_win[small]}, launches {rnd.launches}")
    gap, same = objective_gap(rep, res[small])
    check(same, f"serve repeat: not byte-identical (gap {gap})")

    # 5. a near request, seeded, against the same cases cold
    f = svc.submit(served_cases(n_small, SERVE_NEAR), request_id="near")
    rnd = ServeRound(svc, "near request").run()
    count(rnd)
    check_served_certified(f.result(0), "serve near")
    led = check_served_groups(svc.last_round_ledger, pairs, "serve near")
    rnd.report()
    warm = led["warm_start"]
    cold_svc = new_service(opts)
    f = cold_svc.submit(served_cases(n_small, SERVE_NEAR),
                        request_id="near-cold")
    crnd = ServeRound(cold_svc, "near request cold (fresh service)").run()
    count(crnd)
    check_served_certified(f.result(0), "serve near cold")
    cled = check_served_groups(cold_svc.last_round_ledger, pairs,
                               "serve near cold")
    crnd.report()
    log(f"[serve] near request: {warm['seeded']} of {n_win[small]} windows "
        f"seeded (exact {warm['exact']}, near {warm['near']}, predicted "
        f"{warm['predicted']}), iterations p50 {warm['iters_p50_seeded']} "
        f"seeded against {cled['iters']['p50']} cold")
    check(warm["seeded"] > 0, "serve near: no window seeded")
    cold_svc.close()

    # 6. the shed storm: a queue of 4, three priority-0 requests
    shed_svc = new_service(opts, max_queue_depth=4, max_batch_requests=4,
                           shed_sustain_rounds=1)
    futs = {f"s{i}": shed_svc.submit(
        served_cases(SERVE_SHED, 1.0 + 0.01 * (i + 1)), request_id=f"s{i}",
        priority=int(i == 3)) for i in range(4)}
    rnd = ServeRound(shed_svc, "shed storm").run()
    count(rnd)
    check(rnd.served == 4, f"serve shed: served {rnd.served}")
    rnd.report()
    for rid, f in futs.items():
        r = f.result(0)
        if rid == "s3":
            check_served_certified(r, "serve shed priority 1")
            check_served_groups(shed_svc.last_round_ledger, pairs,
                                "serve shed priority 1")
            continue
        cert = r.run_health["certification"]
        check(r.fidelity == "degraded" and not cert["enabled"]
              and cert["windows_certified"] == 0,
              f"serve shed {rid}: {r.fidelity} {cert}")
        sl = r.solve_ledger
        check(any(g.get("kernel_launches") for g in sl["groups"]),
              f"serve shed {rid}: no launch")
        for g in sl["groups"]:
            B = g.get("padded_to", g["batch"])
            check((g["m"], g["n"], B) in pairs
                  and g["device"] == "cuda:0" and "kernel_fallback" not in g,
                  f"serve shed {rid}: group {g['m']}x{g['n']} B={B} "
                  f"{g['kernel']} on {g['device']}")
    shed = shed_svc.metrics()["resilience"]["load_shedding"]
    log(f"[serve] shed storm: {shed}")
    check(shed["degraded_requests"] == 3, f"serve shed: {shed}")
    shed_svc.close()

    # 7. the backend-loss drill against an undisturbed answer
    calm = new_service(opts)
    f = calm.submit(served_cases(SERVE_DRILL, 0.97), request_id="calm")
    crnd = ServeRound(calm, "drill control (fresh service)").run()
    count(crnd)
    want = f.result(0)
    calm.close()
    drill = new_service(opts)
    with faultinject.inject(device_loss=True, device_loss_n=1) as plan:
        f = drill.submit(served_cases(SERVE_DRILL, 0.97), request_id="drill")
        rnd = ServeRound(drill, "backend-loss drill").run()
    count(rnd)
    got = f.result(0)
    rnd.report()
    rec = drill.metrics()["resilience"]["backend_recovery"]
    fired = [k for k, _ in plan.fired].count(faultinject.EVENT_DEVICE_LOSS)
    gap, same = objective_gap(got, want)
    log(f"[serve] drill: {fired} injected loss, recovery {rec}; replay "
        f"against the undisturbed answer: max rel {gap:.3e} (limit "
        f"{SERVE_RTOL}), bit-equal {same}")
    check(fired == 1 and rec["losses"] == 1 and rec["reinits"] == 1
          and rec["rounds_lost"] == 0, f"serve drill: {rec}")
    check_served_certified(got, "serve drill")
    check_served_groups(drill.last_round_ledger, pairs, "serve drill")
    check(gap <= SERVE_RTOL, f"serve drill: replay gap {gap}")
    drill.close()

    # 8. design and Monte-Carlo requests on the warm service, repeated
    from dervet_tpu_torch import benchlib
    case = benchlib.synthetic_case(n="month", daily_cycle_limit=1)
    pop, top = SERVE_DESIGN
    spec = design.DesignSpec(
        bounds={("Battery", "1"): design.DERBounds(**DESIGN_BOUNDS)},
        population=pop, top_k=top, refine_rounds=1)
    mc = stochastic.MCSpec(n_samples=SERVE_MC, seed=0)
    answers = {}
    for rep_i in range(2):
        before = (svc.solver_cache.builds,
                  svc.design_caches.snapshot()["builds"])
        f = svc.submit_design(case, spec, request_id=f"design{rep_i}")
        rnd = ServeRound(svc, f"design request {rep_i}").run()
        count(rnd)
        front = f.result(0)
        for call in rnd.dl.calls:
            check_served_groups(call["ledger"], pairs,
                                f"serve design {rep_i}", launched=False)
        rnd.report()
        check(front.fidelity == "certified" and front.all_finalists_certified
              and len(front.frontier) == top,
              f"serve design: {front.frontier[['candidate', 'certified']]}")
        check(front.screen["certification_stamped"] is False,
              "serve design: a screening answer is certificate-stamped")
        f = svc.submit_montecarlo(case, mc, request_id=f"mc{rep_i}")
        rnd = ServeRound(svc, f"Monte-Carlo request {rep_i}").run()
        count(rnd)
        dist = f.result(0)
        for call in rnd.dl.calls:
            check_served_groups(call["ledger"], pairs,
                                f"serve montecarlo {rep_i}", launched=False)
        rnd.report(ledger=rnd.dl.calls[-1]["ledger"])
        check(dist.fidelity == "certified" and dist.pinning_all_certified
              and dist.tier_mix["quarantined"] == 0,
              f"serve montecarlo: {dist.tier_mix}")
        after = (svc.solver_cache.builds,
                 svc.design_caches.snapshot()["builds"])
        log(f"[serve] design + Monte-Carlo {rep_i}: winner candidate "
            f"{int(front.frontier['candidate'].iloc[0])}, tier mix "
            f"{dist.tier_mix}, solver builds (certified, screening) "
            f"{before} -> {after}")
        if rep_i:
            check(after == before, f"serve repeat: builds {before} -> "
                                   f"{after}")
            check(list(front.frontier["candidate"]) == list(
                answers["design"].frontier["candidate"]),
                "serve design repeat: other finalists")
            check(dist.samples["objective"].to_numpy().tobytes()
                  == answers["mc"].samples["objective"].to_numpy().tobytes(),
                  "serve montecarlo repeat: not byte-identical")
        answers = {"design": front, "mc": dist}
    m = svc.metrics()
    check(m["resilience"]["backend_recovery"]["rounds_lost"] == 0
          and m["requests"]["failed"] == 0, f"serve: {m['requests']}")
    log(f"[serve] warm service: requests {m['requests']}, rounds "
        f"{m['rounds']}, latency {m['latency_s']}")
    svc.close()

    # 9. the spool: ``serve SPOOL --once`` in a process of its own
    root = tempfile.mkdtemp(prefix="serve-spool-")
    try:
        spool = os.path.join(root, "spool")
        incoming = os.path.join(spool, "incoming")
        os.makedirs(incoming)
        rids = {}
        for i, n in enumerate(SERVE_SPOOL):
            rid = f"spool{i}"
            rids[rid] = n
            with open(os.path.join(incoming, f"{rid}.pkl"), "wb") as fh:
                pickle.dump({"cases": served_cases(n, 1.0 + 0.05 * (i + 1)),
                             "priority": 0}, fh)
        from dervet_tpu_torch.portfolio import PortfolioSpec, \
            solve_portfolio
        from dervet_tpu_torch.portfolio.service import \
            synthetic_portfolio_members
        shape = {"sites": SERVE_PORTFOLIO_SITES, "hours": PORTFOLIO_HOURS,
                 "window": PORTFOLIO_WINDOW}
        probe = solve_portfolio(PortfolioSpec(
            members=synthetic_portfolio_members(
                SERVE_PORTFOLIO_SITES, hours=PORTFOLIO_HOURS,
                window=PORTFOLIO_WINDOW),
            export_cap_kw=1e9, max_outer=1), backend="cpu")
        with open(os.path.join(incoming, "folio.json"), "w") as fh:
            json.dump({"portfolio": {
                "synthetic_members": shape,
                "export_cap_kw": float(
                    probe.aggregate["net_export"].max())
                - 500.0 * SERVE_PORTFOLIO_SITES,
                "gap_tol": PORTFOLIO_GAP,
                "max_outer": PORTFOLIO_MAX_OUTER}}, fh)
        here = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dervet_tpu_torch", "serve", spool,
             "--once"], cwd=here, capture_output=True, text=True,
            timeout=SERVE_SPOOL_TIMEOUT_S)
        wall = time.perf_counter() - t0
        tail = (proc.stdout + proc.stderr).strip().splitlines()[-6:]
        log(f"[serve] serve --once: exit {proc.returncode} in {wall:.2f} s; "
            + " | ".join(tail))
        check(proc.returncode == 0, f"serve --once exited "
                                    f"{proc.returncode}: {tail}")
        for rid, n in rids.items():
            out = os.path.join(spool, "results", rid)
            with open(os.path.join(out, f"run_health.{rid}.json")) as fh:
                health = json.load(fh)
            with open(os.path.join(out, f"solve_ledger.{rid}.json")) as fh:
                sl = json.load(fh)
            csvs = [p for p in os.listdir(out) if p.endswith(".csv")]
            cert = health["certification"]
            check(csvs and health["fidelity"] == "certified"
                  and cert["windows_certified"] == n * SERVE_MONTHS
                  and health["windows"]["cpu_fallback"] == 0,
                  f"serve spool {rid}: {cert['windows']}")
            for g in sl["groups"]:
                if g.get("kernel_launches"):
                    B = g.get("padded_to", g["batch"])
                    check((g["m"], g["n"], B) in pairs
                          and g["device"] == "cuda:0"
                          and "kernel_fallback" not in g,
                          f"serve spool {rid}: group {g['m']}x{g['n']} "
                          f"B={B} on {g['device']}")
            log(f"[serve] spool {rid}: {len(csvs)} CSVs, "
                f"{n * SERVE_MONTHS} windows "
                f"certified, launches {sum(g.get('kernel_launches', 0) for g in sl['groups'])}")
        with open(os.path.join(spool, "results", "folio",
                               "portfolio.json")) as fh:
            folio = json.load(fh)
        cert = folio["certification"]
        check(folio["converged"] and folio["fidelity"] == "certified"
              and cert["verdict"] in ("certified", "certified_loose")
              and cert["per_site"]["all_certified"]
              and cert["per_site"]["windows_total"]
              == SERVE_PORTFOLIO_SITES * PORTFOLIO_SITE_WINDOWS,
              f"serve spool portfolio: converged {folio['converged']}, "
              f"{cert['verdict']}, {cert['per_site']}")
        log(f"[serve] spool portfolio: {folio['outer_rounds']} rounds, gap "
            f"{folio['gap_rel']}, verdict {cert['verdict']}, "
            f"{cert['per_site']['windows_total']} windows certified")
        with open(os.path.join(spool, "service_metrics.json")) as fh:
            sm = json.load(fh)
        check(sm["requests"]["completed"] == 3
              and sm["portfolio"]["requests"] == 1
              and sm["service"]["device"]["platform"] == "gpu",
              f"serve spool metrics: {sm['requests']}")
        log(f"[serve] spool metrics: requests {sm['requests']}, latency "
            f"{sm['latency_s']}, device {sm['service']['device']}")
        st = subprocess.run(
            [sys.executable, "-m", "dervet_tpu_torch", "status", spool],
            cwd=here, capture_output=True, text=True, timeout=120)
        log(f"[serve] status: exit {st.returncode}; "
            + " | ".join(st.stdout.strip().splitlines()[-3:]))
        check(st.returncode == 0, f"status exited {st.returncode}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for k, n in total.items():
        records[k].setdefault("launches_by_run", {})["serve"] = n
    log(f"[serve] launches in this process {total}")
    check(all(total.values()), f"serve: a kernel never launched {total}")


# ---------------------------------------------------------------------------
# Phase 11: the fleet — replicas on cuda:0 behind the router
# ---------------------------------------------------------------------------

def mps_running() -> bool:
    """Is an MPS control daemon up?  Under MPS one client's fault can
    reach the others' contexts; without it each replica's context is
    its own."""
    try:
        out = subprocess.run(["pgrep", "-f", "nvidia-cuda-mps"],
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return False
    return bool(out.stdout.strip())


def replica_ledgers(spool):
    """{rid: solve ledger} of every answered request in a replica's
    spool (``results/<rid>/solve_ledger.<rid>.json``, or the ledger of a
    portfolio shard's pickled answer)."""
    import os
    from dervet_tpu_torch.portfolio.shard import load_shard_result
    out = {}
    root = os.path.join(spool, "results")
    for rid in sorted(os.listdir(root)) if os.path.isdir(root) else ():
        path = os.path.join(root, rid, f"solve_ledger.{rid}.json")
        if os.path.exists(path):
            with open(path) as fh:
                out[rid] = json.load(fh)
            continue
        shard = load_shard_result(os.path.join(root, rid))
        if shard is not None and shard.ledger is not None:
            out[rid] = shard.ledger
    return out


def replica_peak_memory(spool):
    """The replica's peak device memory (GiB) from the metrics its serve
    loop wrote when it drained, or None."""
    import os
    try:
        with open(os.path.join(spool, "service_metrics.json")) as fh:
            peak = json.load(fh)["service"].get("peak_memory_bytes")
    except (OSError, ValueError, KeyError):
        return None
    return None if peak is None else round(peak / 2 ** 30, 3)


def windows_of(cases):
    """The optimization windows of a request's cases (monthly, or
    fixed-length windows with a shorter remainder)."""
    total = 0
    for c in cases.values():
        idx = c.datasets.time_series.index
        n = c.scenario.get("n")
        if n == "month":
            total += len(set(zip(idx.year, idx.month)))
        else:
            total += -(-len(idx) // int(n))
    return total


def check_routed_certified(res, n_windows, what):
    """A fleet answer: its run-health slice certifies every window, none
    on the CPU."""
    health = res.load_run_health()
    check(health is not None, f"{what}: no run-health artifact")
    cert = health["certification"]
    check(health.get("fidelity", "certified") == "certified"
          and cert["enabled"] and cert["windows_certified"] == n_windows
          and cert["windows"]["rejected_final"] == 0
          and health["windows"]["cpu_fallback"] == 0,
          f"{what}: {cert['windows']} of {n_windows} windows certified, "
          f"cpu_fallback {health['windows']['cpu_fallback']}")


def csv_bytes(d):
    import os
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.endswith(".csv")}


class Fleet:
    """Phase 11's fleet: port replicas (``python -m dervet_tpu_torch
    serve SPOOL --backend torch --device cuda:0``, each a process with a
    CUDA context of its own on the one card) behind a ``FleetRouter``;
    phase 12 shards a portfolio over it."""

    def __init__(self, root):
        from dervet_tpu_torch.service import FleetRouter
        self.root, self.logs, self.handles = root, [], {}
        self.router = FleetRouter([], fleet_dir=f"{root}/fleet",
                                  heartbeat_timeout_s=FLEET_HEARTBEAT_S,
                                  breaker_opts={"cooldown_s": 1.0})
        self.supervisor = None

    def spool(self, name):
        return f"{self.root}/{name}"

    def spawn(self, name, epoch, env=None):
        """Spawn one replica and wait for its first heartbeat at this
        epoch; returns (handle, spawn-to-first-heartbeat seconds)."""
        from dervet_tpu_torch.service import spawn_replica
        lg = open(f"{self.root}/{name}.{epoch}.log", "w")
        self.logs.append(lg)
        t0 = time.perf_counter()
        h = spawn_replica(self.spool(name), name=name, backend="torch",
                          device=FLEET_DEVICE, epoch=epoch, env=env,
                          heartbeat_s=FLEET_BEAT_S, stdout=lg, stderr=lg)
        try:
            return h, self.wait_beat(name, epoch, h, t0)
        except BaseException:
            # not adopted yet, so the router's close would not stop it
            h.process.kill()
            h.process.wait()
            raise

    def wait_beat(self, name, epoch, h, t0):
        path = f"{self.spool(name)}/heartbeat.json"
        while True:
            check(h.process.poll() is None,
                  f"fleet: replica {name} exited {h.process.returncode} "
                  f"before its first heartbeat ({self.tail(name, epoch)})")
            try:
                with open(path) as fh:
                    if json.load(fh).get("epoch") == epoch:
                        return time.perf_counter() - t0
            except (OSError, ValueError):
                pass
            check(time.perf_counter() - t0 < FLEET_TIMEOUT_S,
                  f"fleet: replica {name} never beat")
            time.sleep(0.05)

    def tail(self, name, epoch, n=8):
        try:
            with open(f"{self.root}/{name}.{epoch}.log") as fh:
                return " | ".join(fh.read().strip().splitlines()[-n:])
        except OSError:
            return ""

    def routable(self, name):
        """The router has seen the replica beat, its breaker is closed
        and its published load is fresh (so least-loaded ranks it)."""
        m = self.router.metrics()["replicas"].get(name) or {}
        snap = self.router.load_snapshot().get(name) or {}
        return (m.get("state") == "up"
                and (m.get("breaker") or {}).get("state") == "closed"
                and snap.get("published") is not None)

    def wait_routable(self, names):
        t0 = time.perf_counter()
        while not all(self.routable(n) for n in names):
            check(time.perf_counter() - t0 < FLEET_TIMEOUT_S,
                  f"fleet: {names} never routable: "
                  f"{self.router.metrics()['replicas']}")
            time.sleep(0.05)

    def close(self):
        """Stop the supervisor, drain and stop every replica (SIGTERM),
        log each one's peak device memory from its metrics, and remove
        the spools."""
        import shutil
        if self.supervisor is not None:
            self.supervisor.stop()
        self.router.close()
        for lg in self.logs:
            lg.close()
        for name in FLEET_REPLICAS:
            log(f"[fleet] {name} (last epoch) drained: peak device memory "
                f"{replica_peak_memory(self.spool(name))} GiB")
        shutil.rmtree(self.root, ignore_errors=True)


def fleet_phase(records, pairs):
    """Phase 11: two port replicas share cuda:0 behind the fleet router.
    Two structures go to different replicas by affinity; an exact repeat
    is answered from the request cache (no replica, byte-identical
    artifacts); a delta re-solves only its edited month; then the sticky
    fault drill: one replica is replaced by one with a REAL device-side
    assert armed in its environment, dies of it on its first solve, its
    request is re-routed and answered once on the card by the survivor
    (certified, within 1e-6 of an undisturbed solve), and the supervisor
    respawns it (epoch + 1, warm import) to answer a further request.
    Returns the fleet, still up, for phase 12's sharded portfolio."""
    import os
    import tempfile

    import numpy as np
    from dervet_tpu_torch.ops import fused_chunk as fc
    from dervet_tpu_torch.service import FleetSupervisor, ReplicaSpec
    from dervet_tpu_torch.service.server import EXIT_BACKEND_LOST
    lib = fc.library_path()
    check(lib.exists(), "fleet: phase 1's kernel library is missing")
    built = sorted(p.name for p in lib.parent.glob("libfused_chunk-*.so"))
    check(not any(k.startswith("DERVET_TPU_FAULT") for k in os.environ),
          "fleet: a fault plan is armed in the smoke's own environment")
    log(f"[fleet] MPS {'running' if mps_running() else 'not running'}; "
        f"replicas load {lib.name}")
    fleet = Fleet(tempfile.mkdtemp(prefix="fleet-"))
    router = fleet.router.start()
    lat = []

    def ask(cases, rid, n_windows, what, **kw):
        fut = router.submit(cases, request_id=rid,
                            deadline_s=FLEET_TIMEOUT_S, **kw)
        res = fut.result(timeout=FLEET_TIMEOUT_S)
        if not res.cached:
            check_routed_certified(res, n_windows, what)
        lat.append((rid, res.replica, res.latency_s))
        log(f"[fleet] {what} ({rid}): replica {res.replica}, latency "
            f"{res.latency_s:.3f} s, recovered {res.recovered}, cached "
            f"{res.cached}")
        return res

    try:
        beats = {}
        for name in FLEET_REPLICAS:
            h, beats[(name, 1)] = fleet.spawn(name, 1)
            fleet.handles[name] = h
            router.adopt_replica(h)
        fleet.wait_routable(FLEET_REPLICAS)
        for (name, ep), s in beats.items():
            log(f"[fleet] {name} epoch {ep}: spawn to first heartbeat "
                f"{s:.2f} s")
        # 1. two structures by affinity (both kernels)
        monthly = served_cases(FLEET_MONTHLY)
        weekly = served_cases(FLEET_WEEKLY, n=168)
        n_m, n_w = windows_of(monthly), windows_of(weekly)
        fm = router.submit(monthly, request_id="fm0",
                           deadline_s=FLEET_TIMEOUT_S)
        fw = router.submit(weekly, request_id="fw0",
                           deadline_s=FLEET_TIMEOUT_S)
        rm, rw = (f.result(timeout=FLEET_TIMEOUT_S) for f in (fm, fw))
        check_routed_certified(rm, n_m, "fleet monthly")
        check_routed_certified(rw, n_w, "fleet weekly")
        for r in (rm, rw):
            lat.append((r.rid, r.replica, r.latency_s))
            log(f"[fleet] {r.rid}: replica {r.replica}, latency "
                f"{r.latency_s:.3f} s")
        check({rm.replica, rw.replica} == set(FLEET_REPLICAS),
              f"fleet: both structures on {rm.replica}/{rw.replica}")
        home = rm.replica
        near = ask(served_cases(FLEET_MONTHLY, FLEET_NEAR_SCALE), "fm1", n_m,
                   "same structure, new content")
        check(near.replica == home, f"fleet: affinity sent fm1 to "
                                    f"{near.replica}, not {home}")
        # 2. an exact repeat: the request cache, no replica, same bytes
        admitted = {n: len(replica_ledgers(fleet.spool(n)))
                    for n in FLEET_REPLICAS}
        rep = ask(served_cases(FLEET_MONTHLY), "fm2", n_m, "exact repeat")
        check(rep.cached and rep.replica == "request_cache",
              f"fleet: the repeat was not a cache hit ({rep.replica})")
        check(csv_bytes(rep.results_dir) == csv_bytes(rm.results_dir),
              "fleet: the cached answer's CSVs differ from the original")
        check({n: len(replica_ledgers(fleet.spool(n)))
               for n in FLEET_REPLICAS} == admitted,
              "fleet: the cache hit reached a replica")
        # 3. a delta: one month of one case changes
        edited = served_cases(FLEET_MONTHLY)
        ts = edited[0].datasets.time_series
        month = ts.index.month == FLEET_DELTA_MONTH
        col = ts.columns[0]
        ts.loc[month, col] = ts.loc[month, col] * 1.01
        fd = router.submit_delta(served_cases(FLEET_MONTHLY), edited,
                                 request_id="fd0",
                                 deadline_s=FLEET_TIMEOUT_S)
        rd = fd.result(timeout=FLEET_TIMEOUT_S)
        lat.append((rd.rid, rd.replica, rd.latency_s))
        check_routed_certified(rd, n_m, "fleet delta")
        led = replica_ledgers(fleet.spool(rd.replica))["fd0"]
        warm = [g.get("warm") or {} for g in led["groups"]]
        subst = sum(int(w.get("substituted") or 0) for w in warm)
        check(rd.replica == home and subst == n_m - 1,
              f"fleet delta: {subst} of {n_m} windows substituted on "
              f"{rd.replica}")
        log(f"[fleet] delta (fd0): replica {rd.replica}, latency "
            f"{rd.latency_s:.3f} s, {subst} of {n_m} windows substituted, "
            f"{n_m - subst} re-solved")

        # 4. the sticky-fault drill.  The replica on the first name is
        # replaced by one armed with a real device-side assert on its
        # first solve call (its environment only); a request of a new
        # structure ranks it first (least-loaded, name order)
        victim, survivor = FLEET_REPLICAS
        drill = served_cases(FLEET_MONTHLY, FLEET_DRILL_SCALE,
                             months=FLEET_DRILL_MONTHS)
        n_drill = windows_of(drill)
        undisturbed = f"{fleet.root}/undisturbed"
        solve_cases(drill, "torch")[0].save_as_csv(undisturbed)
        check(router.remove_replica(victim), "fleet: victim busy")
        old = fleet.handles[victim]
        old.terminate()
        check(old.process.wait(timeout=120) == 0,
              f"fleet: {victim} did not drain cleanly")
        log(f"[fleet] {victim} epoch 1 drained: peak device memory "
            f"{replica_peak_memory(fleet.spool(victim))} GiB")
        armed, s = fleet.spawn(victim, 2, env=FLEET_DRILL_ENV)
        log(f"[fleet] {victim} epoch 2 (sticky device loss armed): spawn "
            f"to first heartbeat {s:.2f} s")
        fleet.handles[victim] = armed
        router.adopt_replica(armed)
        fleet.wait_routable(FLEET_REPLICAS)
        sup = FleetSupervisor(
            router, [ReplicaSpec(fleet.spool(n), name=n, device=FLEET_DEVICE,
                                 heartbeat_s=FLEET_BEAT_S)
                     for n in FLEET_REPLICAS],
            backoff_base_s=0.1, tick_s=0.05)
        fleet.supervisor = sup.start()
        t_drill = time.perf_counter()
        ra = ask(drill, "fk0", n_drill, "drill request")
        rc = armed.process.wait(timeout=FLEET_TIMEOUT_S)
        t_dead = time.perf_counter()
        with open(f"{fleet.root}/{victim}.2.log") as fh:
            vlog = fh.read()
        assert_line = next((ln for ln in vlog.splitlines()
                            if "device-side assert" in ln), None)
        log(f"[fleet] {victim} epoch 2 exited {rc} "
            f"{t_dead - t_drill:.2f} s after the drill request; "
            f"its log: {assert_line}")
        check(rc == EXIT_BACKEND_LOST,
              f"fleet: the armed replica exited {rc}, not "
              f"{EXIT_BACKEND_LOST} ({fleet.tail(victim, 2)})")
        check(assert_line is not None,
              "fleet: the armed replica died without a device-side assert")
        from dervet_tpu_torch.service import ServiceJournal
        states = ServiceJournal.replay_path(
            f"{fleet.spool(victim)}/service_journal.jsonl")
        check(states.get("fk0", {}).get("state") == "admitted",
              f"fleet: the dead replica journaled fk0 as "
              f"{states.get('fk0')}")
        check(not os.path.exists(
            f"{fleet.spool(victim)}/failed/fk0.pkl"),
            "fleet: the dead replica wrote a failed marker")
        check(ra.replica == survivor and ra.recovered,
              f"fleet: fk0 answered by {ra.replica} "
              f"(recovered {ra.recovered})")
        led = replica_ledgers(fleet.spool(survivor))["fk0"]
        check_ledger_groups(led, pairs, "fleet drill")
        gap, same = csv_objective_gap(ra.results_dir, undisturbed)
        log(f"[fleet] drill answer vs the undisturbed solve: largest "
            f"rel gap {gap:.3e}, bit-equal {same}")
        check(gap <= SERVE_RTOL, f"fleet drill: gap {gap:.3e}")
        # the supervisor's respawn at epoch 3, warm
        while not (sup.snapshot()["replicas"][victim]["epoch"] == 3
                   and fleet.routable(victim)):
            check(time.perf_counter() - t_dead < FLEET_TIMEOUT_S,
                  f"fleet: {victim} never respawned "
                  f"{sup.snapshot()['replicas'][victim]}")
            time.sleep(0.05)
        fleet.handles[victim] = router.replicas[victim]
        log(f"[fleet] {victim} respawned at epoch 3: death to routable "
            f"{time.perf_counter() - t_dead:.2f} s")
        further = served_cases(FLEET_AFTER, FLEET_AFTER_SCALE)
        after = ask(further, "fa0", windows_of(further), "after respawn")
        check(after.replica == victim,
              f"fleet: the further request went to {after.replica}")
        snap = sup.snapshot()
        m = router.metrics()["routing"]
        log(f"[fleet] supervisor {json.dumps(snap['counters'])}; "
            f"{victim} {json.dumps(snap['replicas'][victim])}; routing "
            f"{json.dumps(m)}")
        check(snap["counters"]["restarts"] == 1
              and snap["counters"]["quarantined"] == 0
              and snap["replicas"][victim]["warm_imports"] == 1,
              f"fleet supervisor: {snap['counters']}")
        check(m["failovers"] >= 1 and m["failed"] == 0
              and m["request_cache_hits"] == 1,
              f"fleet routing: {m}")
        # launches by kernel for each replica, from its solve ledgers
        total = {}
        for name in FLEET_REPLICAS:
            by = {}
            for rid, led in replica_ledgers(fleet.spool(name)).items():
                for k, n in check_ledger_groups(
                        led, pairs, f"fleet {name} {rid}").items():
                    by[k] = by.get(k, 0) + n
                    total[k] = total.get(k, 0) + n
            log(f"[fleet] {name}: launches {by}")
        check(all(total.get(k) for k in records),
              f"fleet: a kernel never launched on the replicas {total}")
        check(sorted(p.name for p in lib.parent.glob(
            "libfused_chunk-*.so")) == built,
            "fleet: a replica built the kernel library again")
        for k in records:
            records[k].setdefault("launches_by_run", {})["fleet"] = \
                total.get(k, 0)
        log(f"[fleet] request latencies {json.dumps(lat)}")
        return fleet
    except BaseException:
        fleet.close()
        raise


def csv_objective_gap(dir_a, dir_b):
    """(max per-window relative gap, bit-equal) of the ``Total
    Objective`` columns of two answers' ``objective_values*.csv`` (the
    same writer on both sides, so the rows align)."""
    import os

    import numpy as np
    import pandas as pd
    names = sorted(f for f in os.listdir(dir_a)
                   if f.startswith("objective_values") and f.endswith(".csv"))
    check(names and names == sorted(
        f for f in os.listdir(dir_b)
        if f.startswith("objective_values") and f.endswith(".csv")),
        "answers hold different cases")
    worst, same = 0.0, True
    for f in names:
        x = pd.read_csv(os.path.join(dir_a, f), index_col=0)[
            "Total Objective"].to_numpy()
        y = pd.read_csv(os.path.join(dir_b, f), index_col=0)[
            "Total Objective"].to_numpy()
        check(x.shape == y.shape, f"{f}: {x.shape} vs {y.shape}")
        worst = max(worst, float((np.abs(x - y)
                                  / np.maximum(np.abs(y), 1.0)).max()))
        same = same and x.tobytes() == y.tobytes()
    return worst, same


# ---------------------------------------------------------------------------
# Phase 12: the portfolio co-optimization on the card
# ---------------------------------------------------------------------------

class RoundLog:
    """``on_round`` hook of ``solve_portfolio``: each outer round's
    launches by kernel (the counts are read and set to 0 at each round's
    end), the solver builds so far and the warm-start memory's state."""

    def __init__(self, cache):
        self.cache, self.rows = cache, []

    def __call__(self, k, result):
        from dervet_tpu_torch.ops import fused_chunk as fc
        mem = self.cache.memory.snapshot() if self.cache.memory else {}
        self.rows.append({"round": k, "launches": dict(fc.LAUNCHES),
                          "builds": self.cache.builds,
                          "evictions": mem.get("evictions"),
                          "hint_entries": mem.get("hint_entries"),
                          "entries": mem.get("entries")})
        fc.reset_launch_counts()


def portfolio_spec(n_sites, cap=None, **kw):
    """The JAX package's portfolio scale shape (``bench.py``
    ``portfolio_scale_leg``): ``n_sites`` synthetic sites of
    ``PORTFOLIO_HOURS`` hours in weekly windows, the export cap 500 kW a
    site under the uncoupled fleet's peak (a one-round probe on the
    card), ``gap_tol`` 1e-3, at most 40 outer rounds."""
    from dervet_tpu_torch.portfolio import PortfolioSpec, solve_portfolio
    from dervet_tpu_torch.portfolio.service import \
        synthetic_portfolio_members

    def members():
        return synthetic_portfolio_members(
            n_sites, hours=PORTFOLIO_HOURS, window=PORTFOLIO_WINDOW)
    if cap is None:
        probe = solve_portfolio(PortfolioSpec(
            members=members(), export_cap_kw=1e9, max_outer=1),
            backend="torch")
        cap = float(probe.aggregate["net_export"].max()) - 500.0 * n_sites
    return PortfolioSpec(members=members(), export_cap_kw=cap,
                         gap_tol=PORTFOLIO_GAP,
                         max_outer=PORTFOLIO_MAX_OUTER, **kw), cap


def check_portfolio(res, n_sites, what):
    """Converged to the gap, the portfolio certificate accepts, every
    site's final windows certified on the card, none on the CPU."""
    cert = res.certification
    ps = cert["per_site"]
    check(res.converged and res.gap_rel <= PORTFOLIO_GAP,
          f"{what}: converged {res.converged}, gap {res.gap_rel}")
    check(cert["verdict"] in ("certified", "certified_loose"),
          f"{what}: portfolio certificate {cert['verdict']}")
    check(ps["all_certified"]
          and ps["windows_total"] == n_sites * PORTFOLIO_SITE_WINDOWS,
          f"{what}: per-site certification {ps}")
    win = (res.run_health or {}).get("windows") or {}
    check(not win.get("cpu_fallback"), f"{what}: CPU fallback {win}")


def add_launches(records, run, launches):
    for k, n in launches.items():
        by = records[k].setdefault("launches_by_run", {})
        by[run] = by.get(run, 0) + n


def portfolio_phase(records, pairs, fleet):
    """Phase 12: the portfolio on the card.  The 64-site scale shape to
    the 1e-3 gap (every window certified on the card, every group at a
    pair phase 2 checked, no solver built after round 1); 8 sites against
    HiGHS on the monolithic coupled LP; 16 sites sharded over phase 11's
    fleet against the monolithic card solve of the same spec."""
    import numpy as np
    import torch
    from dervet_tpu_torch.ops import fused_chunk as fc
    from dervet_tpu_torch.portfolio import monolithic_reference, \
        solve_portfolio
    from dervet_tpu_torch.scenario.scenario import SolverCache
    # 1. the scale shape
    t0 = time.perf_counter()
    spec, cap = portfolio_spec(PORTFOLIO_SITES)
    log(f"[portfolio] {PORTFOLIO_SITES} sites x {PORTFOLIO_SITE_WINDOWS} "
        f"weekly windows: export cap {cap:.1f} kW from a one-round probe "
        f"({time.perf_counter() - t0:.2f} s)")
    cache = SolverCache(pad_grid=True, warm_start=True, device="cuda")
    rl = RoundLog(cache)
    torch.cuda.reset_peak_memory_stats()
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    with DispatchLog(extra=("dervet_tpu_torch.scenario.scenario",)) as dl:
        res = solve_portfolio(spec, backend="torch", solver_cache=cache,
                              on_round=rl)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check_portfolio(res, PORTFOLIO_SITES, "portfolio 64")
    check(len(dl.calls) == len(rl.rows) == res.outer_rounds,
          f"portfolio 64: {len(dl.calls)} dispatches, {len(rl.rows)} "
          f"rounds logged, {res.outer_rounds} outer rounds")
    total = {}
    for call, row in zip(dl.calls, rl.rows):
        got = check_ledger_groups(call["ledger"] or {}, pairs,
                                  f"portfolio 64 round {row['round']}")
        check(got == {k: n for k, n in row["launches"].items() if n},
              f"portfolio 64 round {row['round']}: ledger launches {got} "
              f"against the counts {row['launches']}")
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
    check(total.get(fc.KERNEL_DENSE), "portfolio 64: no dense launch")
    builds = [r["builds"] for r in rl.rows]
    check(len(builds) >= 2 and len(set(builds[1:])) == 1
          and builds[1] == builds[0],
          f"portfolio 64: solver builds by round {builds}")
    for r, row, call in zip(res.rounds, rl.rows, dl.calls):
        log(f"[portfolio] round {r['round']}: regime {r['regime']}, gap "
            f"{r['gap_rel']:.3e}, wall {r['wall_s']} s (dispatch "
            f"{call['wall_s']:.3f} s: LP assembly {call['assembly_s']} s, "
            f"solve {call['solve_s']} s), launches {row['launches']}, "
            f"{r['windows']} windows: seeded {r['seeded']} (dual_iterate "
            f"{r['dual_iterate']}, substituted {r['substituted']}), iters "
            f"p50 {r['iters_p50']} (seeded {r['iters_p50_seeded']}, cold "
            f"{r['iters_p50_cold']}), solver builds {row['builds']}, "
            f"memory entries {row['entries']} hints {row['hint_entries']} "
            f"evictions {row['evictions']}")
    later = res.rounds[1:]
    seeded = sum(r["dual_iterate"] + r["substituted"] for r in later)
    n_later = sum(r["windows"] for r in later)
    log(f"[portfolio] 64 sites: {res.outer_rounds} outer rounds in "
        f"{wall:.2f} s (the JAX package took 14, CPU-measured), regimes "
        f"{[r['regime'] for r in res.rounds]}, gap {res.gap_rel:.3e}, "
        f"objective {res.objective_total:.6f}; windows of rounds >= 1 "
        f"seeded by their own last iterate or substituted {seeded}/"
        f"{n_later}; iters p50 cold {res.rounds[0]['iters_p50']}, seeded "
        f"{[r['iters_p50'] for r in later]}; {json.dumps(dl.times())}; "
        f"launches {total}; peak device memory {peak / 2 ** 30:.3f} GiB; "
        f"warm-start memory {json.dumps(cache.memory.snapshot())}")
    add_launches(records, "portfolio", total)

    # 2. exactness: 8 sites against HiGHS on the monolithic coupled LP
    spec8, cap8 = portfolio_spec(PORTFOLIO_EXACT_SITES)
    fc.reset_launch_counts()
    with DispatchLog(extra=("dervet_tpu_torch.scenario.scenario",)) as dl:
        res8 = solve_portfolio(spec8, backend="torch")
    add_launches(records, "portfolio", dict(fc.LAUNCHES))
    check_portfolio(res8, PORTFOLIO_EXACT_SITES, "portfolio 8")
    for call in dl.calls:
        check_ledger_groups(call["ledger"] or {}, pairs, "portfolio 8")
    t0 = time.perf_counter()
    mono = monolithic_reference(
        portfolio_spec(PORTFOLIO_EXACT_SITES, cap=cap8)[0])
    check(mono["status"] == 0, f"portfolio 8: HiGHS status "
                               f"{mono['status']}")
    # normalized as the dual loop's own gap (primal minus the dual
    # bound over 1 + |primal| + |dual bound|): a blend within gap_tol of
    # its bound is within gap_tol of the optimum between them
    rel = abs(res8.primal_objective - mono["objective_cx"]) \
        / (1.0 + abs(res8.primal_objective) + abs(res8.dual_bound))
    of_opt = abs(res8.primal_objective - mono["objective_cx"]) \
        / (1.0 + abs(mono["objective_cx"]))
    log(f"[portfolio] 8 sites: {res8.outer_rounds} rounds, the card's "
        f"primal {res8.primal_objective:.6f} (dual bound "
        f"{res8.dual_bound:.6f}) against HiGHS's monolithic optimum "
        f"{mono['objective_cx']:.6f} ({time.perf_counter() - t0:.2f} s): "
        f"gap {rel:.3e} (gap_tol {PORTFOLIO_GAP}), "
        f"{of_opt:.3e} of the optimum")
    check(rel <= PORTFOLIO_GAP, f"portfolio 8: rel {rel:.3e}")

    # 3. 16 sites sharded over phase 11's fleet, against the monolithic
    # card solve of the same spec
    spec16, cap16 = portfolio_spec(PORTFOLIO_FLEET_SITES)
    fc.reset_launch_counts()
    mono16 = solve_portfolio(spec16, backend="torch")
    add_launches(records, "portfolio", dict(fc.LAUNCHES))
    check_portfolio(mono16, PORTFOLIO_FLEET_SITES, "portfolio 16 mono")
    t0 = time.perf_counter()
    res16 = solve_portfolio(
        portfolio_spec(PORTFOLIO_FLEET_SITES, cap=cap16,
                       shards=PORTFOLIO_SHARDS)[0],
        backend="torch", fleet=fleet.router, request_id="pf16")
    wall = time.perf_counter() - t0
    check_portfolio(res16, PORTFOLIO_FLEET_SITES, "portfolio 16 fleet")
    detail = [r["shard_detail"] for r in res16.rounds]
    homes = {d["shard"]: d["replica"] for d in detail[0]}
    check(len(set(homes.values())) == PORTFOLIO_SHARDS
          and all(d["replica"] == homes[d["shard"]]
                  for rnd in detail[1:] for d in rnd),
          f"portfolio 16 fleet: shard assignment {detail}")
    gaps = {"objective": abs(res16.objective_total
                             - mono16.objective_total)
            / max(abs(mono16.objective_total), 1.0)}
    check(sorted(res16.duals) == sorted(mono16.duals),
          "portfolio 16: different coupling rows")
    for kind in res16.duals:
        a = np.asarray(res16.duals[kind], float)
        b = np.asarray(mono16.duals[kind], float)
        gaps[kind] = float(np.max(np.abs(a - b)
                                  / np.maximum(np.abs(b), 1.0)))
    wire = [sum(d["payload_bytes"] for d in rnd) for rnd in detail]
    log(f"[portfolio] 16 sites, {PORTFOLIO_SHARDS} shards over the fleet: "
        f"{res16.outer_rounds} rounds (monolithic {mono16.outer_rounds}) "
        f"in {wall:.2f} s, shard homes {homes}, largest gaps to the "
        f"monolithic card solve {json.dumps(gaps)}, bytes on the wire by "
        f"round {wire} (rounds >= 1 at most "
        f"{max(wire[1:] or [0]) / max(wire[0], 1):.3f} of round 0)")
    check(max(gaps.values()) <= SERVE_RTOL,
          f"portfolio 16 fleet: gaps {gaps}")
    by = {}
    for name in FLEET_REPLICAS:
        for rid, led in replica_ledgers(fleet.spool(name)).items():
            if rid.startswith("pf16"):
                for k, n in check_ledger_groups(
                        led, pairs, f"portfolio 16 {name} {rid}").items():
                    by[k] = by.get(k, 0) + n
    check(by.get(fc.KERNEL_DENSE), f"portfolio 16 fleet: launches {by}")
    log(f"[portfolio] 16 sites: launches on the replicas {by}")
    add_launches(records, "portfolio", by)



# ---------------------------------------------------------------------------
# phase 13: multi-device dispatch (parallel/*)
# ---------------------------------------------------------------------------

def env_set(**env):
    """Set (a value) or unset (None) environment variables for a block;
    the environment is restored after it."""
    import contextlib
    import os
    from unittest import mock

    @contextlib.contextmanager
    def block():
        with mock.patch.dict(os.environ):
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = str(v)
            yield
    return block()


def same_answers(a, b):
    """Keys of ``a``'s cases whose objective values or solution arrays
    differ in any bit from the same cases in ``b``."""
    import numpy as np
    check(set(a.instances) <= set(b.instances),
          "parallel: the two runs hold other cases")
    bad = []
    for k, ia in a.instances.items():
        sa, sb = ia.scenario, b.instances[k].scenario
        if not (sa.objective_values == sb.objective_values
                and set(sa._solution) == set(sb._solution)
                and all(np.array_equal(sa._solution[n], sb._solution[n])
                        for n in sa._solution)):
            bad.append(k)
    return bad


def sample_csvs(res, keys):
    """The CSV bytes ``CaseResult.save_as_csv`` writes for ``keys``."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as d:
        from pathlib import Path
        for k in keys:
            res.instances[k].save_as_csv(Path(d), str(k))
        out.update(csv_bytes(d))
    return out


def ledger_groups(led):
    return sorted((g["m"], g["n"], g["batch"], g.get("padded_to"))
                  for g in led["groups"] if g.get("rung") == "initial")


def launch_widths():
    """A block that records the (kernel, m, n, batch) of every chunk-
    kernel launch made in it, from any thread: the launch wrapper's own
    arguments, so no path's launches escape the record."""
    import contextlib
    from dervet_tpu_torch.ops import fused_chunk as fc

    @contextlib.contextmanager
    def block():
        seen, launch = set(), fc._launch

        def record(kernel, state, part, B, m, n, *a, **kw):
            out = launch(kernel, state, part, B, m, n, *a, **kw)
            seen.add((kernel, m, n, B))
            return out
        fc._launch = record
        try:
            yield seen
        finally:
            fc._launch = launch
    return block()


def check_launch_widths(seen, pairs, what):
    """Every launch ``launch_widths`` recorded ran the kernel its op
    takes at a (structure, batch) pair phase 2 held against the plain
    version."""
    from dervet_tpu_torch.ops import fused_chunk as fc
    check(seen, f"{what}: no kernel launched")
    for kernel, m, n, B in sorted(seen):
        check((m, n, B) in pairs, f"{what}: {kernel} launched at (m, n, "
                                  f"batch) {(m, n, B)}, a pair phase 2 "
                                  "did not check")
        check(fc.kernel_for(pairs[(m, n, B)]["op"]) == kernel,
              f"{what}: {kernel} launched on the {(m, n)} structure")
    log(f"[{what}] launches at (kernel, m, n, batch) {sorted(seen)}")


def elastic_run(what, checked, pairs, n_cases):
    from dervet_tpu_torch import benchlib
    from dervet_tpu_torch.ops import fused_chunk as fc
    cases = benchlib.synthetic_sensitivity_cases(
        MAIN_CASES, daily_cycle_limit=1)[:n_cases]
    fc.reset_launch_counts()
    with launch_widths() as seen:
        res, wall = solve_cases(cases, "torch")
    launches = dict(fc.LAUNCHES)
    led = res.solve_ledger
    el = led.get("elastic") or {}
    log(f"[{what}] {n_cases} cases x 12 months: {wall:.2f} s wall, "
        f"launches {launches}; elastic {json.dumps(el)}")
    check_certified(res, n_cases * 12, what)
    check_ledger(res, fc.KERNEL_BANDED, checked[fc.KERNEL_BANDED], what)
    check_launch_widths(seen, pairs, what)
    check(led["totals"]["cpu_rescued"] == 0,
          f"{what}: cpu_rescued {led['totals']['cpu_rescued']}")
    check(el, f"{what}: the ledger has no elastic section")
    check(sum(d["windows"] for d in el["devices"].values())
          == led["totals"]["windows"] == n_cases * 12,
          f"{what}: the devices' windows do not sum to the round")
    for g in led["groups"]:
        check(isinstance(g.get("device"), int),
              f"{what}: group without a device slot: {g.get('device')}")
    return res, wall, launches


def parallel_phase(records, checked, pairs, main_res):
    """Phase 13: the elastic scheduler with one worker and with two
    workers on cuda:0 (straggler drill, steals, byte-identical answers),
    the scenario axis split over [cuda:0, cuda:0], and the time-sharded
    5-minute year (world 1, NCCL) and month (world 2, gloo)."""
    import numpy as np
    import torch
    from dervet_tpu_torch import benchlib
    from dervet_tpu_torch.ops import cpu_ref
    from dervet_tpu_torch.ops import fused_chunk as fc
    from dervet_tpu_torch.ops.pdhg import CompiledLPSolver, PDHGOptions
    from dervet_tpu_torch.parallel import elastic
    from dervet_tpu_torch.parallel.mesh import solve_batch_sharded
    from dervet_tpu_torch.parallel.timeshard import solve_time_sharded
    card = torch.device(PARALLEL_DEVICE)
    launches_by = {k: 0 for k in fc.KERNELS}

    # 13.1 elastic, one worker, against phase 3's pipeline run
    with env_set(**{elastic.ELASTIC_DEVICES_ENV: "1",
                    elastic.ELASTIC_ENV: None}):
        res1, wall1, l1 = elastic_run("parallel: elastic 1",
                                      checked, pairs, PARALLEL_CASES)
    for k, n in l1.items():
        launches_by[k] += n
    el1 = res1.solve_ledger["elastic"]
    check(el1["n_devices"] == 1, f"elastic 1: {el1['n_devices']} devices")
    keys = sorted(res1.instances)[::PARALLEL_CSV_EVERY]
    g3, g1 = (ledger_groups(r.solve_ledger) for r in (main_res, res1))
    log(f"[parallel] groups (m, n, batch, padded_to): phase 3 {g3}, "
        f"elastic 1 {g1}")
    # the same windows in groups of other widths: each instance's
    # iterations are its own, whatever the batch beside it
    bad = same_answers(res1, main_res)
    check(not bad, f"elastic 1: cases {bad[:8]} differ from phase 3")
    check(sample_csvs(main_res, keys) == sample_csvs(res1, keys),
          "elastic 1: CSVs differ from phase 3's")
    log(f"[parallel] elastic 1 vs phase 3: every case's objectives and "
        f"solutions bit-equal, CSVs of cases {keys} byte-identical")

    # 13.2 two workers on cuda:0 (two streams), straggler on slot 1
    seam = elastic.visible_devices
    elastic.visible_devices = lambda device=None: [card, card]
    try:
        with env_set(**{elastic.ELASTIC_DEVICES_ENV: None,
                        elastic.ELASTIC_ENV: None,
                        "DERVET_TPU_FAULT_STRAGGLER": "1",
                        "DERVET_TPU_FAULT_STRAGGLER_DEVICE": "1",
                        "DERVET_TPU_FAULT_STRAGGLER_S":
                            PARALLEL_STRAGGLER_S}):
            res2, wall2, l2 = elastic_run("parallel: elastic 2",
                                          checked, pairs, PARALLEL_CASES)
    finally:
        elastic.visible_devices = seam
    for k, n in l2.items():
        launches_by[k] += n
    led2 = res2.solve_ledger
    el2 = led2["elastic"]
    for d, rec in sorted(el2["devices"].items()):
        log(f"[parallel] elastic 2 slot {d}: groups {rec['groups']}, "
            f"windows {rec['windows']}, busy {rec['busy_s']} s, occupancy "
            f"{rec['occupancy']}, steals in/out {rec['steals_in']}/"
            f"{rec['steals_out']}, accounted {rec['accounted_fraction']}")
    stolen = [(g["m"], g["batch"], g["device"]) for g in led2["groups"]
              if g.get("stolen")]
    log(f"[parallel] round wall: elastic 1 {el1['round_wall_s']} s "
        f"({wall1:.2f} s in all), elastic 2 {el2['round_wall_s']} s "
        f"({wall2:.2f} s, slot 1 sleeping {PARALLEL_STRAGGLER_S} s a "
        f"group); steals {el2['steals']}; stolen groups {stolen}")
    check(el2["n_devices"] == 2 and el2["n_steals"] >= 1,
          f"elastic 2: {el2['n_steals']} steals over {el2['n_devices']}")
    bad = same_answers(res1, res2)
    check(not bad, f"elastic 2: cases {bad[:8]} differ from elastic 1")
    check(sample_csvs(res1, keys) == sample_csvs(res2, keys),
          "elastic 2: CSVs differ from elastic 1's")
    log(f"[parallel] elastic 2 vs elastic 1: every case bit-equal, CSVs "
        f"of cases {keys} byte-identical")
    del main_res, res1, res2

    # 13.3 the scenario axis split over [cuda:0, cuda:0]
    opts = PDHGOptions(cpu_rescue_after=None)
    lps = {**{T: lp for T, lp in window_lps("month", 1).items()
              if T == 744}, **{168: window_lps(168, 0)[168]}}
    for T, B in SHARD_BATCHES.items():
        lp = lps[T]
        rng = np.random.default_rng(T)
        mult = rng.lognormal(0.0, 0.15, (B, lp.n))
        C = np.where(lp.c != 0, mult * lp.c, 0.0)
        solver = CompiledLPSolver(lp, opts, device=card)
        t0 = time.perf_counter()
        ref = solver.solve(c=C)
        torch.cuda.synchronize()
        t_un = time.perf_counter() - t0
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        with launch_widths() as seen:
            res, st = solve_batch_sharded(solver, [card] * SHARDS, c=C)
            torch.cuda.synchronize()
        t_sh = time.perf_counter() - t0
        for k, n in fc.LAUNCHES.items():
            launches_by[k] += n
        a, b = res.obj.cpu().numpy(), ref.obj.cpu().numpy()
        gap = np.abs(a - b)
        ok = bool((gap <= SHARD_ATOL + SHARD_RTOL * np.abs(b)).all())
        n_ref = int(ref.converged.sum())
        log(f"[parallel] sharded {lp.m}x{lp.n} B={B} over {SHARDS} x "
            f"cuda:0: "
            f"{t_sh:.3f} s (unsharded {t_un:.3f} s), launches "
            f"{dict(fc.LAUNCHES)}; {json.dumps(st._asdict())}; unsharded "
            f"converged {n_ref}; objective gap max "
            f"{float((gap / np.maximum(np.abs(b), 1.0)).max()):.3e} rel, "
            f"bit-equal {bool((a == b).all())} "
            f"({int((a == b).sum())} of {B} instances)")
        check_launch_widths(seen, pairs, f"parallel: sharded {lp.m}x{lp.n}")
        check(ok, f"sharded {lp.m}x{lp.n}: objectives off by {gap.max()}")
        check(st.n_converged == n_ref,
              f"sharded {lp.m}x{lp.n}: {st.n_converged} converged, "
              f"unsharded {n_ref}")
    for k, n in launches_by.items():
        records[k].setdefault("launches_by_run", {})["parallel"] = n
    log(f"[parallel] launches by kernel {launches_by}")
    check(launches_by[fc.KERNEL_BANDED] > 0
          and launches_by[fc.KERNEL_DENSE] > 0,
          f"parallel: a kernel never launched {launches_by}")

    # 13.4-13.5 the 5-minute year row-sharded at world 1 on NCCL, and a
    # 5-minute month at world 2 on gloo with both ranks on cuda:0: the
    # three ranks (processes of their own) run while this process solves
    # the same LPs on HiGHS and unsharded on the card.  Every one of
    # these solves is launch-bound at one instance, so they share the
    # card at little cost to each other; their walls are taken together
    t0 = time.perf_counter()
    year = benchlib.window_lps(benchlib.synthetic_case(**TS_YEAR))
    month = benchlib.window_lps(benchlib.synthetic_case(**TS_MONTH))[0]
    check(len(year) == 1, f"the year case has {len(year)} windows")
    year = year[0]
    log(f"[parallel] year window {year.m}x{year.n}, month window "
        f"{month.m}x{month.n}, built in {time.perf_counter() - t0:.1f} s")
    st_y, st_m = {}, {}
    join_y = timed_in_thread(lambda: solve_time_sharded(
        year, 1, backend="nccl", opts=opts, timeout_s=TS_TIMEOUT_S,
        stats=st_y))
    join_m = timed_in_thread(lambda: solve_time_sharded(
        month, 2, backend="gloo", device=card, opts=opts,
        timeout_s=TS_TIMEOUT_S, stats=st_m))
    t0 = time.perf_counter()
    hi = cpu_ref.solve_lp_cpu(year)
    t_hi = time.perf_counter() - t0
    unsharded = {}
    for name, lp in (("year", year), ("month", month)):
        t0 = time.perf_counter()
        unsharded[name] = CompiledLPSolver(lp, opts, device=card).solve()
        torch.cuda.synchronize()
        unsharded[name + "_s"] = time.perf_counter() - t0
    (ts, t_ts), (tm, t_tm) = join_y(), join_m()

    un = unsharded["year"]
    rel = abs(float(ts.obj) - hi.obj) / max(1.0, abs(hi.obj))
    log(f"[parallel] time-sharded year, world 1, nccl: {t_ts:.2f} s with "
        f"the spawn ({json.dumps(st_y)}), converged {bool(ts.converged)}, "
        f"iterations {int(ts.iters)}, objective {float(ts.obj):.6f}, "
        f"HiGHS {hi.obj:.6f} ({t_hi:.2f} s): rel {rel:.3e}; unsharded "
        f"card solve {unsharded['year_s']:.2f} s, iterations "
        f"{int(un.iters)}, objective {float(un.obj):.6f}, converged "
        f"{bool(un.converged)}")
    check(bool(ts.converged) and rel < TS_HIGHS_RTOL,
          f"time-sharded year: converged {bool(ts.converged)}, rel {rel}")
    check(ts.y.shape == (year.m,), f"time-sharded year: y {ts.y.shape}")

    un = unsharded["month"]
    obj_rel = abs(float(tm.obj) - float(un.obj)) / max(1.0, abs(float(
        un.obj)))
    xs, xu = tm.x.numpy(), un.x.cpu().numpy()
    x_rel = float(np.abs(xs - xu).max() / max(1.0, np.abs(xu).max()))
    log(f"[parallel] time-sharded month, world 2, gloo on cuda:0: "
        f"{t_tm:.2f} s with the spawn ({json.dumps(st_m)}), converged "
        f"{bool(tm.converged)}, iterations {int(tm.iters)}; unsharded card "
        f"solve {unsharded['month_s']:.2f} s, iterations {int(un.iters)}; "
        f"objective rel {obj_rel:.3e}, x rel {x_rel:.3e}")
    check(bool(tm.converged) and obj_rel < TS_OBJ_RTOL
          and x_rel < TS_X_RTOL,
          f"time-sharded month: objective {obj_rel}, x {x_rel}")
    check(tm.y.shape == (month.m,), f"time-sharded month: y {tm.y.shape}")


def timed_in_thread(fn):
    """Start ``fn`` on a thread of its own; the returned ``join()`` gives
    ``(its result, its wall seconds)`` or raises its error."""
    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["out"] = fn()
        except BaseException as e:      # raised again by join()
            box["err"] = e
        box["s"] = time.perf_counter() - t0

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def join():
        t.join()
        if "err" in box:
            raise box["err"]
        return box["out"], box["s"]
    return join


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the main path with torch.profiler and "
                         "print the device's busy share")
    ap.add_argument("--time", metavar="DIR",
                    help="only time the kernels of the package under DIR")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if args.time:
        import os
        return time_kernels(os.path.realpath(args.time))
    try:
        from dervet_tpu_torch.ops import fused_chunk as fc
    except ImportError as e:
        print(f"chip_smoke: the dervet_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    so = fc.build()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.1f} s")
    report = ptxas_report(fc.BUILD_LOG)
    for rec in report:
        v, t, cpt, rpt, minb = rec["template"]
        log(f"[build] {rec['kernel']}<variant={v}, threads={t}, "
            f"cols/thread={cpt}, rows/thread={rpt}, blocks/SM={minb}>"
            f"{' (state in shared memory)' if cpt == 0 else ''}: "
            f"{rec['registers']} "
            f"registers, {rec['stack']} B stack, {rec['spill_stores']} B "
            f"spill stores, {rec['spill_loads']} B spill loads")
    check(len(report) == 2 * 3 * len(fc.CONFIGS),
          f"ptxas reported {len(report)} kernel instances")
    spilled = [r for r in report if r["spill_stores"] or r["spill_loads"]]
    check(not spilled, f"kernel instances spill registers: {spilled}")
    t0 = time.perf_counter()
    records, checked, found = kernel_phase()
    log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pairs = pair_phase(records)
    log(f"[pairs] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    main_res = main_phases(records, checked, profile=args.profile)
    log(f"[main] phases 3-5 done in {time.perf_counter() - t0:.1f} s")
    for kind in RUNS:
        t0 = time.perf_counter()
        run_phase(kind, records, checked, found)
        log(f"[{kind}] done in {time.perf_counter() - t0:.1f} s")
    for what, phase in (("design", design_phase),
                        ("montecarlo", montecarlo_phase),
                        ("serve", serve_phase)):
        t0 = time.perf_counter()
        phase(records, pairs)
        log(f"[{what}] done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fleet = fleet_phase(records, pairs)
    log(f"[fleet] done in {time.perf_counter() - t0:.1f} s")
    try:
        t0 = time.perf_counter()
        portfolio_phase(records, pairs, fleet)
        log(f"[portfolio] done in {time.perf_counter() - t0:.1f} s")
    finally:
        fleet.close()
    t0 = time.perf_counter()
    parallel_phase(records, checked, pairs, main_res)
    log(f"[parallel] done in {time.perf_counter() - t0:.1f} s")
    log(f"[smoke] {time.perf_counter() - t_start:.1f} s in all")
    card = card_line()
    print(card)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
