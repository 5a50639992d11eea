"""The CUDA chunk kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no GPU is visible.
The file imports nothing of JAX, so on a GPU machine without JAX it runs
without the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

It also holds the small LP builders and the comparison helper that the
CPU test files share (``test_torch_pdhg``, ``test_torch_fused_chunk``).

Checks: one chunk of each kernel and step variant from a mid-solve state
(B = 129, not a multiple of any block) agrees with the plain version per
instance to 1e-5 of the vector's scale, and launches exactly once, on the
small LPs, on the ICE + CHP monthly window, on the first windows of the
microgrid + Reliability and retail + demand-charge runs, and on two shapes
of the shared-state configuration (the DA + FR monthly window, a dense
block); one kernel instance launches at two shapes from two threads at
once; Reliability's outage walks on the card equal their CPU run; a full
solve on the card gives the CPU solve's statuses, objectives within the
solver's ``eps_rel`` and iteration counts within one check window; a small
``run_design`` and ``run_montecarlo`` on the card give the CPU run's
finalists and pinned samples, and the Monte-Carlo replay is byte-identical;
the scenario service warms the card at start and serves two coalesced
requests in one round on the banded kernel; a spawned fleet replica
serves a request on cuda:0; the price sweep draws on the card, and a
solve whose C, Q, L and U already lie there copies no bytes to it; a
solve whose check windows replay CUDA graphs is bit-equal to the eager
window loop (``_Solver.run_chunk``) on the card, for both kernels and
the plain chunk, with as many kernel launches (the warm-ups before the
captures set apart), two threads on two streams capture and replay at
once, and a dropped solver frees its graphs' memory; the dispatch
pipeline runs the three B = 24 groups of a three-month demand-charge
fan-out at once on streams of their own, bit-identical to its serial
mode; in a fan-out of
each benchmark configuration's traffic through ``DERVET.solve`` (64
Battery + PV cases, 32 ICE + CHP + Reliability cases, a year each), the
``valuation`` and ``dispatch`` spans' self time — what their children on
their own thread leave uncovered — is under 5% of their duration.
"""
import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dervet_tpu_torch import benchlib
from dervet_tpu_torch.ops import fused_chunk
from dervet_tpu_torch.ops import lp as port_lp
from dervet_tpu_torch.ops import pdhg

torch.set_num_threads(2)

ALPHA = {"vanilla": 1.0, "reflected": 1.8, "halpern": 2.0}


def mixed_lp(builder, T=48, seed=0):
    """Battery-like LP with equality (SOE) and inequality (requirement)
    rows; small enough that ``make_op`` keeps it dense."""
    rng = np.random.default_rng(seed)
    b = builder()
    ch = b.var("ch", T, 0.0, 10.0)
    dis = b.var("dis", T, 0.0, 10.0)
    ene = b.var("ene", T, 0.0, 40.0)
    price = rng.uniform(10, 50, T)
    b.add_cost(ch, price)
    b.add_cost(dis, -price)
    D = sp.diags([np.ones(T), -np.ones(T - 1)], [0, -1])
    b.add_rows("soe", [(ene, D), (ch, -0.9 * sp.eye(T)),
                       (dis, (1 / 0.9) * sp.eye(T))], "eq",
               np.r_[20.0, np.zeros(T - 1)])
    b.add_rows("req", [(dis, np.ones((1, T)))], "ge", 5.0)
    return b.build()


def banded_lp(builder, T=300, daily_rows=False):
    """Large enough for the banded decomposition; ``daily_rows`` adds
    one discharge-energy cap per 24 steps (the daily-cycle shape), which
    ``make_op`` carries as the low-rank wide-row pair."""
    rng = np.random.default_rng(2)
    b = builder()
    ch = b.var("ch", T, 0.0, 250.0)
    dis = b.var("dis", T, 0.0, 250.0)
    ene = b.var("ene", T, 0.0, 1000.0)
    price = rng.uniform(10, 80, T) / 1000
    b.add_cost(ch, price)
    b.add_cost(dis, -price)
    D = np.eye(T) - np.eye(T, k=-1)
    rhs = np.zeros(T)
    rhs[0] = 500.0
    b.add_rows("soe", [(ene, D), (ch, -0.85), (dis, 1.0)], "eq", rhs)
    if daily_rows:
        days = -(-T // 24)
        S = np.zeros((days, T))
        for d in range(days):
            S[d, 24 * d:24 * d + 24] = 1.0
        b.add_rows("daily_cycle", [(dis, S)], "le", 900.0)
    return b.build()


LPS = {
    "dense": lambda B: mixed_lp(B),
    "banded": lambda B: banded_lp(B),
    "banded_wide": lambda B: banded_lp(B, daily_rows=True),
}
# the kernels are also held at the largest window a register
# configuration takes (the ICE + CHP monthly window, 2233 x 5952, seven
# bands, 768-thread blocks) and at two shapes only the shared-state
# configuration takes (the DA + FR monthly window, 3752 x 4464, ten
# bands; a dense op with every entry of K non-zero, 200 x 600)
KERNEL_LPS = {**LPS, "ice_chp": lambda B: benchlib.multi_der_window_lp(),
              "da_fr": lambda B: benchlib.fr_window_lp(),
              "dense_block": lambda B: benchlib.dense_block_lp(),
              # the first monthly window of each run chip_smoke.py adds:
              # the microgrid with Reliability's min-SOE rows (2977 x
              # 5952, shared-state) and the demand-charge window (a dense
              # op, 1665 x 2978)
              "microgrid": lambda B: benchlib.window_lps(
                  benchlib.synthetic_case(multi_der=True,
                                          reliability=True))[0],
              "retail_dcm": lambda B: benchlib.window_lps(
                  benchlib.synthetic_case(retail=True))[0]}


def price_batch(lp, B, seed=1):
    rng = np.random.default_rng(seed)
    return lp.c[None] * rng.uniform(0.8, 1.2, (B, lp.n))


def random_state(l_s, u_s, m, B, seed=0):
    """An arbitrary (not mid-solve) chunk state for scaled bounds
    ``l_s``/``u_s`` (B, n): x and the primal anchor uniform in the box
    (infinite sides cut at +-10), y and the dual anchor standard normal,
    primal weights lognormal(0, 1), halpern inner counts in [0, 64).
    Float32 numpy arrays (k int32)."""
    rng = np.random.default_rng(seed)
    lo = np.where(np.isfinite(l_s), l_s, -10.0)
    hi = np.where(np.isfinite(u_s), u_s, 10.0)
    B_, n = lo.shape
    out = dict(x=lo + (hi - lo) * rng.random((B, n)),
               ax=lo + (hi - lo) * rng.random((B, n)),
               y=rng.standard_normal((B, m)), ay=rng.standard_normal((B, m)),
               xs=rng.standard_normal((B, n)), ys=rng.standard_normal((B, m)),
               omega=rng.lognormal(0.0, 1.0, B))
    out = {k: v.astype(np.float32) for k, v in out.items()}
    out["k"] = rng.integers(0, 64, B).astype(np.int32)
    return out


def rel_gap(a, ref):
    """max |a - ref| / (1 + max |ref|) over one output tensor."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / (1.0 + np.abs(ref).max()))


# An fp32 chunk that differs from the float64 run of the plain version by
# no more than this many times the largest gap of the fp32 plain version
# run on the same inputs and on ROUNDING_RUNS copies whose x and y moved
# by one ulp (plus a floor of one part in a million) differs by rounding
# alone.  From an arbitrary state the gap concentrates in a few
# instances, so one fp32 run alone is no yardstick.
ROUNDING_FACTOR = 4.0
ROUNDING_FLOOR = 1e-6
ROUNDING_RUNS = 4


def rounding_spread(run32, t, ref):
    """Per output tensor, the largest ``rel_gap`` to ``ref`` (float64
    outputs) of ``run32`` (dict of tensors -> fp32 outputs) on ``t`` and
    on ROUNDING_RUNS copies whose x and y moved by one ulp at random."""
    gen = torch.Generator().manual_seed(0)

    def nudge(v):
        sign = torch.randint(-1, 2, tuple(v.shape), generator=gen)
        return v * (1.0 + sign.to(v.device, v.dtype) * 2.0 ** -23)

    ref = [h.cpu().numpy() for h in ref]
    spread = [0.0] * len(ref)
    for i in range(ROUNDING_RUNS + 1):
        d = dict(t) if i == 0 else {**t, "x": nudge(t["x"]),
                                    "y": nudge(t["y"])}
        spread = [max(s, rel_gap(o.cpu().numpy(), h))
                  for s, o, h in zip(spread, run32(d), ref)]
    return spread


def assert_close_rows(a, b, what, rtol=1e-5, atol=1e-6):
    """Per instance (row): max |a - b| <= atol + rtol * max |b|.  Norm-wise,
    not entry-wise: reordered float32 sums leave every entry an error on
    the scale of the vector's large entries (a near-zero entry fed by
    terms of size 100 carries ~1e-5 absolute error)."""
    err = np.abs(a - b).max(axis=-1)
    bound = atol + rtol * np.abs(b).max(axis=-1)
    assert np.all(err <= bound), (what, err, bound)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KERNEL_LPS))
@pytest.mark.parametrize("variant", sorted(ALPHA))
def test_kernel_matches_plain(cuda, kind, variant):
    lp = KERNEL_LPS[kind](port_lp.LPBuilder)
    solver = pdhg.CompiledLPSolver(lp, pdhg.PDHGOptions(), device=cuda)
    B = 129
    C = torch.tensor(price_batch(lp, B), dtype=torch.float32, device=cuda)
    Q, L, U = (torch.tensor(np.broadcast_to(a, (B, a.size)).copy(),
                            dtype=torch.float32, device=cuda)
               for a in (lp.q, lp.l, lp.u))
    sv = solver._solver
    args = (solver.op, C, Q, L, U, solver.dr, solver.dc)
    st = sv.run_chunk(*args, solver.eta, sv.init_state(*args), 96)
    t = sv._context(C, Q, L, U, solver.dr, solver.dc)
    k = st.inner + torch.arange(B, dtype=torch.int32, device=cuda) % 50
    name = fused_chunk.kernel_for(solver.op)
    before = fused_chunk.LAUNCHES[name]
    out = fused_chunk.batched_chunk(
        solver.op, t.c_s, t.q_s, t.l_s, t.u_s, st.omega, solver.eta, st.x,
        st.y, st.x_sum, st.y_sum, lp.n_eq, 32, variant, ALPHA[variant],
        k, st.x_restart, st.y_restart)
    torch.cuda.synchronize()
    assert fused_chunk.LAUNCHES[name] == before + 1
    tau = (solver.eta / st.omega).contiguous()
    sig = (solver.eta * st.omega).contiguous()
    extra = ((k.float(), st.x_restart, st.y_restart)
             if variant == "halpern" else (None, None, None))
    op = solver.op
    if name == fused_chunk.KERNEL_BANDED:
        plain = fused_chunk.banded_chunk_plain(
            t.c_s, t.q_s, t.l_s, t.u_s, tau, sig, st.x, st.y, st.x_sum,
            st.y_sum, op.diags, op.offsets_t, op.wide_rows, op.wide_w,
            lp.n_eq, 32, variant, ALPHA[variant], *extra)
    else:
        plain = fused_chunk.dense_chunk_plain(
            t.c_s, t.q_s, t.l_s, t.u_s, tau, sig, st.x, st.y, st.x_sum,
            st.y_sum, op.Kh, lp.n_eq, 32, variant, ALPHA[variant], *extra)
    for nm, a, b in zip(("x", "y", "x_sum", "y_sum"), out, plain):
        assert torch.isfinite(a).all()
        assert_close_rows(a.cpu().numpy(), b.cpu().numpy(), nm)


def plain_chunk_as(dtype, op, n_eq, t, tau, sig, iters, variant, alpha):
    """The kernel's plain version on the tensors of dict ``t`` and the op,
    cast to ``dtype``; ``tau``/``sig`` are cast from the float32 step
    sizes the kernel gets."""
    d = {k: v.to(dtype) for k, v in t.items()}
    extra = ((d["k"], d["ax"], d["ay"]) if variant == "halpern"
             else (None, None, None))
    common = (d["c"], d["q"], d["l"], d["u"], tau.to(dtype), sig.to(dtype),
              d["x"], d["y"], d["xs"], d["ys"])
    if isinstance(op, pdhg.BandedOp):
        W = None if op.wide_w is None else op.wide_w.to(dtype)
        return fused_chunk.banded_chunk_plain(
            *common, op.diags.to(dtype), op.offsets_t, op.wide_rows, W, n_eq,
            iters, variant, alpha, *extra)
    return fused_chunk.dense_chunk_plain(*common, op.Kh.to(dtype), n_eq,
                                         iters, variant, alpha, *extra)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KERNEL_LPS))
@pytest.mark.parametrize("variant", sorted(ALPHA))
def test_kernel_from_random_state_differs_by_rounding(cuda, kind, variant):
    """From an arbitrary state the chunk amplifies float32 rounding (most
    on the all-equality banded op); the kernel sits no farther from the
    float64 run of the plain version than ROUNDING_FACTOR times the
    float32 plain runs do (``rounding_spread``)."""
    lp = KERNEL_LPS[kind](port_lp.LPBuilder)
    solver = pdhg.CompiledLPSolver(lp, pdhg.PDHGOptions(), device=cuda)
    B = 129
    C = torch.tensor(price_batch(lp, B), dtype=torch.float32, device=cuda)
    Q, L, U = (torch.tensor(np.broadcast_to(a, (B, a.size)).copy(),
                            dtype=torch.float32, device=cuda)
               for a in (lp.q, lp.l, lp.u))
    ctx = solver._solver._context(C, Q, L, U, solver.dr, solver.dc)
    st = random_state(ctx.l_s.cpu().numpy(), ctx.u_s.cpu().numpy(), lp.m, B)
    t = {k: torch.tensor(v, device=cuda) for k, v in st.items()}
    t.update(c=ctx.c_s, q=ctx.q_s, l=ctx.l_s, u=ctx.u_s)
    out = fused_chunk.batched_chunk(
        solver.op, t["c"], t["q"], t["l"], t["u"], t["omega"], solver.eta,
        t["x"], t["y"], t["xs"], t["ys"], lp.n_eq, 32, variant,
        ALPHA[variant], t["k"], t["ax"], t["ay"])
    tau = (solver.eta / t["omega"]).contiguous()
    sig = (solver.eta * t["omega"]).contiguous()

    def run(dtype, d):
        return plain_chunk_as(dtype, solver.op, lp.n_eq, d, tau, sig, 32,
                              variant, ALPHA[variant])

    p64 = run(torch.float64, t)
    spread = rounding_spread(lambda d: run(torch.float32, d), t, p64)
    for nm, a, h, s in zip(("x", "y", "x_sum", "y_sum"), out, p64, spread):
        gk = rel_gap(a.cpu().numpy(), h.cpu().numpy())
        assert gk <= ROUNDING_FACTOR * s + ROUNDING_FLOOR, (nm, gk, s)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(LPS))
def test_solve_on_card_matches_cpu(cuda, kind):
    lp = LPS[kind](port_lp.LPBuilder)
    C = price_batch(lp, 5)
    stats = pdhg.SolveStats()
    gpu = pdhg.CompiledLPSolver(lp, device=cuda).solve(c=C, stats=stats)
    cpu = pdhg.CompiledLPSolver(lp, device="cpu").solve(c=C)
    assert stats.kernel_launches > 0
    np.testing.assert_array_equal(gpu.status.cpu().numpy(),
                                  cpu.status.numpy())
    o_g, o_c = gpu.obj.cpu().numpy(), cpu.obj.numpy()
    np.testing.assert_allclose(o_g, o_c, rtol=1e-4,
                               atol=1e-4 * np.abs(o_c).max())
    assert np.all(np.abs(gpu.iters.cpu().numpy() - cpu.iters.numpy())
                  <= pdhg.PDHGOptions().check_every)


@pytest.mark.cuda
def test_outage_walks_on_card_match_cpu(cuda):
    """Reliability's outage walk and min-SOE recursion on the card give
    the CPU tensors' answer: coverage start for start, profiles and
    requirements to 1e-5 relative with ``inf`` in the same places."""
    from dervet_tpu_torch.models.streams.reliability import (
        min_soe_required, simulate_all_outages)
    rng = np.random.default_rng(5)
    T, L = 8760, 12
    data = (rng.uniform(0, 100, T), np.full(T, 30.0), rng.uniform(0, 60, T),
            rng.uniform(0, 50, T), 0.43,
            np.maximum(1.0 - 0.05 * np.arange(L), 0.5))
    fleet = (40.0, 50.0, 10.0, 200.0, 0.85, 1.0, L)
    init = rng.uniform(20.0, 200.0, T)
    (cd, pd_), (ch, ph) = (
        simulate_all_outages(*data, init, *fleet, device=dev)
        for dev in (cuda, "cpu"))
    assert cd.device.type == "cuda" and pd_.device.type == "cuda"
    np.testing.assert_array_equal(cd.cpu().numpy(), ch.numpy())
    np.testing.assert_allclose(pd_.cpu().numpy(), ph.numpy(), rtol=1e-5,
                               atol=0.0)
    md, mh = (min_soe_required(*data, *fleet, device=dev).cpu().numpy()
              for dev in (cuda, "cpu"))
    np.testing.assert_array_equal(np.isinf(md), np.isinf(mh))
    fin = np.isfinite(mh)
    np.testing.assert_allclose(md[fin], mh[fin], rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_one_instance_two_shapes_from_two_threads(cuda):
    """The dispatch pipeline launches one kernel instance at groups of
    other shapes from other threads at once: no launch may lower the
    shared memory another launch of the instance takes."""
    import threading
    lps = [mixed_lp(port_lp.LPBuilder, T=T) for T in (48, 40)]
    solvers = [pdhg.CompiledLPSolver(lp, pdhg.PDHGOptions(), device=cuda)
               for lp in lps]
    configs = {fused_chunk.config_for(lp.m, lp.n, (), s.op.compact,
                                      "reflected")
               for lp, s in zip(lps, solvers)}
    assert len(configs) == 1
    errors, outs = [], {}

    def launches(i):
        lp, solver = lps[i], solvers[i]
        B = 8
        C = torch.tensor(price_batch(lp, B), dtype=torch.float32,
                         device=cuda)
        Q, L, U = (torch.tensor(np.broadcast_to(a, (B, a.size)).copy(),
                                dtype=torch.float32, device=cuda)
                   for a in (lp.q, lp.l, lp.u))
        sv = solver._solver
        args = (solver.op, C, Q, L, U, solver.dr, solver.dc)
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                st = sv.init_state(*args)
                t = sv._context(C, Q, L, U, solver.dr, solver.dc)
                for _ in range(300):
                    out = fused_chunk.batched_chunk(
                        solver.op, t.c_s, t.q_s, t.l_s, t.u_s, st.omega,
                        solver.eta, st.x, st.y, st.x_sum, st.y_sum,
                        lp.n_eq, 8, "reflected", ALPHA["reflected"])
                torch.cuda.synchronize()
                outs[i] = out
        except Exception as e:      # the assertion below reports it
            errors.append((i, e))

    threads = [threading.Thread(target=launches, args=(i,))
               for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert all(torch.isfinite(a).all() for o in outs.values() for a in o)


@pytest.mark.cuda
def test_wrapper_rejects_wrong_dtype(cuda):
    lp = LPS["dense"](port_lp.LPBuilder)
    solver = pdhg.CompiledLPSolver(lp, device=cuda)
    x = torch.zeros(2, lp.n, dtype=torch.float64, device=cuda)
    f = torch.zeros(2, lp.n, device=cuda)
    g = torch.zeros(2, lp.m, device=cuda)
    s = torch.ones(2, device=cuda)
    with pytest.raises(TypeError):
        fused_chunk.batched_chunk(solver.op, f, g, f, f, s, solver.eta, x, g,
                                  f, g, lp.n_eq, 4)


def _small_case(hours=72):
    case = benchlib.synthetic_case()
    case.scenario["allow_partial_year"] = True
    case.datasets.time_series = case.datasets.time_series.iloc[:hours]
    return case


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b) / np.maximum(np.abs(b), 1.0)


@pytest.mark.cuda
def test_run_design_on_card_matches_cpu(cuda):
    """A 12-candidate screen with one refinement round and 3 certified
    finalists on the card: the CPU run's finalists, certified totals
    within 2e-4, the screen never certificate-stamped, and the kernels
    launched."""
    from dervet_tpu_torch import design
    spec = design.DesignSpec(
        bounds={("Battery", "1"): design.DERBounds(kw=(500.0, 2500.0),
                                                   kwh=(1000.0, 9000.0))},
        population=12, top_k=3, refine_rounds=1)
    fused_chunk.reset_launch_counts()
    card = design.run_design(_small_case(), spec, device=cuda)
    launches = sum(fused_chunk.LAUNCHES.values())
    host = design.run_design(_small_case(), spec, device="cpu")
    assert launches > 0
    assert card.all_finalists_certified
    assert card.screen["certification_stamped"] is False
    assert list(card.frontier["candidate"]) == \
        list(host.frontier["candidate"])
    assert _rel(card.frontier["total"], host.frontier["total"]).max() < 2e-4
    assert all(g["device"] == "cuda:0" for g in card.solve_ledger["groups"]
               if g.get("backend") == "torch")


@pytest.mark.cuda
def test_run_montecarlo_on_card_matches_cpu(cuda):
    """An 8-sample Monte-Carlo on the card: the CPU run's pinned samples,
    screening objectives within 1e-3 and certified ones within 2e-4, and
    a byte-identical replay on shared caches."""
    from dervet_tpu_torch import design, stochastic
    from dervet_tpu_torch.scenario.scenario import SolverCache
    spec = stochastic.MCSpec(n_samples=8, seed=3, alpha=0.75,
                             quantiles=(0.5,))
    caches = design.ScreeningCaches(device=cuda)
    final = SolverCache(pad_grid=True, memory=caches.memory, device=cuda)
    fused_chunk.reset_launch_counts()
    card = stochastic.run_montecarlo(_small_case(), spec, device=cuda,
                                     caches=caches, final_cache=final)
    assert sum(fused_chunk.LAUNCHES.values()) > 0
    again = stochastic.run_montecarlo(_small_case(), spec, device=cuda,
                                      caches=caches, final_cache=final)
    host = stochastic.run_montecarlo(_small_case(), spec, device="cpu")
    assert card.to_json() == again.to_json()
    assert card.pinning_all_certified
    a, b = card.samples, host.samples
    assert list(a["tier"]) == list(b["tier"])
    screen = (b["tier"] == "screening").to_numpy()
    assert _rel(a["objective"][screen], b["objective"][screen]).max() < 1e-3
    assert _rel(a["objective"][~screen], b["objective"][~screen]).max() \
        < 2e-4


@pytest.mark.cuda
def test_service_on_card_coalesces_two_requests(cuda):
    """The scenario service with ``device=None``, the card warmed as
    ``start`` warms it, serves two requests (3 + 5 January windows with the
    daily-cycle rows, 776 x 2976, the shape and batch 8 ``chip_smoke.py``
    phase 2 checks) in one round driven from another thread: one
    cross-request group on the banded kernel, every window certified,
    objectives within 1e-6 of a solo solve of the same cases on the
    card."""
    import threading

    from dervet_tpu_torch.api import DERVET
    from dervet_tpu_torch.device import warmup_device
    from dervet_tpu_torch.service import ScenarioService

    def cases(n):
        return dict(enumerate(benchlib.synthetic_sensitivity_cases(
            n, months=1, daily_cycle_limit=1)))

    # warmed as ``start`` warms it, with no batcher thread: this thread
    # drives the round on another
    svc = ScenarioService(max_wait_s=0.0)
    svc.device_info = warmup_device(svc.device)
    assert svc.device == cuda
    assert svc.device_info["platform"] == "gpu"
    assert svc.device_info["device_kind"] == torch.cuda.get_device_name(0)
    fa = svc.submit(cases(3), request_id="a")
    fb = svc.submit(cases(5), request_id="b")
    fused_chunk.reset_launch_counts()
    served = []
    t = threading.Thread(target=lambda: served.append(svc.run_once()))
    t.start()
    t.join()
    launches = dict(fused_chunk.LAUNCHES)
    assert served == [2]
    (g,) = svc.last_round_ledger["groups"]
    assert (g["m"], g["n"], g["batch"], g["kernel"]) == \
        (776, 2976, 8, fused_chunk.KERNEL_BANDED)
    assert sorted(g["requests"]) == ["a", "b"] and g["device"] == "cuda:0"
    assert launches[fused_chunk.KERNEL_BANDED] == g["kernel_launches"] > 0
    res = fb.result(0)
    assert fa.result(0).run_health["certification"]["windows_certified"] \
        == 3
    assert res.run_health["certification"]["windows_certified"] == 5
    solo = DERVET.from_cases(cases(5)).solve(backend="torch")
    for k, inst in solo.instances.items():
        want = inst.objective_values["Total Objective"].to_numpy()
        got = res.instances[k].objective_values["Total Objective"].to_numpy()
        assert _rel(got, want).max() < 1e-6
    svc.close()


@pytest.mark.cuda
def test_spawned_replica_serves_on_card(cuda, tmp_path):
    """A spawned port replica (``python -m dervet_tpu_torch serve
    --device cuda:0``) behind the fleet router serves one request (3
    January windows with the daily-cycle rows) on the card: every window
    certified, every device group on cuda:0 with kernel launches."""
    import json

    from dervet_tpu_torch.service import FleetRouter, spawn_replica
    log = open(tmp_path / "replica.log", "w")
    rep = spawn_replica(tmp_path / "r0", name="r0", device="cuda:0",
                        stdout=log, stderr=log)
    router = FleetRouter([rep], fleet_dir=tmp_path / "fleet",
                         heartbeat_timeout_s=120.0).start()
    try:
        cases = dict(enumerate(benchlib.synthetic_sensitivity_cases(
            3, months=1, daily_cycle_limit=1)))
        res = router.submit(cases, request_id="g0",
                            deadline_s=600.0).result(timeout=600)
        assert res.replica == "r0"
        health = res.load_run_health()
        assert health["certification"]["windows_certified"] == 3
        assert health["windows"]["cpu_fallback"] == 0
        led = json.loads((res.results_dir / "solve_ledger.g0.json")
                         .read_text())
        dev = [g for g in led["groups"] if g.get("backend") == "torch"]
        assert dev and all(g["device"] == "cuda:0" for g in dev)
        assert sum(g["kernel_launches"] for g in dev) > 0
    finally:
        router.close()
        log.close()


@pytest.mark.cuda
def test_two_elastic_workers_on_card_byte_identical(cuda, monkeypatch):
    """The elastic scheduler with two workers on cuda:0 (the device seam;
    each worker on a CUDA stream of its own, slot 1 a straggler) answers
    bit for bit as one worker does, and steals slot 1's queued group
    (four months: three groups, of which slot 1 is placed two; under the
    straggler drill every group is placed before the workers start)."""
    from dervet_tpu_torch.api import DERVET
    from dervet_tpu_torch.parallel import elastic
    from dervet_tpu_torch.utils import faultinject

    def solve():
        cases = benchlib.synthetic_sensitivity_cases(8, months=4,
                                                     daily_cycle_limit=1)
        return DERVET.from_cases(cases).solve(backend="torch")

    monkeypatch.delenv(elastic.ELASTIC_ENV, raising=False)
    monkeypatch.setenv(elastic.ELASTIC_DEVICES_ENV, "1")
    one = solve()
    monkeypatch.delenv(elastic.ELASTIC_DEVICES_ENV)
    monkeypatch.setattr(elastic, "visible_devices",
                        lambda device=None: [cuda, cuda])
    with faultinject.inject(straggler=True, straggler_device=1,
                            straggler_seconds=10.0):
        two = solve()
    el = two.solve_ledger["elastic"]
    assert el["n_devices"] == 2 and el["n_steals"] >= 1, el
    assert one.solve_ledger["elastic"]["n_devices"] == 1
    for k, inst in one.instances.items():
        a, b = inst.scenario, two.instances[k].scenario
        assert a.objective_values == b.objective_values
        for name in a._solution:
            assert np.array_equal(a._solution[name], b._solution[name])
    groups = [g for g in two.solve_ledger["groups"]
              if g.get("backend") == "torch"]
    assert groups and all(g["kernel"] == fused_chunk.KERNEL_BANDED
                          and g["kernel_launches"] > 0 for g in groups)


def _overlapping_streams(intervals) -> tuple[float, set]:
    """Of device intervals ``[(stream, start, end)]``: the time during
    which intervals of two streams run at once, and those streams."""
    total, pairs = 0.0, set()
    reach: dict = {}
    for st, a, b in sorted(intervals, key=lambda iv: iv[1]):
        for other, end in reach.items():
            if other != st and end > a:
                total += min(end, b) - a
                pairs.add(frozenset((st, other)))
        reach[st] = max(reach.get(st, a), b)
    return total, pairs


def pipeline_overlap_check(device="cuda:0"):
    """The body of ``test_pipeline_groups_overlap_on_their_streams``, run
    in a process of its own: it asserts, and prints what it read."""
    import os

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dervet_tpu_torch.api import DERVET
    from dervet_tpu_torch.parallel import elastic
    from dervet_tpu_torch.scenario import scenario

    cuda = torch.device(device)

    def solve():
        cases = benchlib.synthetic_sensitivity_cases(24, months=3,
                                                     retail=True)
        return DERVET.from_cases(cases).solve(backend="torch", device=cuda)

    os.environ[scenario.PIPELINE_ENV] = "0"
    serial = solve()
    del os.environ[scenario.PIPELINE_ENV]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        piped = solve()
        torch.cuda.synchronize()
    chunks = [(ev.device_resource_id(), ev.start_ns() * 1e-9,
               (ev.start_ns() + ev.duration_ns()) * 1e-9)
              for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == DeviceType.CUDA
              and "dense_chunk_kernel" in ev.name()]
    both, pairs = _overlapping_streams(chunks)
    busy = sum(b - a for _, a, b in chunks)
    led = piped.solve_ledger
    print(f"chunk kernels {len(chunks)} on {len({c[0] for c in chunks})} "
          f"streams, {busy:.3f} s, {both:.3f} s on two streams at once; "
          + ", ".join(f"{k} {led[k]}" for k in scenario.PIPELINE_KEYS))
    groups = [g for g in led["groups"] if g.get("rung") == "initial"]
    assert len(groups) == 3 and all(
        g["batch"] == 24 and g["kernel"] == fused_chunk.KERNEL_DENSE
        for g in groups), groups
    assert both > 0 and pairs, (both, pairs)
    assert led["inflight_peak"] >= 2 and led["worker_streams"] >= 2, led
    # the workers hand their streams back, and the next dispatch reuses them
    assert len(elastic._idle_streams[cuda]) <= scenario.PIPELINE_MAX_INFLIGHT
    assert serial.solve_ledger["inflight_peak"] == 1
    for k, inst in serial.instances.items():
        a, b = inst.scenario, piped.instances[k].scenario
        assert a.objective_values == b.objective_values
        for name in a._solution:
            assert np.array_equal(a._solution[name], b._solution[name]), name


@pytest.mark.cuda
def test_pipeline_groups_overlap_on_their_streams(cuda):
    """A three-month demand-charge fan-out at B = 24 (three dense groups)
    through the single-card pipeline: the dense chunk kernels of two
    groups run at once, as intervals of two worker streams that intersect
    in the profiler's record (a worker runs one group at a time on its
    stream, and a group's capture stream waits on its worker's), every
    answer is bit-identical to ``DERVET_TPU_PIPELINE=0``, and the ledger
    reads two groups in flight or more.

    It runs in a child process: after a profiler run that spans graph
    captures, later profiler runs of the same process on an H100 (CUDA
    12) miss the chunk kernels of graphs captured in between, which
    ``test_window_launches_only_the_kernels`` counts."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from dervet_tpu_torch.scenario import scenario

    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location("
            "'card_tests', sys.argv[1])\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "mod.pipeline_overlap_check(sys.argv[2])\n")
    env = {k: v for k, v in os.environ.items()
           if k != scenario.PIPELINE_ENV}
    proc = subprocess.run([sys.executable, "-c", code, __file__, str(cuda)],
                          cwd=Path(__file__).resolve().parents[1], env=env,
                          capture_output=True, text=True, timeout=900)
    print(proc.stdout[-4000:])
    assert proc.returncode == 0, proc.stderr[-8000:]


@pytest.mark.cuda
def test_sharded_batch_on_card(cuda):
    """``solve_batch_sharded`` over [cuda:0, cuda:0] on the main 31-day
    structure at an odd batch: objectives within 1e-5 of the unsharded
    card solve, the same converged count, and chunk-kernel launches."""
    from dervet_tpu_torch.parallel import solve_batch_sharded
    lp = benchlib.window_lps(benchlib.synthetic_case(
        daily_cycle_limit=1))[0]
    solver = pdhg.CompiledLPSolver(
        lp, pdhg.PDHGOptions(cpu_rescue_after=None), device=cuda)
    C = price_batch(lp, 33, seed=4)
    ref = solver.solve(c=C)
    fused_chunk.reset_launch_counts()
    res, st = solve_batch_sharded(solver, [cuda, cuda], c=C)
    assert fused_chunk.LAUNCHES[fused_chunk.KERNEL_BANDED] > 0
    a, b = res.obj.cpu().numpy(), ref.obj.cpu().numpy()
    assert np.all(np.abs(a - b) <= 1e-4 + 1e-5 * np.abs(b))
    assert st.n_converged == int(ref.converged.sum())
    assert res.x.device == cuda and res.x.shape == (33, lp.n)


@pytest.mark.cuda
def test_price_draw_stays_on_card(cuda):
    """``scenario_price_batch_device`` draws on the cost matrix's own
    device: the result lies on the card, window-major, zero where the
    base cost is zero, and the same for the same seed."""
    _, groups = benchlib.build_window_lps(benchlib.synthetic_case())
    c = torch.as_tensor(np.stack([lp.c for lp in groups[744][:3]]),
                        dtype=torch.float32, device=cuda)
    out = benchlib.scenario_price_batch_device(c, 16, seed=31)
    assert out.device == cuda and out.shape == (48, c.shape[1])
    zero = (c == 0).repeat_interleave(16, dim=0)
    assert torch.equal(out == 0, zero)
    assert torch.equal(out, benchlib.scenario_price_batch_device(c, 16, 31))


@pytest.mark.cuda
def test_device_resident_batch_moves_no_bytes(cuda):
    """A solve of the 31-day bands-only window with C drawn on the card
    and Q, L, U placed there records no host-to-device bytes, converges
    and launches the banded kernel."""
    _, groups = benchlib.build_window_lps(benchlib.synthetic_case())
    lp = groups[744][0]
    solver = pdhg.CompiledLPSolver(lp, pdhg.PDHGOptions(), device=cuda)
    c = torch.as_tensor(lp.c[None], dtype=torch.float32, device=cuda)
    C = benchlib.scenario_price_batch_device(c, 40, seed=3)
    Q, L, U = (torch.as_tensor(np.tile(a, (40, 1)), dtype=torch.float32,
                               device=cuda) for a in (lp.q, lp.l, lp.u))
    st = pdhg.SolveStats()
    res = solver.solve(c=C, q=Q, l=L, u=U, stats=st)
    assert st.h2d_bytes == 0 and st.h2d_transfers == 0
    assert st.kernel_launches > 0 and bool(res.converged.all())
    assert res.x.device == cuda


def solve_inputs(solver, C):
    """``c, q, l, u`` of the batch priced by ``C`` on the solver's device,
    as ``CompiledLPSolver.solve`` places them."""
    lp, dev = solver.lp, solver.device
    c = torch.tensor(C, dtype=torch.float32, device=dev)
    q, l, u = (torch.tensor(a, dtype=torch.float32,
                            device=dev).expand(c.shape[0], -1)
               for a in (lp.q, lp.l, lp.u))
    return c, q, l, u


def functional_solve(solver, C, stats=None):
    """The chunk driver as it ran before the graph runner: the eager
    functional window loop (``_Solver.run_chunk``, the uniform sub-block
    form where it applies), one state read a chunk, and compaction to the
    bucket grid, on the solver's device.  Returns the result and the
    bucket occupancy; ``stats`` takes the loop's instance-window
    counts."""
    sv, op, dev = solver._solver, solver.op, solver.device
    c, q, l, u = solve_inputs(solver, C)
    const = (solver.dr, solver.dc)
    full = cur_state = sv.init_state(op, c, q, l, u, *const)
    idx, cur, total, occupancy = np.arange(c.shape[0]), (c, q, l, u), 0, []
    opts = solver.opts
    while True:
        limit = min(total + opts.compact_chunk_iters, opts.max_iters)
        cur_state = sv.run_chunk(op, *cur, *const, solver.eta, cur_state,
                                 limit, stats)
        act = (~(cur_state.converged | cur_state.infeasible)).cpu().numpy()
        total, n_active = int(cur_state.total.max()), int(act.sum())
        if n_active == 0 or total >= opts.max_iters:
            break
        bucket = pdhg.compaction_bucket(n_active)
        if bucket <= len(idx) // 2:
            sel = np.nonzero(act)[0]
            pad = torch.as_tensor(np.resize(sel, bucket), device=dev)
            occupancy.append((bucket, int(np.unique(idx[sel]).size)))
            full = pdhg._scatter(full, cur_state,
                                 torch.as_tensor(idx, device=dev))
            cur = tuple(a[pad] for a in cur)
            cur_state = pdhg._index(cur_state, pad)
            idx = idx[pad.cpu().numpy()]
    full = pdhg._scatter(full, cur_state, torch.as_tensor(idx, device=dev))
    return sv.finalize(op, c, q, l, u, *const, full), occupancy


def _graph_case(cuda, kind, monkeypatch):
    """A straggler batch (16 instances, a third priced far up, short host
    chunks) on the card: ``kind`` 'banded_wide' (banded kernel), 'dense'
    (dense kernel) or 'ell_residual' (the daily-cycle LP with its wide
    rows in an ELL residual: the plain chunk)."""
    kw = dict(compact_chunk_iters=256, cpu_rescue_after=None,
              max_iters=16384)
    if kind == "ell_residual":
        monkeypatch.setattr(pdhg, "WIDE_MAX_ROWS", 0)
        kw["dense_bytes_limit"] = 0
    lp = LPS["banded_wide" if kind == "ell_residual" else kind](
        port_lp.LPBuilder)
    solver = pdhg.CompiledLPSolver(lp, pdhg.PDHGOptions(**kw), device=cuda)
    C = price_batch(lp, 16, seed=4)
    C[::3] *= np.linspace(20, 60, lp.n)[None]
    return solver, C


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["banded_wide", "dense", "ell_residual"])
def test_graph_solve_equals_eager_on_card(cuda, kind, monkeypatch):
    """Every check window a CUDA-graph replay: two solves (the second, of
    other prices, replaying the first's graphs and capturing none)
    bit-equal to the eager window loop on the card, with the same
    compactions, a status read after each window, and as many kernel
    launches once the warm-ups before the captures are set apart."""
    solver, C = _graph_case(cuda, kind, monkeypatch)
    assert solver._solver.use_kernel == (kind != "ell_residual")
    for rep, prices in enumerate((C, C[::-1].copy())):
        fused_chunk.reset_launch_counts()
        ref, occupancy = functional_solve(solver, prices)
        torch.cuda.synchronize()
        eager_launches = sum(fused_chunk.LAUNCHES.values())
        st = pdhg.SolveStats()
        fused_chunk.reset_launch_counts()
        res = solver.solve(c=prices, stats=st)
        torch.cuda.synchronize()
        for f in pdhg.PDHGResult._fields:
            assert torch.equal(getattr(res, f), getattr(ref, f)), (rep, f)
        assert st.bucket_occupancy == occupancy
        assert st.check_windows == st.graph_replays > 0
        assert st.readbacks == st.check_windows + st.chunks
        assert sum(fused_chunk.LAUNCHES.values()) == st.kernel_launches
        assert st.kernel_launches - st.warmup_launches == eager_launches
        if kind != "ell_residual":
            assert eager_launches > 0
        if rep == 0:
            # one graph a (batch width, sub-block count): widths 16 and 8,
            # counts 1, 2 and 4
            assert 1 <= st.graph_captures <= 2 * 3 and st.capture_s > 0
        else:
            assert st.graph_captures == st.warmup_launches == 0


@pytest.mark.cuda
def test_two_threads_capture_at_once(cuda, monkeypatch):
    """Two solvers solve from two threads at once, each thread on a
    CUDA stream of its own on cuda:0 (the elastic workers' case), each
    capturing its first windows while the other launches work (the
    captures take turns on the device's capture stream); each answer
    equals the eager window loop's."""
    import threading
    cases = [_graph_case(cuda, k, monkeypatch) for k in ("banded_wide",
                                                         "dense")]
    refs = [functional_solve(solver, C)[0] for solver, C in cases]
    gate, outs, errors = threading.Barrier(2), {}, []

    def run(i):
        solver, C = cases[i]
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda)):
                gate.wait(timeout=60)
                st = pdhg.SolveStats()
                outs[i] = solver.solve(c=C, stats=st), st
                torch.cuda.synchronize()
        except Exception as e:      # the assertion below reports it
            errors.append((i, e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    for i, ref in enumerate(refs):
        res, st = outs[i]
        assert st.graph_captures >= 1 and st.graph_replays == st.check_windows
        for f in pdhg.PDHGResult._fields:
            assert torch.equal(getattr(res, f), getattr(ref, f)), (i, f)


@pytest.mark.cuda
def test_dropped_solver_frees_its_graphs(cuda, monkeypatch):
    """A solver's runners, their buffers and its graph pool go with it:
    after it is dropped the card holds what it held before.  A first
    solver, dropped before the count, gives this thread's capture stream
    its cuBLAS workspace, which lives as long as the process."""
    import gc

    def solve_and_drop():
        solver, C = _graph_case(cuda, "dense", monkeypatch)
        st = pdhg.SolveStats()
        solver.solve(c=C, stats=st)
        torch.cuda.synchronize()
        assert st.graph_captures >= 1
        return torch.cuda.memory_allocated(cuda)

    solve_and_drop()
    gc.collect()
    torch.cuda.empty_cache()
    alloc0 = torch.cuda.memory_allocated(cuda)
    reserved0 = torch.cuda.memory_reserved(cuda)
    held = solve_and_drop()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert held > alloc0
    assert torch.cuda.memory_allocated(cuda) == alloc0
    assert torch.cuda.memory_reserved(cuda) <= reserved0


# The check window in the kernels, at the shapes it runs: the sweep's
# monthly window (745 x 2976, a register configuration), a banded LP over
# 2,304 rows that only the shared-state configuration takes (2500 x 7200,
# the daily-cycle rows as its wide pair) and a dense op (49 x 144)
WINDOW_LPS = {
    "monthly": lambda: benchlib.build_window_lps(
        benchlib.synthetic_case())[1][744][0],
    "shared": lambda: banded_lp(port_lp.LPBuilder, T=2400, daily_rows=True),
    "dense": lambda: mixed_lp(port_lp.LPBuilder),
}
_window_lps: dict = {}
# The check kernel sums each reduction in float64, the plain window in
# float32 in other orders: the scalars they give (mu, the primal weight)
# differ by rounding, within CHECK_RTOL of the scale of the terms that
# produced them; the vectors are selects of the same float32 values
# (x_sum / inner divides alike), within VECTOR_RTOL.  A decision is held
# equal where its margin to the threshold, over that scale, exceeds
# DECISION_TOL.
CHECK_RTOL = 1e-4
VECTOR_RTOL = 1e-6
DECISION_TOL = 1e-4
_FLAG_FIELDS = ("inner", "total", "converged", "iters_at_conv",
                "infeas_streak", "infeasible", "restarts", "cadence")
_VECTOR_FIELDS = ("x", "y", "x_sum", "y_sum", "x_restart", "y_restart",
                  "done_x", "done_y")


def window_lp(kind):
    if kind not in _window_lps:
        _window_lps[kind] = WINDOW_LPS[kind]()
    return _window_lps[kind]


def window_solver(kind, device, variant="reflected", scheme="auto",
                  adaptive=True, **kw):
    """A solver of the ``kind`` LP: adaptive cadence (sub-blocks of 32
    iterations, windows of 32-128) or fixed (windows of 32)."""
    opts = pdhg.PDHGOptions(variant=variant, restart_scheme=scheme,
                            check_every=128 if adaptive else 32,
                            check_every_min=32, **kw)
    return pdhg.CompiledLPSolver(window_lp(kind), opts, device=device)


def mixed_window_state(solver, B=48, seed=0):
    """A batch of every kind of instance a check window meets, from a
    seeded mid-solve state (per-instance prices, 96 iterations): an
    eighth each converged, certified infeasible and at the chunk's limit,
    the rest active, with random inner counts (artificial restarts),
    restart scores (restarts or none), infeasibility streaks and, under
    the adaptive cadence, cadences of 1, 2 and 4 sub-blocks (held
    instances).  Returns (state, (c, q, l, u), limit as a device int32
    scalar)."""
    sv, lp, dev = solver._solver, solver.lp, solver.device
    rng = np.random.default_rng(seed)
    c, q, l, u = (a.contiguous() for a in
                  solve_inputs(solver, price_batch(lp, B, seed)))
    args = (solver.op, c, q, l, u, solver.dr, solver.dc)
    s = sv.run_chunk(*args, solver.eta, sv.init_state(*args), 96)
    h = {f: getattr(s, f).cpu().numpy().copy() for f in pdhg._State._fields}
    limit = int(h["total"].max()) + 4096
    kind = np.arange(B) % 8
    h["converged"] |= kind == 1
    h["iters_at_conv"] = np.where(kind == 1, h["total"], h["iters_at_conv"])
    h["infeasible"] |= kind == 2
    h["total"] = np.where(kind == 3, limit, h["total"]).astype(np.int32)
    h["inner"] = rng.integers(0, h["total"] + 1).astype(np.int32)
    h["mu_restart"] = (h["mu_restart"]
                       * rng.lognormal(0.0, 1.5, B)).astype(np.float32)
    h["mu_prev"] = (h["mu_prev"] * rng.lognormal(0.0, 0.5, B)
                    ).astype(np.float32)
    h["infeas_streak"] = rng.integers(0, 4, B).astype(np.int32)
    if sv.adaptive:
        h["cadence"] = (sv.sub * rng.choice([1, 2, 4], B)).astype(np.int32)
    state = pdhg._State(**{f: torch.as_tensor(v, device=dev)
                           for f, v in h.items()})
    return state, (c, q, l, u), torch.tensor(limit, dtype=torch.int32,
                                             device=dev)


def _rel_margin(a, b, scale):
    return (a - b).abs() / scale.clamp_min(1e-30)


def decision_margins(sv, op, t, s, adv, eta, dr, dc):
    """(B,) the smallest margin, over the scale of its terms, of every
    decision the check takes from the window's start ``s`` and the
    advanced iterates ``adv`` (x, y, x_sum, y_sum): the average against
    the current iterate, the three convergence tests, the Farkas
    certificate's three, the restart tests and the primal weight's
    movement tests; computed with the plain window's own pieces."""
    o = sv.opts
    x, y, xs, ys = adv
    n_sub = sv._n_sub(s)
    inner = s.inner + n_sub * sv.sub
    fin = inner.to(x.dtype)[:, None]
    xa, ya = xs / fin, ys / fin
    mu_c, cur = sv._mu(op, t, x, y, dr, dc)
    mu_a, avg = sv._mu(op, t, xa, ya, dr, dc)

    def scale(terms):
        pr, du, gp, po, do = terms
        return pr + du + (po.abs() + do.abs()) / (1.0 + po.abs() + do.abs())
    sc_mu = torch.maximum(scale(cur), scale(avg))
    out = [_rel_margin(mu_a, mu_c, sc_mu)]
    use = mu_a < mu_c
    pr, du, gp, po, do = (torch.where(use, a, b) for a, b in zip(avg, cur))
    rp = o.eps_abs + o.eps_rel * t.q_norm
    rd = o.eps_abs + o.eps_rel * t.c_norm
    rg = o.eps_abs + o.eps_rel * (po.abs() + do.abs())
    out += [_rel_margin(pr, rp, pr + rp), _rel_margin(du, rd, du + rd),
            _rel_margin(gp, rg, po.abs() + do.abs() + o.eps_abs)]
    fk_gap, fk_viol, ynorm = pdhg._farkas_gap(op, y, t.q_us, t.l_us, t.u_us,
                                              dr, dc)
    ref = o.eps_infeas * (1.0 + t.q_norm)
    den = ynorm.clamp_min(1e-12)[:, None]
    ray = pdhg.op_rmatvec(op, y) / dc / den
    lf, uf = torch.isfinite(t.l_us), torch.isfinite(t.u_us)
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    sc_gap = ((t.q_us * dr * y / den).abs().sum(-1)
              + torch.where(uf, ray.clamp_min(0) * t.u_us, zero).abs().sum(-1)
              + torch.where(lf, ray.clamp_max(0) * t.l_us, zero).abs().sum(-1))
    sc_viol = torch.where(lf & uf, zero, ray.abs()).sum(-1)
    out += [_rel_margin(fk_gap, ref, sc_gap + ref),
            _rel_margin(fk_viol, ref, sc_viol + ref),
            _rel_margin(ynorm, torch.ones_like(ynorm), ynorm + 1.0)]
    if sv.fp_scheme:
        xT, yT = sv.pdhg_step(op, t, s.omega, eta, x, y)
        track = torch.sqrt(((xT - x) ** 2).sum(-1) + ((yT - y) ** 2).sum(-1))
        sc_tr = track + 1e-3 * (_norm(x) + _norm(y))
        dx, dy = _norm(x - s.x_restart), _norm(y - s.y_restart)
    else:
        track, sc_tr = torch.minimum(mu_a, mu_c), sc_mu
        dx = _norm(torch.where(use[:, None], xa, x) - s.x_restart)
        dy = _norm(torch.where(use[:, None], ya, y) - s.y_restart)
    for thr in (o.fp_beta_sufficient if sv.fp_scheme else o.beta_sufficient,
                o.beta_necessary):
        out.append(_rel_margin(track, thr * s.mu_restart, sc_tr))
    out.append(_rel_margin(track, s.mu_prev, sc_tr))
    tiny = torch.full_like(dx, 1e-10)
    out += [_rel_margin(dx, tiny, dx + tiny), _rel_margin(dy, tiny, dy + tiny)]
    return torch.stack(out).min(0).values, sc_mu, sc_tr


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def _field(s, f):
    return getattr(s, f).cpu().numpy()


def check_window_comparison(device, kind, variant, scheme, adaptive,
                            B=48, seed=0, converging=False):
    """``window_comparison`` on a ``window_solver`` of ``kind``."""
    return window_comparison(window_solver(kind, device, variant, scheme,
                                           adaptive), B, seed, converging)


def window_comparison(solver, B=48, seed=0, converging=False):
    """One check window of ``solver`` (on the card) from
    ``mixed_window_state`` through the kernels (``_Solver.window``) and
    through the plain window (kernel chunks, PyTorch check, select):
    returns a summary, asserting what
    ``test_check_kernel_matches_plain_window`` states.  ``converging``:
    the window checks at ``eps_abs`` 0 and an ``eps_rel`` at the median,
    over the active instances, of the worst of their three relative KKT
    errors, so that about half of them converge in it.  ``chip_smoke.py``
    runs it at the main path's shapes and batches."""
    s, inputs, lim = mixed_window_state(solver, B, seed)
    sv = solver._solver
    t = sv._context(*inputs, solver.dr, solver.dc)
    n_max = int(sv.plain_status(s, lim)[1])
    if converging:
        x, y, xs, ys = sv.advance(solver.op, t, s, solver.eta, sv._n_sub(s),
                                  n_max, False)
        _, (pr, du, gp, po, do) = sv._mu(solver.op, t, x, y, solver.dr,
                                         solver.dc)
        worst = torch.stack([pr / t.q_norm, du / t.c_norm,
                             gp / (po.abs() + do.abs())]).max(0).values
        active = ~s.converged & ~s.infeasible & (s.total < lim)
        solver = solver.with_options(dataclasses.replace(
            solver.opts, eps_abs=0.0,
            eps_rel=float(worst[active].median())))
    sv, op = solver._solver, solver.op
    dr, dc, eta = solver.dr, solver.dc, solver.eta
    assert sv.on_card(s.x)
    adv = sv.advance(op, t, s, eta, sv._n_sub(s), n_max, False)
    ref = sv.plain_window(op, t, s, eta, dr, dc, lim, n_max)
    new = sv.window(op, t, s, eta, dr, dc, lim, n_max)
    # the status kernel computes the plain status of the state it is given
    assert torch.equal(sv.status(new, lim), sv.plain_status(new, lim))
    assert torch.equal(sv.status(s, lim), sv.plain_status(s, lim))
    active = (~s.converged & ~s.infeasible & (s.total < lim)).cpu().numpy()
    held = active & (sv._n_sub(s).cpu().numpy() < n_max)
    assert active.sum() and (~active).sum()
    assert held.sum() if sv.adaptive else n_max == 1
    # inactive instances: every field as it was, in both
    for f in pdhg._State._fields:
        a, r, s0 = _field(new, f), _field(ref, f), _field(s, f)
        assert np.array_equal(a[~active], s0[~active]), f
        assert np.array_equal(r[~active], s0[~active]), f
    margin, sc_mu, sc_tr = (v.cpu().numpy() for v in
                            decision_margins(sv, op, t, s, adv, eta, dr, dc))
    sure = active & (margin > DECISION_TOL)
    assert sure.sum() >= 0.75 * active.sum(), (sure.sum(), active.sum())
    for f in _FLAG_FIELDS:
        a, r = _field(new, f), _field(ref, f)
        assert np.array_equal(a[sure], r[sure]), (f, a[sure], r[sure])
    for f in _VECTOR_FIELDS:
        assert_close_rows(_field(new, f)[sure], _field(ref, f)[sure], f,
                          rtol=VECTOR_RTOL, atol=0.0)
    a, r = _field(new, "omega")[sure], _field(ref, "omega")[sure]
    assert np.all(np.abs(a - r) <= CHECK_RTOL * np.abs(r)), ("omega", a, r)
    sc = np.maximum(sc_mu, sc_tr)[sure]
    for f in ("mu_restart", "mu_prev"):
        a, r = _field(new, f)[sure], _field(ref, f)[sure]
        finite = np.isfinite(r)
        assert np.array_equal(finite, np.isfinite(a)), f
        assert np.all(np.abs(a - r)[finite] <= CHECK_RTOL * sc[finite]), \
            (f, a, r)
    restarted = (_field(ref, "restarts") > _field(s, "restarts"))[sure]
    converged = (_field(ref, "converged") & ~_field(s, "converged"))[sure]
    return dict(active=int(active.sum()), held=int(held.sum()),
                sure=int(sure.sum()), restarted=int(restarted.sum()),
                converged=int(converged.sum()), n_max=n_max)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(WINDOW_LPS))
@pytest.mark.parametrize("variant", sorted(ALPHA))
@pytest.mark.parametrize("scheme", ["kkt", "fixed_point"])
@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "fixed"])
def test_check_kernel_matches_plain_window(cuda, kind, variant, scheme,
                                           adaptive):
    """One check window of a batch that mixes active, converged,
    infeasible, over-limit and held instances, through the chunk kernels
    with their activity predicate and the check kernel, against the plain
    window (the chunk kernels without the predicate, PyTorch's check and
    select) and the plain status: inactive instances bit-equal to their
    start in both; where every decision's margin exceeds DECISION_TOL
    (at least three quarters of the active instances), every flag and
    count equal, the vectors within VECTOR_RTOL and the scalars within
    CHECK_RTOL (float64 against float32 reduction order)."""
    out = check_window_comparison(cuda, kind, variant, scheme, adaptive)
    print(kind, variant, scheme, adaptive, out)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(WINDOW_LPS))
@pytest.mark.parametrize("scheme", ["kkt", "fixed_point"])
def test_check_kernel_converges_as_plain_window(cuda, kind, scheme):
    """As ``test_check_kernel_matches_plain_window``, the window checking
    at a tolerance half of the active instances meet: they converge in
    it, and their frozen answers (``done_x``, ``done_y``) and
    ``iters_at_conv`` agree."""
    out = check_window_comparison(cuda, kind, "reflected", scheme, True,
                                  converging=True)
    print(kind, scheme, out)
    assert out["converged"] > 0


def predicate_comparison(device, kind, variant, B=48, seed=1):
    """A window's sub-blocks through the chunk kernels with the activity
    predicate, in place, against the plain window's advance (the kernels
    on every instance, then selects): returns (active, held) counts."""
    solver = window_solver(kind, device, variant)
    sv, op = solver._solver, solver.op
    s, inputs, lim = mixed_window_state(solver, B, seed)
    t = sv._context(*inputs, solver.dr, solver.dc)
    n_max = int(sv.plain_status(s, lim)[1])
    n_sub = sv._n_sub(s)
    ref = sv.advance(op, t, s, solver.eta, n_sub, n_max, False)
    new = s.map(torch.clone)
    for j in range(n_max):
        fused_chunk.window_chunk(op, t, new, solver.eta, lim, sv.n_eq,
                                 sv.sub, j, sv.adaptive, sv.variant,
                                 sv.alpha)
    active = (~s.converged & ~s.infeasible & (s.total < lim)).cpu().numpy()
    held = active & (n_sub.cpu().numpy() < n_max)
    assert active.sum() and (~active).sum() and held.sum()
    for f, r in zip(("x", "y", "x_sum", "y_sum"), ref):
        a, r, s0 = _field(new, f), r.cpu().numpy(), _field(s, f)
        assert np.array_equal(a[active], r[active]), f
        assert np.array_equal(a[~active], s0[~active]), f
    for f in pdhg._State._fields:
        if f not in ("x", "y", "x_sum", "y_sum"):
            assert torch.equal(getattr(new, f), getattr(s, f)), f
    return int(active.sum()), int(held.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(WINDOW_LPS))
@pytest.mark.parametrize("variant", sorted(ALPHA))
def test_chunk_predicate_equals_advance(cuda, kind, variant):
    """The chunk kernels with the activity predicate, in place, give the
    plain window's advance bit for bit: active instances its rows (held
    ones after their own sub-blocks), finished and over-limit ones their
    start; nothing but x, y and the sums is written."""
    print(kind, variant, predicate_comparison(cuda, kind, variant))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["monthly", "dense"])
def test_kernel_window_solve_matches_plain_window(cuda, kind, monkeypatch):
    """A whole solve (64 price scenarios, graphs and compaction) with the
    check window in the kernels against the same solve with the plain
    window: the same statuses, objectives within the certificate's
    objective tolerance, iteration counts within one window for at least
    95% of the instances; instance-windows skipped by the kernels."""
    from dervet_tpu_torch.ops import certify
    kw = dict(cpu_rescue_after=None)
    solver = pdhg.CompiledLPSolver(window_lp(kind), pdhg.PDHGOptions(**kw),
                                   device=cuda)
    plain = pdhg.CompiledLPSolver(window_lp(kind), pdhg.PDHGOptions(**kw),
                                  device=cuda)
    monkeypatch.setattr(plain._solver, "on_card", lambda x: False)
    C = price_batch(window_lp(kind), 64, seed=6)
    st, pst = pdhg.SolveStats(), pdhg.SolveStats()
    res = solver.solve(c=C, stats=st)
    ref = plain.solve(c=C, stats=pst)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(res.status.cpu().numpy(),
                                  ref.status.cpu().numpy())
    a, b = res.obj.cpu().numpy(), ref.obj.cpu().numpy()
    eps = certify.CertPolicy().eps_obj
    assert np.all(np.abs(a - b) <= eps * np.maximum(np.abs(b), 1.0))
    gap = np.abs(res.iters.cpu().numpy() - ref.iters.cpu().numpy())
    share = float(np.mean(gap <= pdhg.PDHGOptions().check_every))
    print(kind, "iterations within one window:", share, "max gap",
          int(gap.max()), "active share",
          st.as_dict()["active_instance_share"],
          pst.as_dict()["active_instance_share"])
    assert share >= 0.95
    assert st.active_instance_windows < st.instance_windows
    assert st.kernel_launches > 0 and pst.kernel_launches > 0


_WINDOW_KERNEL_NAMES = ("chunk_kernel", "check_window_kernel",
                        "window_status_kernel")


def _device_kernels(fn):
    """The names of the kernels the device ran during ``fn()``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["monthly", "dense"])
def test_window_launches_only_the_kernels(cuda, kind):
    """A check window of a kernel-supported solve runs nothing on the
    device but the hand-written kernels: ``n_max`` chunk launches, the
    check kernel and the status kernel, eagerly and as a graph replay
    (the device's own record, from the profiler), and the graph's launch
    tally holds those three kernels only."""
    solver = window_solver(kind, cuda)
    C = price_batch(window_lp(kind), 32, seed=2)
    solver.solve(c=C)
    runner = solver._runners[32]
    sv = solver._solver
    inputs = tuple(a.contiguous() for a in solve_inputs(solver, C))
    runner.load(*inputs, sv.init_state(solver.op, *inputs, solver.dr,
                                       solver.dc), 4096)
    st = runner.read(pdhg.SolveStats())
    assert st.n_max == 1 and 1 in runner.graphs
    names = _device_kernels(lambda: runner.step(1, pdhg.SolveStats()))
    print(kind, "replay:", names)
    assert len(names) == 3, names
    assert all(any(k in nm for k in _WINDOW_KERNEL_NAMES) for nm in names)
    assert {k for k, *_ in runner.graphs[1].launches} == {
        fused_chunk.kernel_for(solver.op), fused_chunk.KERNEL_CHECK,
        fused_chunk.KERNEL_STATUS}
    names = _device_kernels(lambda: runner._window(2))
    print(kind, "eager:", names)
    assert len(names) == 2 + 2, names
    assert all(any(k in nm for k in _WINDOW_KERNEL_NAMES) for nm in names)


def _self_time(spans, span) -> float:
    """``span``'s duration less the union of its children on its thread."""
    kids = sorted((c["t_start"], c["t_start"] + c["duration_s"])
                  for c in spans if c["parent_id"] == span["span_id"]
                  and c["attrs"]["thread"] == span["attrs"]["thread"])
    lo, hi = span["t_start"], span["t_start"] + span["duration_s"]
    covered, reach = 0.0, lo
    for a, b in kids:
        a, b = max(a, reach), min(b, hi)
        if b > a:
            covered += b - a
            reach = b
    return span["duration_s"] - covered


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["bess_pv_da", "microgrid_ice_chp_rel"])
def test_valuation_phases_cover_their_spans(cuda, config, monkeypatch):
    """On a fan-out of the configuration's traffic (after a small one
    that warms the process), ``valuation`` and ``dispatch`` spend under
    5% of their time outside their children on their own thread: the
    phases below them name where the time goes."""
    from dervet_tpu_torch.api import DERVET
    from dervet_tpu_torch.telemetry import trace as ttrace
    monkeypatch.setenv(ttrace.ENV, "1")
    n, kw = ((64, {}) if config == "bess_pv_da"
             else (32, {"multi_der": True, "reliability": True}))
    DERVET.from_cases(benchlib.synthetic_sensitivity_cases(
        4, months=2, **kw)).solve(backend="torch", device=cuda)
    res = DERVET.from_cases(benchlib.synthetic_sensitivity_cases(
        n, **kw)).solve(backend="torch", device=cuda)
    ttrace.validate_trace(res.trace)
    for name in ("valuation", "dispatch"):
        span, = [s for s in res.trace if s["name"] == name]
        share = _self_time(res.trace, span) / span["duration_s"]
        print(f"{config} {name}: {span['duration_s']:.3f} s, "
              f"self {100 * share:.2f}%")
        assert share < 0.05, (name, share)
