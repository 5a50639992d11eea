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
serves a request on cuda:0.
"""
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
        fused_chunk.dense_chunk(f, g, f, f, s, s, x, g, f, g, solver.op,
                                lp.n_eq, 4)


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
    (four months: three groups, of which slot 1 is placed two)."""
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
