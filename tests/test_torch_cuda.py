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
small LPs, on the ICE + CHP monthly window and on two shapes of the
shared-state configuration (the DA + FR monthly window, a dense block); a full
solve on the card gives the CPU solve's statuses, objectives within the
solver's ``eps_rel`` and iteration counts within one check window.
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
              "dense_block": lambda B: benchlib.dense_block_lp()}


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
