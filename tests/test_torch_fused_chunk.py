"""The chunk kernels' plain versions against the real Pallas kernels.

``DERVET_TPU_PALLAS_INTERPRET=1`` runs the JAX package's Pallas chunk
kernels (``pallas_chunk.batched_chunk``) in interpret mode on the CPU; the
port's ``fused_chunk.batched_chunk`` on CPU tensors runs each CUDA
kernel's plain PyTorch version.  Both get the same operator (the JAX
solver's, through ``op_from_numpy``) and the same mid-solve state, for
the three step variants, dense and banded operators with and without the
wide-row pair, mixed equality/inequality rows, and batches that are not a
multiple of the TPU kernel's instance block.  Tolerance: per instance,
max |port - pallas| <= 1e-6 + 1e-5 max |pallas| (float32 sums in another
order).

Also: the row-index wide pair is ``P @ W``; ``supports`` declines what the
kernels do not take (an ELL residual, a footprint over one block's
shared memory in every thread configuration, compact forms over the
L2-resident budget) and takes the multi-DER window; the cost model
counts K as the kernels store it; and device resolution refuses to fall
back to the CPU.  The CUDA kernels themselves are held against these
plain versions in test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from dervet_tpu.ops import pallas_chunk
from dervet_tpu.ops import pdhg as jpdhg
from dervet_tpu_torch.device import resolve_device
from dervet_tpu_torch.ops import fused_chunk
from dervet_tpu_torch.ops import pdhg

from test_torch_cuda import (ALPHA, ROUNDING_FACTOR, ROUNDING_FLOOR,
                             assert_close_rows, plain_chunk_as, price_batch,
                             random_state, rel_gap, rounding_spread)
from test_torch_pdhg import jax_leaves, lp_pair

torch.set_num_threads(2)

ITERS = 16


def shared_inputs(kind, B, variant):
    """(JAX solver, JAX chunk inputs, port op + chunk inputs) from one
    mid-solve state: the JAX solver's cold start advanced one check
    window, plus a mid-window halpern inner count."""
    import jax.numpy as jnp
    jlp, _ = lp_pair(kind)
    js = jpdhg.CompiledLPSolver(jlp, jpdhg.PDHGOptions(pallas_chunk=False))
    C = price_batch(jlp, B)
    Cj, Q, L, U = js.batch_data(B, jnp.asarray(C, jnp.float32),
                                jnp.asarray(jlp.q, jnp.float32),
                                jnp.asarray(jlp.l, jnp.float32),
                                jnp.asarray(jlp.u, jnp.float32))
    args = (js.op, Cj, Q, L, U, js.dr, js.dc)
    st = js._jit_chunk_b(*args, js.eta, js._jit_init_b(*args), np.int32(32))
    dc, dr = np.asarray(js.dc), np.asarray(js.dr)
    # the scaled data the chunk iterates on (pdhg._context)
    c_s = np.asarray(Cj) * dc
    q_s = np.asarray(Q) * dr
    l_s = np.where(np.isfinite(np.asarray(L)), np.asarray(L) / dc,
                   np.asarray(L))
    u_s = np.where(np.isfinite(np.asarray(U)), np.asarray(U) / dc,
                   np.asarray(U))
    k = np.asarray(st.inner) + np.arange(B, dtype=np.int32) * 7 + 3
    data = dict(c=c_s, q=q_s, l=l_s, u=u_s, omega=np.asarray(st.omega),
                x=np.asarray(st.x), y=np.asarray(st.y),
                xs=np.asarray(st.x_sum), ys=np.asarray(st.y_sum), k=k,
                ax=np.asarray(st.x_restart), ay=np.asarray(st.y_restart))
    data = {key: np.asarray(v, np.int32 if key == "k" else np.float32)
            for key, v in data.items()}
    op_kind, leaves = jax_leaves(js)
    op, _, _, eta = pdhg.op_from_numpy(op_kind, leaves, "cpu")
    return js, jlp, data, op, eta


def run_pallas(js, jlp, data, variant, alpha, monkeypatch):
    import jax.numpy as jnp
    monkeypatch.setenv(pallas_chunk.INTERPRET_ENV, "1")
    assert pallas_chunk.supports(js.op, jnp.float32, variant=variant)
    d = {k: jnp.asarray(v) for k, v in data.items()}
    out = pallas_chunk.batched_chunk(
        js.op, d["c"], d["q"], d["l"], d["u"], d["omega"], js.eta, d["x"],
        d["y"], d["xs"], d["ys"], jlp.n_eq, ITERS, variant=variant,
        alpha=alpha, k=d["k"], ax=d["ax"], ay=d["ay"])
    return [np.asarray(a) for a in out]


def run_port(op, eta, n_eq, data, variant, alpha):
    t = {k: torch.tensor(v) for k, v in data.items()}
    assert fused_chunk.supports(op, variant)
    before = dict(fused_chunk.LAUNCHES)
    out = fused_chunk.batched_chunk(
        op, t["c"], t["q"], t["l"], t["u"], t["omega"], eta, t["x"],
        t["y"], t["xs"], t["ys"], n_eq, ITERS, variant=variant,
        alpha=alpha, k=t["k"], ax=t["ax"], ay=t["ay"])
    assert fused_chunk.LAUNCHES == before      # CPU tensors: plain version
    return [a.numpy() for a in out]


@pytest.mark.parametrize("kind,B", [("dense", 3), ("banded", 5),
                                    ("banded_wide", 3), ("banded_wide", 1)])
@pytest.mark.parametrize("variant", ("vanilla", "reflected", "halpern"))
def test_plain_matches_pallas_interpret(kind, B, variant, monkeypatch):
    js, jlp, data, op, eta = shared_inputs(kind, B, variant)
    ref = run_pallas(js, jlp, data, variant, ALPHA[variant], monkeypatch)
    ours = run_port(op, eta, jlp.n_eq, data, variant, ALPHA[variant])
    for name, a, b in zip(("x", "y", "x_sum", "y_sum"), ours, ref):
        assert a.shape == b.shape == (B, b.shape[1])
        assert_close_rows(a, b, name)
    if kind != "banded":
        # mixed rows: some inequality duals sit on their 0 floor while
        # equality duals go negative
        y = ours[1]
        assert (y[:, jlp.n_eq:] >= 0).all() and (y[:, :jlp.n_eq] < 0).any()


@pytest.mark.parametrize("kind", ("banded", "dense"))
@pytest.mark.parametrize("variant", ("vanilla", "reflected", "halpern"))
def test_random_state_gap_is_rounding(kind, variant, monkeypatch):
    """From an arbitrary state (not a mid-solve one) of the all-equality
    banded op, float32 chunks drift from exact arithmetic far more than
    from a mid-solve state.  The float64 run of the plain version is the
    yardstick: the Pallas kernel sits within the spread of the port's
    float32 plain runs around it (``rounding_spread``), so a gap between
    two float32 chunks from such a state is rounding, not a defect.
    test_torch_cuda.py holds the CUDA kernel to the same bar."""
    B = 4
    js, jlp, data, op, eta = shared_inputs(kind, B, variant)
    data.update(random_state(data["l"], data["u"], jlp.m, B, seed=3))
    ref = run_pallas(js, jlp, data, variant, ALPHA[variant], monkeypatch)
    t = {k: torch.tensor(v) for k, v in data.items()}

    def run(dtype, d):
        omega = d["omega"]
        return plain_chunk_as(dtype, op, jlp.n_eq, d, eta / omega,
                              eta * omega, ITERS, variant, ALPHA[variant])

    hi = run(torch.float64, t)
    spread = rounding_spread(lambda d: run(torch.float32, d), t, hi)
    for name, p, h, s in zip(("x", "y", "x_sum", "y_sum"), ref, hi, spread):
        gp = rel_gap(p, h.numpy())
        assert s < 1e-2, (name, s)
        assert gp <= ROUNDING_FACTOR * s + ROUNDING_FLOOR, (name, gp, s)


def test_wide_rows_equal_selector_product():
    jlp, plp = lp_pair("banded_wide")
    js = jpdhg.CompiledLPSolver(jlp, jpdhg.PDHGOptions(pallas_chunk=False))
    op, _, _, _ = pdhg.op_from_numpy(*jax_leaves(js), "cpu")
    P, W = np.asarray(js.op.wide_p), np.asarray(js.op.wide_w)
    M = np.zeros((op.m, op.n), np.float32)
    M[op.wide_rows.numpy()] = op.wide_w.numpy()
    np.testing.assert_array_equal(M, P @ W)
    # and the port's operator applies the same matrix as the JAX op
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, op.n)).astype(np.float32)
    y = rng.standard_normal((2, op.m)).astype(np.float32)
    import jax
    kx = np.stack([np.asarray(jpdhg.op_matvec(js.op, v, None)) for v in x])
    kty = np.stack([np.asarray(jpdhg.op_rmatvec(js.op, v, None)) for v in y])
    with jax.default_matmul_precision("highest"):
        assert_close_rows(pdhg.op_matvec(op, torch.tensor(x)).numpy(), kx,
                          "Kx")
        assert_close_rows(pdhg.op_rmatvec(op, torch.tensor(y)).numpy(), kty,
                          "KTy")


def test_supports_declines_ell_residual_and_solves_plain():
    """A near-dense column forces an ELL residual once dense is off the
    table: the kernels decline it, the ledger reason is
    ``unsupported_shape``, and the plain path still solves it."""
    from dervet_tpu_torch.ops import lp as port_lp
    from dervet_tpu_torch.ops.cpu_ref import solve_lp_cpu
    T = 300
    b = port_lp.LPBuilder()
    ch = b.var("ch", T, 0.0, 250.0)
    dis = b.var("dis", T, 0.0, 250.0)
    ene = b.var("ene", T, 0.0, 1000.0)
    size = b.var("size", 1, 0.0, 1000.0)
    rng = np.random.default_rng(2)
    price = rng.uniform(10, 80, T) / 1000
    b.add_cost(ch, price)
    b.add_cost(dis, -price)
    b.add_cost(size, np.array([0.5]))
    D = np.eye(T) - np.eye(T, k=-1)
    rhs = np.zeros(T)
    rhs[0] = 500.0
    b.add_rows("soe", [(ene, D), (ch, -0.85), (dis, 1.0)], "eq", rhs)
    b.add_rows("cap", [(ene, -np.eye(T)), (size, np.ones((T, 1)))], "ge",
               0.0)
    lp = b.build()
    solver = pdhg.CompiledLPSolver(
        lp, pdhg.PDHGOptions(dense_bytes_limit=1024), device="cpu")
    assert isinstance(solver.op, pdhg.BandedOp) and solver.op.ell is not None
    assert not fused_chunk.supports(solver.op, "reflected")
    kern, why, _ = pdhg.kernel_selection(solver)
    assert (kern, why) == (pdhg.KERNEL_PLAIN,
                           pdhg.FALLBACK_UNSUPPORTED_SHAPE)
    res = solver.solve()
    ref = solve_lp_cpu(lp)
    assert int(res.status) == pdhg.STATUS_CONVERGED
    assert abs(float(res.obj) - ref.obj) <= 1e-3 * (1 + abs(ref.obj))


def test_supports_budget():
    # one block's state over 227 KB in every configuration: declined
    big = pdhg.BandedOp(diags=torch.zeros(4, 3000), offsets=(0, 1, 3000,
                                                              6000),
                        m=3000, n=12000)
    assert fused_chunk.config_for(3000, 12000) is None
    assert fused_chunk.smem_bytes(3000, 12000, shared=True) \
        > fused_chunk.BLOCK_SMEM_BYTES
    assert not fused_chunk.supports(big, "vanilla")
    # 32 bands staged beside the state exceed one block's shared memory
    # in the register configuration that covers the shape: the
    # shared-state configuration takes it
    offs = tuple(range(32))
    wide = pdhg.BandedOp(diags=torch.zeros(32, 2304), offsets=offs,
                         m=2304, n=6144)
    assert fused_chunk.smem_bytes(2304, 6144, offs) \
        > fused_chunk.BLOCK_SMEM_BYTES
    assert fused_chunk.config_for(2304, 6144, offs) \
        == fused_chunk.SHARED_CONFIG
    assert fused_chunk.supports(wide, "vanilla")
    # too many bands
    many = pdhg.BandedOp(diags=torch.zeros(33, 100), offsets=range(33),
                         m=100, n=300)
    assert not fused_chunk.supports(many, "vanilla")
    # a dense K whose compact forms exceed the L2-resident budget
    dense = pdhg.DenseOp(Kh=torch.ones(1024, 3300))
    assert fused_chunk.compact_bytes(dense.compact) > fused_chunk.MAX_K_BYTES
    assert fused_chunk.smem_bytes(1024, 3300, shared=True) \
        <= fused_chunk.BLOCK_SMEM_BYTES
    assert not fused_chunk.supports(dense, "vanilla")
    assert fused_chunk.supports(pdhg.DenseOp(Kh=torch.zeros(176, 672)),
                                "halpern")
    assert not fused_chunk.supports(pdhg.DenseOp(Kh=torch.zeros(8, 8)),
                                    "nope")


def test_multi_der_window_fits_one_block():
    """The ICE+CHP monthly window (2233 x 5952, seven bands) needed the TPU
    kernel's half-size instance block; here 768 threads hold its state in
    registers, 8 columns and 3 rows a thread, and the shared part (c, l,
    u, 2x1-x with a 744-entry halo, y, the seven diagonals) is ~170 KB,
    inside one block's shared memory."""
    from dervet_tpu import benchlib as jax_benchlib
    from dervet_tpu.scenario.scenario import MicrogridScenario
    scen = MicrogridScenario(jax_benchlib.synthetic_case(multi_der=True))
    scen.prepare_dispatch("cpu")
    ctx = scen.windows[0]
    lp = scen.build_window_lp(ctx, scen._annuity_scalar, scen._requirements)
    assert (lp.m, lp.n) == (2233, 5952)
    d_r, d_c = pdhg.ruiz_scaling(lp.K)
    Kh = lp.K.multiply(d_r[:, None]).multiply(d_c[None, :]).tocsr()
    op = pdhg.make_op(Kh, device="cpu")
    assert isinstance(op, pdhg.BandedOp) and len(op.offsets) == 7
    assert fused_chunk.supports(op, "halpern")
    assert fused_chunk.config_for(op.m, op.n) == (768, 8, 3, 1)
    assert fused_chunk.halo(op.offsets, op.m, op.n) == (1, 744)
    assert 165_000 < fused_chunk.smem_bytes(
        op.m, op.n, op.offsets, op.compact, "vanilla") \
        <= fused_chunk.BLOCK_SMEM_BYTES
    jop = jpdhg.make_op(Kh, put=jpdhg._hcast)
    assert pallas_chunk._banded_blk(jop, "vanilla") == 64


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    _, plp = lp_pair("dense")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdhg.CompiledLPSolver(plp)
    from dervet_tpu_torch import benchlib
    from dervet_tpu_torch.api import DERVET
    cases = benchlib.synthetic_sensitivity_cases(1, months=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DERVET.from_cases(cases).solve(backend="torch")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cost_model_counts_wide_pair_zeros():
    """The bound counts K as the kernels store and multiply it: the
    padded band diagonals and the compact wide pair, no longer the dense
    W.  At the monthly daily-cycle shape the dense W's products were ~30x
    the bands'; the compact pair is a tenth of them, and the launch as
    computed is within a few percent of the work the function needs."""
    from dervet_tpu_torch import benchlib
    from dervet_tpu_torch.scenario.scenario import MicrogridScenario
    scen = MicrogridScenario(benchlib.synthetic_case(daily_cycle_limit=1))
    scen.prepare_dispatch("cpu")
    lp = scen.build_window_lp(scen.windows[0], scen._annuity_scalar,
                              scen._requirements)
    op = pdhg.CompiledLPSolver(lp, device="cpu").op
    assert (op.m, op.n, len(op.offsets)) == (776, 2976, 4)
    r = op.wide_w.shape[0]
    band_macs, dense_w_macs = 2 * 4 * 776, 2 * r * 2976
    assert 25 < dense_w_macs / band_macs < 35
    need_bytes, need_macs = fused_chunk.matrix_work(op, needed=True)
    stored_bytes, stored_macs = fused_chunk.matrix_work(op)
    assert need_macs == 2 * (int((op.diags != 0).sum())
                             + int((op.wide_w != 0).sum()))
    assert stored_macs - 2 * 4 * 776 < dense_w_macs / 10
    assert need_macs <= stored_macs < 1.05 * need_macs
    assert need_bytes <= stored_bytes < 4 * need_bytes
    nb_need, ops_need = fused_chunk.chunk_cost(
        896, 776, 2976, 32, need_bytes, need_macs, "reflected")
    nb_all, ops_all = fused_chunk.chunk_cost(
        896, 776, 2976, 32, stored_bytes, stored_macs, "reflected")
    assert ops_need <= ops_all < 1.02 * ops_need
    assert nb_need <= nb_all < 1.01 * nb_need
    # the instance state dominates the bytes: in and out once
    assert nb_need > 896 * 4 * (7 * 2976 + 5 * 776)
