"""The port's PDHG solver against the JAX package's, on the same inputs.

* preconditioning (Ruiz scalings, the step size) and the operator choice
  (dense / banded with and without the wide-row pair) are the same;
* from one shared state (``state_from_numpy``), one check window of each
  step variant matches the JAX scan path (``pallas_chunk=False``) within
  rtol 1e-5 / atol 1e-6 on x and y, per instance in the max norm: the same
  float32 arithmetic, summed in another order only inside the matrix
  products and where XLA fuses multiply-adds;
* full batched solves give the same statuses, objectives within the
  solver's own relative tolerance (``eps_rel`` = 1e-4, the bar the float64
  certificate then checks), and iteration counts within one check window;
* a batch with stragglers compacts its active set like the JAX driver.
"""
import numpy as np
import pytest
import torch

from dervet_tpu.ops import lp as jax_lp
from dervet_tpu.ops import pdhg as jpdhg
from dervet_tpu_torch.ops import lp as port_lp
from dervet_tpu_torch.ops import pdhg

from test_torch_cuda import LPS, assert_close_rows, price_batch

torch.set_num_threads(2)

VARIANTS = ("vanilla", "reflected", "halpern")


def lp_pair(kind):
    return LPS[kind](jax_lp.LPBuilder), LPS[kind](port_lp.LPBuilder)


def jax_leaves(js):
    """The JAX solver's op + scalings as numpy leaves."""
    op = js.op
    leaves = {"dr": np.asarray(js.dr), "dc": np.asarray(js.dc),
              "eta": np.asarray(js.eta)}
    if isinstance(op, jpdhg.DenseOp):
        return "dense", {**leaves, "Kh": np.asarray(op.Kh)}
    leaves.update(diags=np.asarray(op.diags), offsets=op.offsets, m=op.m,
                  n=op.n)
    if op.wide_w is not None:
        leaves.update(wide_p=np.asarray(op.wide_p),
                      wide_w=np.asarray(op.wide_w))
    return "banded", leaves


@pytest.mark.parametrize("kind", sorted(LPS))
def test_preconditioning_and_operator_match(kind):
    jlp, plp = lp_pair(kind)
    jd = jpdhg.ruiz_scaling(jlp.K)
    pd_ = pdhg.ruiz_scaling(plp.K)
    assert np.array_equal(jd[0], pd_[0]) and np.array_equal(jd[1], pd_[1])
    js = jpdhg.CompiledLPSolver(jlp, jpdhg.PDHGOptions(pallas_chunk=False))
    ps = pdhg.CompiledLPSolver(plp, pdhg.PDHGOptions(), device="cpu")
    assert np.float32(js.eta) == ps.eta.item()
    np.testing.assert_array_equal(np.asarray(js.dr), ps.dr.numpy())
    expect = {"dense": pdhg.DenseOp, "banded": pdhg.BandedOp,
              "banded_wide": pdhg.BandedOp}[kind]
    assert isinstance(ps.op, expect)
    if expect is pdhg.DenseOp:
        assert isinstance(js.op, jpdhg.DenseOp)
        np.testing.assert_array_equal(np.asarray(js.op.Kh), ps.op.Kh.numpy())
        return
    assert ps.op.offsets == js.op.offsets
    np.testing.assert_array_equal(np.asarray(js.op.diags),
                                  ps.op.diags.numpy())
    assert ps.op.ell is None and js.op.ell is None
    if kind == "banded_wide":
        P = np.asarray(js.op.wide_p)
        rows = ps.op.wide_rows.numpy()
        assert P.shape[1] == len(rows) == 13
        assert np.all(P[rows, np.arange(len(rows))] == 1.0)
        assert P.sum() == len(rows)
        np.testing.assert_array_equal(np.asarray(js.op.wide_w),
                                      ps.op.wide_w.numpy())
    else:
        assert ps.op.wide_w is None and js.op.wide_w is None


@pytest.mark.parametrize("kind", sorted(LPS))
@pytest.mark.parametrize("variant", VARIANTS)
def test_check_windows_match_scan_path(kind, variant):
    """One check window (32 iterations) from the JAX solver's own initial
    state matches to float32 rounding; two more windows (64 + 128
    iterations, the adaptive cadence) take the same restart decisions."""
    jlp, plp = lp_pair(kind)
    B = 3
    C = price_batch(jlp, B)
    js = jpdhg.CompiledLPSolver(
        jlp, jpdhg.PDHGOptions(variant=variant, pallas_chunk=False))
    import jax.numpy as jnp
    Cj, Q, L, U = js.batch_data(B, jnp.asarray(C, jnp.float32),
                                jnp.asarray(jlp.q, jnp.float32),
                                jnp.asarray(jlp.l, jnp.float32),
                                jnp.asarray(jlp.u, jnp.float32))
    jargs = (js.op, Cj, Q, L, U, js.dr, js.dc)
    st0 = js._jit_init_b(*jargs)
    kind_, leaves = jax_leaves(js)
    op, dr, dc, eta = pdhg.op_from_numpy(kind_, leaves, "cpu")
    sv = pdhg._Solver(pdhg.PDHGOptions(variant=variant), plp.m, plp.n,
                      plp.n_eq, use_kernel=True)
    pargs = (op,) + tuple(torch.tensor(np.asarray(a)) for a in
                          (Cj, Q, L, U)) + (dr, dc)
    state = pdhg.state_from_numpy(
        {f: np.asarray(getattr(st0, f)) for f in st0._fields}, "cpu")
    jstate = st0
    for limit in (32, 224):
        jstate = js._jit_chunk_b(*jargs, js.eta, jstate, np.int32(limit))
        state = sv.run_chunk(*pargs, eta, state, limit)
        if limit == 32:
            # one chunk: the iterate itself, to float32 rounding
            for f in ("x", "y", "x_sum", "y_sum"):
                assert_close_rows(getattr(state, f).numpy(),
                                  np.asarray(getattr(jstate, f)), f)
        # every window: the same restart / cadence decisions
        for f in ("total", "inner", "restarts", "cadence", "converged"):
            np.testing.assert_array_equal(getattr(state, f).numpy(),
                                          np.asarray(getattr(jstate, f)),
                                          err_msg=f)


def solve_both(kind, B, variant="reflected", opts_kw=None, seed=1):
    jlp, plp = lp_pair(kind)
    C = price_batch(jlp, B, seed)
    kw = dict(opts_kw or {})
    js = jpdhg.CompiledLPSolver(
        jlp, jpdhg.PDHGOptions(variant=variant, pallas_chunk=False, **kw))
    ps = pdhg.CompiledLPSolver(
        plp, pdhg.PDHGOptions(variant=variant, **kw), device="cpu")
    stats = pdhg.SolveStats()
    cin = C if B > 1 else C[0]
    return js.solve(c=cin), ps.solve(c=cin, stats=stats), stats, js


@pytest.mark.parametrize("kind,B,variant", [
    ("dense", 1, "reflected"), ("dense", 5, "reflected"),
    ("banded", 1, "reflected"), ("banded_wide", 5, "reflected"),
    ("banded_wide", 5, "halpern"), ("dense", 5, "vanilla")])
def test_batched_solve_matches(kind, B, variant):
    jr, pr, stats, js = solve_both(kind, B, variant)
    np.testing.assert_array_equal(np.asarray(jr.status),
                                  pr.status.numpy())
    assert np.all(pr.status.numpy() == pdhg.STATUS_CONVERGED)
    jobj, pobj = np.asarray(jr.obj, np.float64), pr.obj.numpy()
    np.testing.assert_allclose(pobj, jobj, rtol=1e-4,
                               atol=1e-4 * np.abs(jobj).max())
    ji, pi = np.asarray(jr.iters), pr.iters.numpy()
    assert np.all(np.abs(ji - pi) <= js.opts.check_every), (ji, pi)
    if B == 1:
        assert pr.x.ndim == 1
    assert stats.chunks >= 1 and stats.kernel_launches == 0   # CPU: plain


def test_stragglers_trigger_compaction():
    """Sixteen instances, a third of them with prices scaled far up; with
    short host chunks the early finishers drop out and the stragglers
    re-batch into an 8-row bucket, as in the JAX driver."""
    jlp, plp = lp_pair("banded")
    B = 16
    C = price_batch(jlp, B, seed=4)
    C[::3] *= np.linspace(20, 60, jlp.n)[None]
    kw = dict(compact_chunk_iters=256)
    js = jpdhg.CompiledLPSolver(
        jlp, jpdhg.PDHGOptions(pallas_chunk=False, **kw))
    ps = pdhg.CompiledLPSolver(plp, pdhg.PDHGOptions(**kw), device="cpu")
    jst, pst = jpdhg.SolveStats(), pdhg.SolveStats()
    jr = js.solve(c=C, stats=jst)
    pr = ps.solve(c=C, stats=pst)
    assert pst.compact_events >= 1
    assert pst.bucket_occupancy[0][0] == 8
    assert pst.compact_events == jst.compact_events
    np.testing.assert_array_equal(np.asarray(jr.status), pr.status.numpy())
    ji, pi = np.asarray(jr.iters), pr.iters.numpy()
    assert np.all(np.abs(ji - pi) <= js.opts.check_every), (ji, pi)
    # stragglers: the slowest instance ran two host chunks past the fastest
    assert pi.max() - pi.min() >= 2 * kw["compact_chunk_iters"], pi
    jobj = np.asarray(jr.obj, np.float64)
    np.testing.assert_allclose(pr.obj.numpy(), jobj, rtol=1e-4,
                               atol=1e-4 * np.abs(jobj).max())


def test_variant_kill_switch(monkeypatch):
    monkeypatch.setenv(pdhg.PDHG_VARIANT_ENV, "vanilla")
    opts = pdhg.PDHGOptions(variant="halpern")
    assert pdhg.resolved_variant(opts) == "vanilla"
    assert pdhg.resolved_restart_scheme(opts) == pdhg.RESTART_KKT
    monkeypatch.delenv(pdhg.PDHG_VARIANT_ENV)
    assert pdhg.resolved_restart_scheme(opts) == pdhg.RESTART_FIXED_POINT
    with pytest.raises(ValueError):
        pdhg.resolved_variant(pdhg.PDHGOptions(variant="nope"))


def test_options_defaults_match_reference():
    ours = pdhg.PDHGOptions()
    ref = jpdhg.PDHGOptions()
    for f in ("eps_abs", "eps_rel", "max_iters", "check_every",
              "check_every_min", "variant", "reflection_coeff",
              "restart_scheme", "fp_beta_sufficient", "halpern_coeff",
              "beta_sufficient", "beta_necessary",
              "artificial_restart_frac", "primal_weight_smoothing",
              "power_iters", "ruiz_iters", "step_size_safety",
              "infeas_checks", "eps_infeas", "inaccurate_factor",
              "dense_bytes_limit", "cpu_rescue_after", "cpu_rescue_max",
              "compact_chunk_iters"):
        assert getattr(ours, f) == getattr(ref, f), f
    # the port keeps every option but the kernel switch and the two that
    # only the JAX driver reads; nothing can send card tensors down the
    # plain chunk path
    import dataclasses
    names = {f.name for f in dataclasses.fields(pdhg.PDHGOptions)}
    ref_names = {f.name for f in dataclasses.fields(jpdhg.PDHGOptions)}
    assert names == ref_names - {"pallas_chunk", "precision", "chunk_iters"}
    assert pdhg.KERNEL_FALLBACK_REASONS == (pdhg.FALLBACK_BACKEND,
                                            pdhg.FALLBACK_UNSUPPORTED_SHAPE)
