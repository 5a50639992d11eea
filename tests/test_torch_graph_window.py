"""The compiled chunk program's check window on CPU tensors.

On a CUDA device every check window of an unsharded solve is the replay
of a captured CUDA graph (``pdhg._WindowRunner``); on the CPU the same
window function runs eagerly on the runner's static buffers.  These tests
hold that path against the eager functional window loop the solver ran
before (``_Solver.run_chunk``) and against the JAX package:

* (a) the window function and its status read nothing back to the host:
  ``item``, ``tolist``, ``__bool__``, ``__int__``, ``__float__``, ``cpu``
  and ``numpy`` raise while they run, on a banded op with its wide-row
  pair, a dense op, and a banded op with an ELL residual;
* (b) a full solve that compacts its active set at least once, stepped on
  the static buffers with the masked static ``n_max`` form, is bit-equal
  to the functional driver with the uniform form, for each step variant
  (a context, input or state left stale across the compaction fails it);
* (c) the solve reads the status once as each chunk starts and once
  after each window: ``readbacks`` equals windows plus chunks;
* (d) on the JAX package's first 31-day window x 16 price scenarios, where
  both packages' solvers take the same iteration counts, the port's chunk
  count, compaction events and bucket occupancy equal the JAX package's
  ``SolveStats`` and the objectives agree within the certificate's
  objective tolerance.
"""
import numpy as np
import pytest
import torch

from dervet_tpu import benchlib as jax_benchlib
from dervet_tpu.ops import pdhg as jpdhg
from dervet_tpu_torch import benchlib
from dervet_tpu_torch.ops import certify, pdhg
from dervet_tpu_torch.ops import lp as port_lp

from test_torch_cuda import (LPS, functional_solve, price_batch,
                             solve_inputs)

torch.set_num_threads(2)

VARIANTS = ("vanilla", "reflected", "halpern")
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__", "cpu",
              "numpy")
# the straggler batch of test_torch_pdhg: short host chunks, a third of
# the instances priced far up, so the early finishers drop out and the
# stragglers compact into an 8-row bucket (each converges well inside
# max_iters, which bounds a run that does not)
STRAGGLER_OPTS = dict(compact_chunk_iters=256, cpu_rescue_after=None,
                      max_iters=16384)


def ell_residual_solver(monkeypatch, **kw):
    """The daily-cycle LP with its wide rows in an ELL residual: no
    wide-row pair admitted and no dense op."""
    monkeypatch.setattr(pdhg, "WIDE_MAX_ROWS", 0)
    lp = LPS["banded_wide"](port_lp.LPBuilder)
    solver = pdhg.CompiledLPSolver(
        lp, pdhg.PDHGOptions(dense_bytes_limit=0, **kw), device="cpu")
    assert isinstance(solver.op, pdhg.BandedOp) and solver.op.ell is not None
    return solver


def make_solver(kind, monkeypatch, **kw):
    if kind == "ell_residual":
        return ell_residual_solver(monkeypatch, **kw)
    lp = LPS[kind](port_lp.LPBuilder)
    return pdhg.CompiledLPSolver(lp, pdhg.PDHGOptions(**kw), device="cpu")


def straggler_prices(lp, B=16):
    C = price_batch(lp, B, seed=4)
    C[::3] *= np.linspace(20, 60, lp.n)[None]
    return C


@pytest.mark.parametrize("kind", ["banded_wide", "dense", "ell_residual"])
@pytest.mark.parametrize("variant", ["reflected", "halpern"])
def test_window_reads_nothing_back(kind, variant, monkeypatch):
    solver = make_solver(kind, monkeypatch, variant=variant)
    sv = solver._solver
    expect_kernel = kind != "ell_residual"
    assert sv.use_kernel == expect_kernel
    cur = solve_inputs(solver, price_batch(solver.lp, 5))
    args = (solver.op, *cur, solver.dr, solver.dc)
    # a mid-solve state: past restarts, with a doubled cadence
    state = sv.run_chunk(*args, solver.eta, sv.init_state(*args), 96)
    t = sv._context(*cur, solver.dr, solver.dc)
    limit = torch.tensor(4096, dtype=torch.int32)

    def host_read(*a, **k):
        raise AssertionError("the window read a tensor back to the host")
    with monkeypatch.context() as m:
        for name in HOST_READS:
            m.setattr(torch.Tensor, name, host_read)
        outs = [(sv.window(solver.op, t, state, solver.eta, solver.dr,
                           solver.dc, limit, n_max), n_max)
                for n_max in (1, 2, 4)]
        stats = [sv.status(s, limit) for s, _ in outs]
    for (s, n_max), st in zip(outs, stats):
        assert torch.isfinite(s.x).all() and torch.isfinite(s.y).all()
        assert st.shape == (5 + 5,) and st.dtype == torch.int32
        active = ~state.converged & ~state.infeasible
        adv = torch.where(active, sv._n_sub(state) * sv.sub, 0)
        assert torch.equal(s.total - state.total, adv)


@pytest.mark.parametrize("variant", VARIANTS)
def test_static_buffers_equal_functional_stepping(variant, monkeypatch):
    solver = make_solver("banded_wide", monkeypatch, variant=variant,
                         **STRAGGLER_OPTS)
    C = straggler_prices(solver.lp)
    ref, occupancy = functional_solve(solver, C)
    stats = pdhg.SolveStats()
    res = solver.solve(c=C, stats=stats)
    assert stats.compact_events >= 1
    assert stats.bucket_occupancy == occupancy
    for f in pdhg.PDHGResult._fields:
        assert torch.equal(getattr(res, f), getattr(ref, f)), f
    # a second solve on the kept runners, of other prices, still matches
    C2 = straggler_prices(solver.lp)[::-1].copy()
    ref2, _ = functional_solve(solver, C2)
    res2 = solver.solve(c=C2)
    for f in pdhg.PDHGResult._fields:
        assert torch.equal(getattr(res2, f), getattr(ref2, f)), f


@pytest.mark.parametrize("kind", ["banded_wide", "dense", "ell_residual"])
def test_readbacks_are_windows_plus_chunks(kind, monkeypatch):
    solver = make_solver(kind, monkeypatch, **STRAGGLER_OPTS)
    before = dict(pdhg.DRIVER_COUNTS)
    stats = pdhg.SolveStats()
    solver.solve(c=straggler_prices(solver.lp), stats=stats)
    assert stats.chunks >= 2 and stats.check_windows > stats.chunks
    assert stats.readbacks == stats.check_windows + stats.chunks
    # the CPU runs the window eagerly: no graph, no launch
    assert stats.graph_captures == stats.graph_replays == 0
    assert stats.kernel_launches == stats.warmup_launches == 0
    for k in ("chunks", "check_windows", "readbacks"):
        assert pdhg.DRIVER_COUNTS[k] - before[k] == getattr(stats, k), k


def test_chunks_and_compaction_match_jax():
    _, ours = benchlib.build_window_lps(benchlib.synthetic_case())
    _, ref = jax_benchlib.build_window_lps(jax_benchlib.synthetic_case())
    plp, jlp = ours[744][0], ref[744][0]
    C = benchlib.scenario_price_batch(plp, 16, seed=5)
    kw = dict(compact_chunk_iters=512, cpu_rescue_after=None)
    jst, pst = jpdhg.SolveStats(), pdhg.SolveStats()
    jr = jpdhg.CompiledLPSolver(
        jlp, jpdhg.PDHGOptions(pallas_chunk=False, **kw)).solve(c=C,
                                                                stats=jst)
    pr = pdhg.CompiledLPSolver(plp, pdhg.PDHGOptions(**kw),
                               device="cpu").solve(c=C, stats=pst)
    np.testing.assert_array_equal(np.asarray(jr.iters), pr.iters.numpy())
    np.testing.assert_array_equal(np.asarray(jr.status), pr.status.numpy())
    assert pst.chunks == jst.chunks >= 2
    assert pst.compact_events == jst.compact_events >= 1
    assert [tuple(b) for b in pst.bucket_occupancy] == \
        [tuple(b) for b in jst.bucket_occupancy]
    assert pst.readbacks == pst.check_windows + pst.chunks
    np.testing.assert_allclose(pr.obj.numpy(),
                               np.asarray(jr.obj, np.float64),
                               rtol=certify.CertPolicy().eps_obj)
