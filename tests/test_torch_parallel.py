"""Scenario-axis sharding (``parallel/mesh.py``) and the row-sharded
solve of one LP over ``torch.distributed`` ranks (``parallel/timeshard.py``)
on the CPU.

* ``solve_batch_sharded`` over eight CPU entries against the unsharded
  port solve (objectives rtol 1e-5, atol 1e-4: the JAX package's own bar
  in tests/test_parallel.py), with an uneven batch (edge padding) and a
  smaller device list; the multi-DER Monte-Carlo batch of 16 price
  draws over four entries (every draw converged, rtol 2e-4); the same
  inputs through the JAX package's ``solve_batch_sharded`` on its eight
  virtual devices (objectives within the certificate's 2e-4 relative:
  two float32 solvers);
* ``TimeShardedLPSolver`` at world 2 and 4 over gloo — each world one
  spawned process group, joined with a bound — on ``battery_like_lp(T=96)``
  and on a 49-row LP (48 equality rows and one inequality row: a row
  count neither world divides): against the unsharded port solve
  (objective 5e-4 relative, x 5e-3 of max |x|), HiGHS (2e-3), the JAX
  package's ``TimeShardedLPSolver`` on its eight virtual devices (5e-4),
  with ``y`` of length ``lp.m``; ``solve_time_sharded`` (its own spawn);
* the row-reduction hook: ``_Solver`` states bit-equal with the hook left
  unset and with a no-op hook (``LocalRows``), and ``CompiledLPSolver.
  to_device`` shares the preconditioning.
"""
import multiprocessing as mp
import os
import pickle
import tempfile
import traceback

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dervet_tpu_torch import benchlib
from dervet_tpu_torch.ops import lp as port_lp
from dervet_tpu_torch.ops import pdhg
from dervet_tpu_torch.ops.cpu_ref import solve_lp_cpu
from dervet_tpu_torch.parallel import elastic, mesh
from dervet_tpu_torch.parallel.timeshard import (TimeShardedLPSolver,
                                                 solve_time_sharded)

torch.set_num_threads(1)

CPUS = [torch.device("cpu")] * 8
SPAWN_TIMEOUT_S = 240
OBJ_RTOL = 5e-4       # time-sharded vs unsharded (tests/test_parallel.py)
X_RTOL = 5e-3         # ... primal, relative to max |x|
HIGHS_RTOL = 2e-3     # time-sharded vs HiGHS
EPS_OBJ = 2e-4        # ops/certify.CertPolicy.eps_obj


def battery_like_lp(builder, T=48, price=None):
    """The JAX package's ``tests/test_pdhg.py::battery_like_lp`` on any
    ``LPBuilder``: SOE recursion + box bounds + linear prices."""
    rng = np.random.default_rng(1)
    price = rng.uniform(10, 80, T) / 1000 if price is None else price
    dt, rte = 1.0, 0.85
    ch_max, dis_max, ene_max = 250.0, 250.0, 1000.0
    b = builder()
    ch = b.var("ch", T, 0.0, ch_max)
    dis = b.var("dis", T, 0.0, dis_max)
    ene = b.var("ene", T, 0.0, ene_max)
    D = np.eye(T) - np.eye(T, k=-1)
    rhs = np.zeros(T)
    rhs[0] = ene_max / 2
    b.add_rows("soe", [(ene, D), (ch, -rte * dt), (dis, dt)], "eq", rhs)
    b.add_cost(ch, price * dt)
    b.add_cost(dis, -price * dt)
    return b.build()


def mixed_lp(builder, T=48):
    """Battery LP with T equality rows and one inequality row (a daily
    discharge requirement): m = T + 1."""
    rng = np.random.default_rng(0)
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


TIME_LPS = {"battery96": lambda b: battery_like_lp(b, T=96),
            "mixed49": mixed_lp}


def _price_batch(lp, B, seed=11, T=48):
    rng = np.random.default_rng(seed)
    prices = rng.uniform(5, 100, (B, T)) / 1000
    c_b = np.zeros((B, lp.n))
    for i in range(B):
        c_b[i, lp.var_refs["ch"].sl] = prices[i]
        c_b[i, lp.var_refs["dis"].sl] = -prices[i]
    return c_b


@pytest.fixture(scope="module")
def solver():
    return pdhg.CompiledLPSolver(battery_like_lp(port_lp.LPBuilder, T=48),
                                 device="cpu")


def _check_against_unsharded(solver, c_b, devices, rtol=1e-5, atol=1e-4):
    res_sh, stats = mesh.solve_batch_sharded(solver, devices, c=c_b)
    res_un = solver.solve(c=c_b)
    B = c_b.shape[0]
    assert res_sh.x.shape == (B, solver.lp.n)
    assert res_sh.y.shape == (B, solver.lp.m)
    np.testing.assert_allclose(res_sh.obj.numpy(), res_un.obj.numpy(),
                               rtol=rtol, atol=atol)
    assert stats.n_converged == B == int(res_un.converged.sum())
    assert stats.max_iters == int(res_sh.iters.max())
    assert bool(res_sh.converged.all())
    return res_sh, stats


def test_sharded_matches_unsharded(solver):
    _check_against_unsharded(solver, _price_batch(solver.lp, 16), CPUS)


def test_sharded_pads_uneven_batch(solver):
    res, stats = _check_against_unsharded(
        solver, _price_batch(solver.lp, 11, seed=5), CPUS)
    # the pad rows (the last instance repeated) are trimmed and masked
    assert res.obj.shape == (11,) and stats.n_converged == 11


def test_smaller_device_list(solver):
    _check_against_unsharded(solver, _price_batch(solver.lp, 4, seed=9),
                             CPUS[:2])


def test_shared_vectors_and_seeds(solver):
    """1-D inputs broadcast over the batch; seeds ride the split like
    the data (a seeded start from another batch's answers, against the
    same seeded start unsharded)."""
    c_b = _price_batch(solver.lp, 6, seed=3)
    first, _ = mesh.solve_batch_sharded(solver, CPUS[:4], c=c_b,
                                        q=solver.lp.q)
    c_near = c_b * 1.05
    x0, y0 = first.x.numpy(), first.y.numpy()
    seeded, st = mesh.solve_batch_sharded(solver, CPUS[:4], c=c_near,
                                          x0=x0, y0=y0)
    ref = solver.solve(c=c_near, x0=x0, y0=y0)
    np.testing.assert_allclose(seeded.obj.numpy(), ref.obj.numpy(),
                               rtol=1e-5, atol=1e-4)
    assert st.n_converged == 6
    with pytest.raises(ValueError, match="batched input"):
        mesh.solve_batch_sharded(solver, CPUS[:2])


def test_scenario_devices_from_the_seam(monkeypatch):
    monkeypatch.setattr(elastic, "visible_devices",
                        lambda device=None: list(CPUS))
    assert mesh.scenario_devices() == CPUS
    assert mesh.scenario_devices(2) == CPUS[:2]
    with pytest.raises(ValueError, match="need 9 devices"):
        mesh.scenario_devices(9)


def test_monte_carlo_multi_der_sharded():
    """Monte-Carlo price draws x the multi-DER microgrid (Battery + PV +
    ICE + CHP, thermal balance) split over four CPU entries: every draw
    converges and solves the LP the unsharded path solves."""
    lps = benchlib.window_lps(benchlib.synthetic_case(multi_der=True))
    lp = min(lps, key=lambda w: w.n)           # the shortest month
    rng = np.random.default_rng(23)
    mult = rng.lognormal(mean=0.0, sigma=0.15, size=(16, lp.n))
    C = np.where(lp.c[None, :] != 0.0, mult * lp.c[None, :], 0.0)
    solver = pdhg.CompiledLPSolver(lp, device="cpu")
    res_sh, stats = mesh.solve_batch_sharded(solver, CPUS[:4], c=C)
    res = solver.solve(c=C)
    assert stats.n_converged == 16
    np.testing.assert_allclose(res_sh.obj.numpy(), res.obj.numpy(),
                               rtol=2e-4, atol=1e-3)


def test_sharded_matches_the_jax_packages(solver):
    from dervet_tpu.ops import CompiledLPSolver as JaxSolver
    from dervet_tpu.ops import LPBuilder as JaxBuilder
    from dervet_tpu.parallel import scenario_mesh
    from dervet_tpu.parallel import solve_batch_sharded as jax_sharded
    c_b = _price_batch(solver.lp, 11, seed=5)
    ours, st = mesh.solve_batch_sharded(solver, CPUS, c=c_b)
    jsolver = JaxSolver(battery_like_lp(JaxBuilder, T=48))
    ref, jst = jax_sharded(jsolver, scenario_mesh(8), c=c_b)
    ref_obj = np.asarray(ref.obj, np.float64)
    np.testing.assert_allclose(ours.obj.numpy(), ref_obj, rtol=EPS_OBJ,
                               atol=EPS_OBJ * np.abs(ref_obj).max())
    assert st.n_converged == int(jst.n_converged) == 11
    np.testing.assert_array_equal(ours.status.numpy(),
                                  np.asarray(ref.status))


# ---------------------------------------------------------------------------
# The row-reduction hook and the device copy
# ---------------------------------------------------------------------------

def _chunks(sv, s, C, n_chunks=3):
    args = (s.op, *s._to_device([C, s.lp.q, s.lp.l, s.lp.u], None),
            s.dr, s.dc)
    args = args[:2] + tuple(a.expand(C.shape[0], -1) for a in args[2:5]) \
        + args[5:]
    state = sv.init_state(*args)
    for k in range(1, n_chunks + 1):
        state = sv.run_chunk(*args, s.eta, state, 256 * k)
    return state, sv.finalize(*args, state)


@pytest.mark.parametrize("variant", ["reflected", "halpern"])
def test_unset_hook_changes_nothing(variant):
    """``_Solver`` with no row-reduction hook and with a no-op one
    (``LocalRows``, which also routes the chunks through the plain
    version) give bit-equal states and results."""
    lp = mixed_lp(port_lp.LPBuilder)
    s = pdhg.CompiledLPSolver(lp, pdhg.PDHGOptions(variant=variant),
                              device="cpu")
    C = lp.c[None] * np.random.default_rng(0).uniform(0.8, 1.2, (5, 1))
    plain = pdhg._Solver(s.opts, lp.m, lp.n, lp.n_eq)
    hooked = pdhg._Solver(s.opts, lp.m, lp.n, lp.n_eq,
                          rows=pdhg.LocalRows())
    assert plain.rows is pdhg.LOCAL_ROWS and not hooked.use_kernel
    sa, ra = _chunks(plain, s, C)
    sb, rb = _chunks(hooked, s, C)
    for f in pdhg._State._fields:
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    for f in pdhg.PDHGResult._fields:
        assert torch.equal(getattr(ra, f), getattr(rb, f)), f


def test_to_device_shares_the_preconditioning(solver):
    clone = solver.to_device("cpu")
    assert clone is not solver and clone._solve_lock is not solver._solve_lock
    assert clone.op is solver.op and clone.dr is solver.dr
    assert clone.eta is solver.eta and clone.device == solver.device
    c_b = _price_batch(solver.lp, 3)
    a, b = solver.solve(c=c_b), clone.solve(c=c_b)
    assert torch.equal(a.x, b.x) and torch.equal(a.iters, b.iters)
    # another device (the meta device stands in for a second card): the
    # op, scalings and step are copied there, nothing else changes
    moved = solver.to_device("meta")
    assert moved.device == torch.device("meta")
    assert moved.dr.device == moved.eta.device == torch.device("meta")
    assert moved.op.Kh.device == torch.device("meta")
    assert solver.dr.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# Time (row) sharding over gloo ranks
# ---------------------------------------------------------------------------

def _rank(rank, world, init_method, out_dir):
    """One rank: both TIME_LPS through ``TimeShardedLPSolver`` in one
    process group."""
    import datetime

    import torch.distributed as dist
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=init_method,
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(
                                    seconds=SPAWN_TIMEOUT_S))
        out = {}
        for name, make in TIME_LPS.items():
            solver = TimeShardedLPSolver(make(port_lp.LPBuilder),
                                         device="cpu")
            res = solver.solve()
            out[name] = ({f: getattr(res, f).numpy()
                          for f in pdhg.PDHGResult._fields},
                         solver.last_stats)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def _spawn_world(world):
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank, args=(r, world, init, tmp))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(SPAWN_TIMEOUT_S + 30)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        errors = [open(os.path.join(tmp, f)).read()
                  for f in sorted(os.listdir(tmp)) if f.startswith("error")]
        assert not alive and not errors, errors
        assert all(p.exitcode == 0 for p in procs)
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                ranks.append(pickle.load(fh))
    return ranks


@pytest.fixture(scope="module", params=[2, 4])
def world_run(request):
    return request.param, _spawn_world(request.param)


@pytest.fixture(scope="module")
def unsharded():
    return {name: pdhg.CompiledLPSolver(make(port_lp.LPBuilder),
                                        device="cpu").solve()
            for name, make in TIME_LPS.items()}


@pytest.mark.parametrize("name", sorted(TIME_LPS))
def test_time_sharded_matches_unsharded(world_run, unsharded, name):
    world, ranks = world_run
    lp = TIME_LPS[name](port_lp.LPBuilder)
    host, st = ranks[0][name]
    assert st["world"] == world and st["m_local"] == -(-lp.m // world)
    assert bool(host["converged"]) and st["all_reduces"] > st["iters"]
    # untimed by default: each all-reduce is the bare collective
    assert st["all_reduce_s"] is None
    ref = unsharded[name]
    obj, ref_obj = float(host["obj"]), float(ref.obj)
    assert abs(obj - ref_obj) / max(1.0, abs(ref_obj)) < OBJ_RTOL
    x, ref_x = host["x"], ref.x.numpy()
    assert np.abs(x - ref_x).max() / max(1.0, np.abs(ref_x).max()) < X_RTOL
    assert host["y"].shape == (lp.m,)
    # every rank holds the same replicated answer, bit for bit
    for other in ranks[1:]:
        for f in pdhg.PDHGResult._fields:
            np.testing.assert_array_equal(other[name][0][f], host[f])


@pytest.mark.parametrize("name", sorted(TIME_LPS))
def test_time_sharded_vs_highs(world_run, name):
    _, ranks = world_run
    lp = TIME_LPS[name](port_lp.LPBuilder)
    ref = solve_lp_cpu(lp)
    obj = float(ranks[0][name][0]["obj"])
    assert abs(obj - ref.obj) / max(1.0, abs(ref.obj)) < HIGHS_RTOL


@pytest.fixture(scope="module")
def jax_time_sharded():
    from dervet_tpu.ops import LPBuilder as JaxBuilder
    from dervet_tpu.parallel.timeshard import TimeShardedLPSolver as JaxTS
    from dervet_tpu.parallel.timeshard import time_mesh
    return {name: JaxTS(make(JaxBuilder), time_mesh(8)).solve()
            for name, make in TIME_LPS.items()}


@pytest.mark.parametrize("name", sorted(TIME_LPS))
def test_time_sharded_vs_the_jax_packages(world_run, jax_time_sharded,
                                          name):
    _, ranks = world_run
    ref = jax_time_sharded[name]
    assert bool(np.asarray(ref.converged))
    obj, ref_obj = float(ranks[0][name][0]["obj"]), float(np.asarray(ref.obj))
    assert abs(obj - ref_obj) / max(1.0, abs(ref_obj)) < OBJ_RTOL
    assert ranks[0][name][0]["y"].shape == np.asarray(ref.y).shape


def test_solve_time_sharded_entry_point():
    """The spawning entry point: ranks on the CPU over gloo, rank 0's
    answer with ``y`` of length ``lp.m``, and its counters."""
    lp = mixed_lp(port_lp.LPBuilder)
    stats = {}
    res = solve_time_sharded(lp, 2, backend="gloo", device="cpu",
                             timeout_s=SPAWN_TIMEOUT_S, stats=stats)
    ref = solve_lp_cpu(lp)
    assert bool(res.converged) and res.y.shape == (lp.m,)
    assert abs(float(res.obj) - ref.obj) / max(1.0, abs(ref.obj)) \
        < HIGHS_RTOL
    assert stats["world"] == 2 and stats["all_reduces"] > 0
    assert stats["all_reduce_s"] >= 0.0     # asked for stats: timed
    assert stats["iters"] == int(res.iters)


def test_solve_time_sharded_argument_errors():
    lp = mixed_lp(port_lp.LPBuilder)
    with pytest.raises(ValueError, match="2 devices for 3 ranks"):
        solve_time_sharded(lp, 3, device=["cpu", "cpu"])
    with pytest.raises(ValueError, match="world must be"):
        solve_time_sharded(lp, 0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve_time_sharded(lp, 1)
