"""Time-axis (row) sharding of ONE large dispatch LP over ranks.

The scenario axis (``parallel/mesh.py``) is the workhorse scale-out axis;
this module covers the orthogonal case: a *single* LP too long for
comfortable single-device iteration — e.g. a 5-minute-resolution year
window (T=105,120 steps, n≈420k variables) — split over ranks the way
sequence parallelism splits a long context.

Dispatch-LP rows are time-indexed (SOE evolution, power balance, market
headroom per step), so splitting constraint ROWS splits the year.  The
solve is SPMD over ``torch.distributed``, one process per rank:

* each rank owns a contiguous row block (its slice of the year) as an
  ELLPACK table, plus that block's transpose with column ids local to
  the block, and its slices of the dual ``y``, the row scaling ``d_r``
  and the rhs ``q``; rows are zero-padded to a rank multiple, and the
  padded rows are inequality rows with ``q = 0``, so their dual stays 0;
* the primal ``x`` (and everything n-dimensional) is replicated — for a
  dispatch LP n ≈ 4T floats, a few MB at 5-minute resolution — so K@x
  needs no communication;
* every row-space reduction of the solver (``ops/pdhg.LocalRows``: the
  partial gradients K^T y, the sums and norms over rows) is completed by
  one ``all_reduce(SUM)``.

The PDHG algorithm is the SAME code as the single-device solver
(``ops/pdhg._Solver`` with a row-reduction hook), so restarts, primal-
weight updates, infeasibility certificates and termination behave the
same.  Every rank takes the same branch at every check: the all-reduced
values are identical on every rank, and so is every replicated quantity
computed from them.  The chunks run the plain PyTorch version (the CUDA
chunk kernels keep K^T y inside one block), as the JAX package's sharded
path runs its scan instead of the Pallas kernel.

The step size comes from ``ops/pdhg.step_size``: a float64 power
iteration for ||K|| on the host of each rank, as ``CompiledLPSolver``
computes it (the JAX package runs a float32 power iteration sharded over
the mesh instead, so the two agree at solver tolerance, not in bits).
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.lp import LP
from ..ops.pdhg import (EllOp, LocalRows, PDHGOptions, PDHGResult, _Solver,
                        _csr_to_ell, ruiz_scaling, step_size)


class AllReduceRows(LocalRows):
    """Row-space reductions completed across the ranks of ``group`` by
    ``all_reduce(SUM)``: each rank contributes its row block's partial
    sum.  Counts the calls.  ``timed``: also times each, on CUDA on the
    stream with a pair of events (``seconds()`` reads them after a
    synchronize), elsewhere on the host clock; untimed, a call is the
    bare ``all_reduce``."""

    def __init__(self, group=None, timed: bool = False):
        self.group = group
        self.timed = timed
        self.calls = 0
        self._events: list = []
        self._host_s = 0.0

    def _all(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        self.calls += 1
        if not self.timed:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        elif t.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
            end.record()
            self._events.append((start, end))
        else:
            t0 = time.perf_counter()
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
            self._host_s += time.perf_counter() - t0
        return t

    def grad(self, g):
        return self._all(g)

    def sum(self, v):
        return self._all(v.sum(-1))

    def norm(self, v):
        return torch.sqrt(self._all((v * v).sum(-1)))

    def seconds(self) -> Optional[float]:
        """Time spent in the all-reduces: the events' elapsed time on
        CUDA (the card's stream), host time elsewhere; None untimed."""
        if not self.timed:
            return None
        if self._events:
            torch.cuda.synchronize()
            return sum(s.elapsed_time(e) for s, e in self._events) / 1e3
        return self._host_s


class TimeShardedLPSolver:
    """Row-sharded PDHG for one large LP, run by every rank of ``group``
    (default: the world) on ``device``::

        dist.init_process_group("nccl", ...)   # one process per rank
        res = TimeShardedLPSolver(lp, device=f"cuda:{rank}").solve()

    ``res`` is a plain :class:`PDHGResult` of the ORIGINAL problem on
    every rank: 1-D fields, ``y`` gathered to length ``lp.m``.  Dense
    columns are not split off on this path (they appear in sizing LPs,
    which are small and batch on the scenario axis instead).
    ``timed``: time every all-reduce (``last_stats["all_reduce_s"]``,
    otherwise None)."""

    def __init__(self, lp: LP, group=None, device=None,
                 opts: Optional[PDHGOptions] = None, timed: bool = False):
        self.opts = opts or PDHGOptions()
        self.lp = lp
        self.group = group
        self.device = resolve_device(device)
        rank = dist.get_rank(group)
        D = dist.get_world_size(group)
        self.rank, self.world = rank, D
        m, n = lp.m, lp.n
        dt = getattr(torch, np.dtype(self.opts.dtype).name)

        d_r, d_c = ruiz_scaling(lp.K, self.opts.ruiz_iters)
        Kh = lp.K.multiply(d_r[:, None]).multiply(d_c[None, :]).tocsr()
        eta = step_size(Kh, self.opts)

        m_loc = -(-m // D)
        lo, hi = min(rank * m_loc, m), min((rank + 1) * m_loc, m)
        self.m_loc, self.m_pad = m_loc, m_loc * D
        block = Kh[lo:hi]
        # the block's rows, zero rows appended up to m_loc
        data, cols = _csr_to_ell(block)
        data = np.pad(data, ((0, m_loc - data.shape[0]), (0, 0)))
        cols = np.pad(cols, ((0, m_loc - cols.shape[0]), (0, 0)))
        # its transpose (n, rows of the block), column ids local to it
        data_t, cols_t = _csr_to_ell(block.T.tocsr())

        def f(a):
            return torch.as_tensor(np.asarray(a), dtype=dt,
                                   device=self.device)

        def i(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                   device=self.device)
        self.op = EllOp(data=f(data), cols=i(cols), data_t=f(data_t),
                        cols_t=i(cols_t),
                        dense_idx=i(np.zeros(0, np.int64)),
                        dense_blk=f(np.zeros((m_loc, 0))))
        pad = m_loc - (hi - lo)
        self.dr = f(np.pad(d_r[lo:hi], (0, pad), constant_values=1.0))
        self.dc = f(d_c)
        self.eta = f(eta)
        self.q = f(np.pad(lp.q[lo:hi], (0, pad)))[None]
        self.c, self.l, self.u = (f(a)[None] for a in (lp.c, lp.l, lp.u))
        # the whole LP's equality rows come first: this block's are the
        # prefix up to the global n_eq
        self.rows = AllReduceRows(group, timed)
        self._solver = _Solver(self.opts, m_loc, n,
                               int(np.clip(lp.n_eq - lo, 0, m_loc)),
                               use_kernel=False, rows=self.rows)
        self.last_stats: dict = {}

    def solve(self) -> PDHGResult:
        """Host-chunked sharded solve: ``CompiledLPSolver.solve``'s chunk
        loop without compaction (there is one instance)."""
        t_wall = time.perf_counter()
        sv = self._solver
        args = (self.op, self.c, self.q, self.l, self.u, self.dr, self.dc)
        state = sv.init_state(*args)
        opts = self.opts
        total, chunks = 0, 0
        while True:
            limit = min(total + opts.compact_chunk_iters, opts.max_iters)
            # the eager window loop, not the CUDA-graph runner: every
            # window all-reduces through the process group, and a gloo
            # collective runs on the host, which a graph cannot capture
            state = sv.run_chunk(*args, self.eta, state, limit)
            chunks += 1
            total, n_active = (int(v) for v in torch.stack([
                state.total.max(),
                (~(state.converged | state.infeasible)).sum(
                    dtype=torch.int32)]).tolist())
            if n_active == 0 or total >= opts.max_iters:
                break
        res = sv.finalize(*args, state)
        # gather y: each rank writes its block into zeros, one SUM
        y = torch.zeros(self.m_pad, dtype=res.y.dtype, device=self.device)
        y[self.rank * self.m_loc:(self.rank + 1) * self.m_loc] = res.y[0]
        y = self.rows._all(y)[:self.lp.m]
        out = PDHGResult(*(getattr(res, f)[0] for f in PDHGResult._fields))
        out = out._replace(y=y)
        self.last_stats = {
            "rank": self.rank, "world": self.world,
            "m_local": self.m_loc, "iters": int(out.iters),
            "chunks": chunks, "all_reduces": self.rows.calls,
            "all_reduce_s": (None if not self.rows.timed
                             else round(self.rows.seconds(), 4)),
            "solve_s": round(time.perf_counter() - t_wall, 4)}
        return out


def _rank_main(rank, world, backend, init_method, timeout_s, devices,
               lp, opts, out_dir, threads, timed):
    """One rank of :func:`solve_time_sharded` (a spawned process)."""
    try:
        torch.set_num_threads(threads)
        dev = resolve_device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            solver = TimeShardedLPSolver(lp, device=dev, opts=opts,
                                         timed=timed)
            res = solver.solve()
            if rank == 0:
                host = {f: getattr(res, f).cpu().numpy()
                        for f in PDHGResult._fields}
                with open(os.path.join(out_dir, "result.pkl"), "wb") as fh:
                    pickle.dump((host, solver.last_stats), fh)
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error.{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def solve_time_sharded(lp: LP, world: int, backend: Optional[str] = None,
                       device=None, timeout_s: float = 600.0,
                       opts: Optional[PDHGOptions] = None,
                       stats: Optional[dict] = None) -> PDHGResult:
    """Solve ``lp`` row-sharded over ``world`` ranks, each a process
    started with the ``spawn`` method, and return rank 0's
    :class:`PDHGResult` (CPU tensors, ``y`` of length ``lp.m``).

    ``device`` is every rank's device, or a list with one per rank;
    ``None`` puts rank r on ``cuda:r`` (raising without a GPU).
    ``backend`` is the ``torch.distributed`` backend, never switched
    silently: ``"nccl"`` by default on CUDA, ``"gloo"`` on the CPU.
    NCCL refuses two ranks on one GPU; ranks that share a card run on
    ``"gloo"``, passed explicitly.  The ranks meet through a ``file://``
    rendezvous in a temporary directory; ``timeout_s`` bounds the
    process group's collectives and the wait for every rank, so a stuck
    rank raises instead of hanging.  ``stats``, when given, receives
    rank 0's counters (iterations, chunks, all-reduces and their
    seconds, the solve's wall); only then are the all-reduces timed."""
    import multiprocessing as mp
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if device is None:
        resolve_device(None)           # raises when no GPU is visible
        devices = [torch.device("cuda", r) for r in range(world)]
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"{world} ranks need {world} visible GPUs "
                               f"(have {torch.cuda.device_count()}); pass "
                               "device= to place them")
    elif isinstance(device, (list, tuple)):
        devices = [resolve_device(d) for d in device]
    else:
        devices = [resolve_device(device)] * world
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    if backend is None:
        backend = "nccl" if devices[0].type == "cuda" else "gloo"
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dervet-timeshard-") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(
            target=_rank_main,
            args=(r, world, backend, init_method, timeout_s,
                  [str(d) for d in devices], lp, opts, tmp,
                  torch.get_num_threads(), stats is not None),
            name=f"dervet-timeshard-{r}") for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s + 60.0
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            stuck = [p for p in procs if p.is_alive()]
            for p in stuck:
                p.kill()
                p.join(10.0)
        errors = []
        for r in range(world):
            path = os.path.join(tmp, f"error.{r}.txt")
            if os.path.exists(path):
                with open(path) as fh:
                    errors.append(f"rank {r}:\n{fh.read()}")
        if stuck:
            raise TimeoutError(
                f"time-sharded solve: rank(s) "
                f"{[procs.index(p) for p in stuck]} still running after "
                f"{timeout_s + 60.0:.0f} s; killed" +
                ("\n" + "\n".join(errors) if errors else ""))
        if errors or any(p.exitcode != 0 for p in procs):
            raise RuntimeError(
                "time-sharded solve failed (exit codes "
                f"{[p.exitcode for p in procs]})" +
                ("\n" + "\n".join(errors) if errors else ""))
        with open(os.path.join(tmp, "result.pkl"), "rb") as fh:
            host, rank0 = pickle.load(fh)
    if stats is not None:
        stats.update(rank0)
    return PDHGResult(**{f: torch.from_numpy(np.asarray(host[f]))
                         for f in PDHGResult._fields})
