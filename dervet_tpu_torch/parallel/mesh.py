"""Scenario-axis sharding of the batched LP solve, and per-device warm-up.

The scale-out axis of a dispatch is the scenario batch — sensitivity
cases x sizing sweeps x Monte-Carlo draws x same-length windows.
:func:`solve_batch_sharded` splits one batch over a list of devices in
one process:

* the problem *structure* (K, the Ruiz scalings, the step size) is the
  solver's, copied once to each device (``CompiledLPSolver.to_device``);
* the per-scenario data ``c, q, l, u`` is split on the leading axis; each
  device runs the batched solve on its shard (no traffic between devices
  in the hot loop);
* the only cross-shard reductions are the per-chunk termination test
  (the largest iteration count, the active count, from each shard's last
  status read) and the final statistics, all on the host.

Each shard's chunks run from a thread of its own, so on several GPUs the
shards run at once and no shard's status reads wait on another shard.
Each shard is a clone kept on the solver (``CompiledLPSolver.shard``),
so its check-window graphs are captured once across calls.
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.pdhg import (DRIVER_FIELDS, CompiledLPSolver, PDHGResult,
                        SolveStats)
from . import elastic


class ShardedStats(NamedTuple):
    """Solve statistics reduced over every shard (pad rows masked)."""
    n_converged: int      # converged instances across the shards
    max_iters: int        # worst-case iteration count across the shards
    max_prim_res: float   # worst primal residual across the shards


def warmup_devices(per_device_solve: bool = True, devices=None) -> dict:
    """Pay device initialization up front (serving layer) on EVERY device
    a dispatch may place work on: ``device.warmup_device`` once for each
    of ``devices`` (default: the visible devices), concurrently.  With
    ``per_device_solve`` each device also runs one tiny bucket-shaped
    solve, and the per-device timings ride the returned dict
    (``warmup_s`` keyed by device index, ``warmup_total_s``), so a slow
    device is visible at service start; without it each device is only
    touched (context, a synchronize), the backend-loss re-init probe.

    Returns the device inventory for the service's metrics surface."""
    from ..device import warmup_device
    devs = (list(devices) if devices is not None
            else elastic.visible_devices())
    t_all = time.perf_counter()
    with cf.ThreadPoolExecutor(max_workers=min(8, len(devs))) as pool:
        infos = list(pool.map(
            lambda d: warmup_device(d, solve=per_device_solve), devs))
    info = {"n_devices": len(elastic.visible_devices(devs[0])),
            "platform": infos[0]["platform"],
            "device_kind": infos[0]["device_kind"]}
    if per_device_solve:
        info["warmup_s"] = {str(i): r["warmup_s"]
                            for i, r in enumerate(infos)}
        info["warmup_total_s"] = round(time.perf_counter() - t_all, 4)
    return info


def scenario_devices(n_devices: Optional[int] = None, device=None) -> list:
    """The devices a batch shards over: the visible devices of
    ``device``'s kind (``elastic.visible_devices``), the first
    ``n_devices`` of them when given."""
    devs = elastic.visible_devices(device)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return devs


def _pad_rows(a: torch.Tensor, rows: int) -> torch.Tensor:
    """Edge padding on the batch axis: the last row repeated."""
    if rows == 0:
        return a
    return torch.cat([a, a[-1:].expand(rows, *a.shape[1:])])


def solve_batch_sharded(solver: CompiledLPSolver, devices,
                        c=None, q=None, l=None, u=None, stats=None,
                        x0=None, y0=None):
    """Solve a batch of LP instances split over ``devices`` (a list; one
    device may appear more than once, each entry a shard of its own).

    Any of ``c/q/l/u`` may be 1-D (shared) or 2-D batched on the leading
    axis, as in ``CompiledLPSolver.solve``; ``x0``/``y0`` are UNSCALED
    warm-start seeds batched like the data.  The batch is padded up to a
    multiple of the device count by repeating its last row, split into
    contiguous shards, and each shard is solved on ``solver.to_device(d)``
    in host chunks of ``compact_chunk_iters`` iterations with no
    compaction: every shard's chunk is launched before any shard is read
    back, and the loop ends when no shard has an active instance or the
    largest iteration count reaches ``max_iters``.  A kernel that fails
    to build or launch raises, as in ``CompiledLPSolver.solve``.

    Returns ``(PDHGResult, ShardedStats)`` with the result batched on
    the original (unpadded) leading axis, on ``solver.device``."""
    devices = list(devices)
    D = len(devices)
    if D == 0:
        raise ValueError("solve_batch_sharded needs at least one device")
    lp = solver.lp
    with solver._solve_lock:
        if stats is None:
            stats = SolveStats()
        solver.last_stats = stats
        stats.restart_scheme = solver.restart_scheme
        arrs = [lp.c if c is None else c, lp.q if q is None else q,
                lp.l if l is None else l, lp.u if u is None else u]
        if x0 is None and y0 is not None:
            raise ValueError("warm start needs x0 when y0 is given")
        if x0 is not None and y0 is None:
            y0 = np.zeros(np.shape(x0)[:-1] + (lp.m,))
        seeded = x0 is not None
        if seeded:
            arrs += [x0, y0]
        arrs = solver._to_device(arrs, stats)
        sizes = {a.shape[0] for a in arrs if a.dim() == 2}
        if not sizes:
            raise ValueError(
                "solve_batch_sharded needs at least one batched input")
        if len(sizes) > 1:
            raise ValueError(f"inconsistent batch sizes: {sorted(sizes)}")
        B = sizes.pop()
        widths = (lp.n, lp.m, lp.n, lp.n, lp.n, lp.m)
        arrs = [a.expand(B, w) if a.dim() == 1 else a
                for a, w in zip(arrs, widths)]
        per = -(-B // D)
        arrs = [_pad_rows(a, per * D - B) for a in arrs]
        shards = [solver.shard(i, d) for i, d in enumerate(devices)]
        data = [[a[i * per:(i + 1) * per].to(s.device) for a in arrs]
                for i, s in enumerate(shards)]
        launches0 = [s._solver.launches for s in shards]
        # per shard: its thread's window counters, merged at the end
        shard_stats = [SolveStats() for _ in shards]
        # each shard's thread runs on the caller's stream of its device,
        # where the uploads above were ordered
        streams = [torch.cuda.current_stream(s.device)
                   if s.device.type == "cuda" else None for s in shards]

        def on(i, fn):
            with (torch.cuda.stream(streams[i]) if streams[i] is not None
                  else contextlib.nullcontext()):
                return fn()

        def args(i):
            s = shards[i]
            return (s.op, *data[i][:4], s.dr, s.dc)

        def init(i):
            seeds = data[i][4:] if seeded else (None, None)
            return on(i, lambda: shards[i]._solver.init_state(
                *args(i), x0=seeds[0], y0=seeds[1]))

        with cf.ThreadPoolExecutor(max_workers=D) as pool:
            solver._note_exec("sh_init_seeded" if seeded else "sh_init",
                              (per,) + tuple(arrs[0].shape[1:]), stats)
            states = list(pool.map(init, range(D)))
            stats.dispatches += D
            opts = solver.opts
            total = 0
            while True:
                limit = min(total + opts.compact_chunk_iters, opts.max_iters)
                solver._note_exec("sh_chunk", (per, lp.n), stats)
                runs = list(pool.map(
                    lambda i: on(i, lambda: shards[i].run_chunk(
                        data[i][:4], states[i], limit, shard_stats[i])),
                    range(D)))
                states = [st for st, _ in runs]
                total = max(r.total for _, r in runs)
                n_active = sum(r.n_unfinished for _, r in runs)
                stats.dispatches += 2 * D
                stats.chunks += 1
                if n_active == 0 or total >= opts.max_iters:
                    break
            solver._note_exec("sh_fin", (per, lp.n), stats)
            parts = list(pool.map(
                lambda i: on(i, lambda: shards[i]._solver.finalize(
                    *args(i), states[i])),
                range(D)))
            stats.dispatches += D
            for i, s in enumerate(shards):
                on(i, s.release_buffers)
        stats.kernel_launches += sum(s._solver.launches - n0
                                     for s, n0 in zip(shards, launches0))
        # the shards' window counters; chunks are counted above, once a
        # chunk of the whole batch
        for k in DRIVER_FIELDS:
            if k != "chunks":
                setattr(stats, k, getattr(stats, k)
                        + sum(getattr(s, k) for s in shard_stats))
        res = PDHGResult(*(torch.cat([getattr(p, f).to(solver.device)
                                      for p in parts])[:B]
                           for f in PDHGResult._fields))
        conv = res.converged.cpu().numpy()
        sh = ShardedStats(
            n_converged=int(conv.sum()),
            max_iters=int(res.iters.max()),
            max_prim_res=float(res.prim_res.max()))
        return res, sh
