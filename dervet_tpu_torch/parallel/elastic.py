"""Elastic multi-device dispatch: a structure-group scheduler over the
visible devices.

The plain dispatch drives ONE device: every batched group rides one
stream of solves, so with several GPUs all but one idle through every
group's host round trips, escalation rungs and certification.  The
elastic scheduler turns that single pipeline into N concurrent
per-device pipelines under one round:

* **Placement** — each structure group is assigned to a device by
  estimated cost (window count x horizon x a rolling per-structure
  iteration baseline fed back from the solve ledger), greedy
  longest-processing-time onto the least-loaded queue.  A structure that
  already has a solver on some device is STICKY to that device (cache
  affinity beats balance: re-placing a warm structure would copy its
  operator to another device for nothing).
* **Per-device in-flight rounds** — each device gets its own worker
  thread, solver-cache shard (``SolverCache.shard_for``: operator
  constants on its device; the warm-start solution memory stays SHARED),
  and staged-upload pipeline (the worker stages the next queued group's
  upload onto its device before blocking in the current solve).  On CUDA
  each worker runs on a stream of its own, so two workers on one card
  launch their chunk kernels concurrently instead of serializing on the
  default stream.
* **Work stealing** — a device that drains its queue while another still
  has PENDING groups steals the victim's tail group.  Re-placement is
  safe because structure groups are independent window LPs; the steal is
  recorded in the ledger (``stolen`` on the group entry, the steal list
  in ``solve_ledger.elastic``) and its data re-stages on the thief.

Every group runs the SAME batched solve whatever the device count, so
elastic results are BYTE-IDENTICAL across 1/2/8-device schedules,
placements and steals (asserted in tests/test_torch_elastic.py and on the
card by chip_smoke.py).

Kill switch: ``DERVET_TPU_ELASTIC=0`` restores the plain pipeline;
``DERVET_TPU_ELASTIC_DEVICES=N`` bounds the scheduler to the first N
devices (N=1 is allowed — a single-worker elastic round, used by the
byte-identity drills).  The visible devices come from
:func:`visible_devices`, the one place a test or a drill substitutes a
device list.
"""
from __future__ import annotations

import collections
import contextlib
import os
import queue as _queue
import threading
import time
from typing import Callable, Dict, List, Optional

ELASTIC_ENV = "DERVET_TPU_ELASTIC"
ELASTIC_DEVICES_ENV = "DERVET_TPU_ELASTIC_DEVICES"

# cost baseline for a structure the ledger has not measured yet: a
# mid-range PDLP iteration count (BENCH_r05 p50 1664, warm service 0 —
# the absolute value only matters relative to other unmeasured keys)
DEFAULT_ITERS_BASELINE = 512.0


def elastic_enabled() -> bool:
    """Elastic-scheduler kill switch (``DERVET_TPU_ELASTIC=0`` off)."""
    return os.environ.get(ELASTIC_ENV, "1").strip().lower() \
        not in ("0", "false", "off")


def device_limit() -> Optional[int]:
    raw = os.environ.get(ELASTIC_DEVICES_ENV, "").strip()
    if not raw:
        return None
    try:
        n = int(raw)
    except ValueError:
        return None
    return n if n >= 1 else None


def visible_devices(device=None) -> list:
    """The devices a dispatch on ``device`` can place groups on: every
    visible GPU (``cuda:0`` .. ``cuda:N-1``) for a CUDA dispatch, else
    the one device itself."""
    import torch

    from ..device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def elastic_devices(backend: str, device=None) -> Optional[list]:
    """The device set an elastic round may schedule over, or None when
    the elastic path is off for this dispatch: cpu backend (HiGHS, no
    devices), kill switch, or a single visible device with no explicit
    limit (one device has nothing to schedule across — the plain
    pipeline is the cheaper identical path)."""
    if backend == "cpu" or not elastic_enabled():
        return None
    devs = list(visible_devices(device))
    limit = device_limit()
    if limit is not None:
        devs = devs[:limit]
    elif len(devs) < 2:
        return None
    return devs


def estimate_group_cost(key, items, cache=None) -> float:
    """Placement cost of a structure group: window count x horizon x the
    structure's rolling iteration baseline.  The baseline comes from the
    solve ledger's feedback into the cache (``SolverCache.note_iters``,
    an EWMA of each structure's measured iters p50) or, for a warm
    service, the solution memory's cold baseline; unmeasured structures
    fall back to a flat constant so a cold round degenerates to
    windows-x-horizon LPT — still the right relative order."""
    n = len(items)
    T = getattr(items[0][1], "T", None) or 1
    baseline = None
    if cache is not None:
        hint = getattr(cache, "iters_hint", None)
        if hint is not None:
            baseline = hint(key)
        memory = getattr(cache, "memory", None)
        if baseline is None and memory is not None:
            baseline = memory.cold_p50(key)
    return float(n) * float(T) * float(baseline or DEFAULT_ITERS_BASELINE)


def worker_stream(device):
    """The context a worker runs in: a CUDA stream of its own on a CUDA
    device (the chunk kernels launch on the thread's current stream, and
    the staged uploads are made on it too, so a worker's uploads, solves
    and readbacks are ordered on its stream and two workers on one card
    overlap); nothing on any other device."""
    if getattr(device, "type", None) != "cuda":
        return contextlib.nullcontext()
    import torch
    return torch.cuda.stream(torch.cuda.Stream(device))


class GroupTask:
    """One schedulable structure group."""
    __slots__ = ("key", "items", "cost", "home", "device_index", "stolen",
                 "staged", "staged_device", "seq")

    def __init__(self, key, items, cost: float, home: int, seq: int = 0):
        self.key = key
        self.items = items
        self.cost = float(cost)
        self.home = home               # placement decision
        self.device_index = home       # where it actually solved
        self.stolen = False
        self.staged = None             # StagedGroupData (or None)
        self.staged_device = None      # device index the staging targeted
        # submission sequence number: the dispatch thread scatters
        # results in THIS order (not completion order), so the output
        # surface — CSV row order follows apply order — is deterministic
        # and identical to the serial path's
        self.seq = seq


class ElasticScheduler:
    """Per-device queues + workers with cost placement and work stealing.

    Protocol: construct, ``start(solve_fn, stage_fn)``, ``submit`` each
    group (may interleave with completions), ``close_submissions()``,
    then drain ``completions()`` on the dispatch thread; ``shutdown()``
    in a finally block.  ``solve_fn(device, device_index, task)`` runs on
    the worker thread and returns the value handed back through
    ``completions()``; ``stage_fn(device, task)`` returns the task's
    staged upload for that device (called off the queue lock)."""

    def __init__(self, devices: List):
        self.devices = list(devices)
        n = len(self.devices)
        self._queues = [collections.deque() for _ in range(n)]
        # OUTSTANDING cost per device: queued + in-flight (decremented
        # only when the group completes) — placement must see a device
        # that is mid-solve as loaded, or every early group piles onto
        # device 0 before any worker reports back
        self._qcost = [0.0] * n
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._done: _queue.Queue = _queue.Queue()
        self._stop = threading.Event()
        self._closed = False
        # which workers are mid-solve: stealing is only legitimate from
        # a BUSY device (an idle victim would pop its own queue head
        # immediately — "stealing" from it just moves the group off its
        # warm compiled-program shard for nothing, observed as phantom
        # steals + spurious per-device compiles at round start)
        self._inflight = [False] * n
        self._submitted = 0
        self._completed = 0
        self._threads: List[threading.Thread] = []
        self._t0: Optional[float] = None
        self._wall = 0.0
        # observables
        self.busy_s = [0.0] * n
        self.groups = [0] * n
        self.windows = [0] * n
        self.placed_cost = [0.0] * n
        self.steals: List[Dict] = []
        self.steals_in = [0] * n
        self.steals_out = [0] * n

    # -- placement ------------------------------------------------------
    def submit(self, key, items, cost: float,
               affinity: Optional[int] = None) -> GroupTask:
        """Place one group: cache affinity first (a device that already
        compiled this structure keeps it), else least-loaded by queued
        cost (greedy LPT — callers submit in discovery order, and the
        rolling cost estimates keep the queues balanced)."""
        with self._lock:
            if affinity is not None and 0 <= affinity < len(self.devices):
                d = affinity
            else:
                d = min(range(len(self.devices)),
                        key=lambda i: self._qcost[i])
            task = GroupTask(key, items, cost, d, seq=self._submitted)
            self._queues[d].append(task)
            self._qcost[d] += task.cost
            self._submitted += 1
            self.placed_cost[d] += task.cost
            self._cond.notify_all()
        return task

    def close_submissions(self) -> None:
        with self._lock:
            self._closed = True
            self._cond.notify_all()

    # -- worker side ----------------------------------------------------
    def _steal_victim(self, idx: int) -> Optional[int]:
        """The device with the most outstanding cost among those that
        are BUSY and still have QUEUED groups (in-flight work cannot be
        stolen; an idle device serves its own queue) — None when there
        is nothing legitimate to steal."""
        best, best_cost = None, 0.0
        for j, q in enumerate(self._queues):
            if j != idx and q and self._inflight[j] \
                    and self._qcost[j] > best_cost:
                best, best_cost = j, self._qcost[j]
        return best

    def _next(self, idx: int) -> Optional[GroupTask]:
        with self._lock:
            while True:
                if self._stop.is_set():
                    return None
                if self._queues[idx]:
                    self._inflight[idx] = True
                    return self._queues[idx].popleft()
                victim = self._steal_victim(idx)
                if victim is not None:
                    task = self._queues[victim].pop()   # tail group
                    # the outstanding cost moves with the group
                    self._qcost[victim] -= task.cost
                    self._qcost[idx] += task.cost
                    self._inflight[idx] = True
                    task.stolen = True
                    task.device_index = idx
                    self.steals_in[idx] += 1
                    self.steals_out[victim] += 1
                    self.steals.append({
                        "from_device": victim, "to_device": idx,
                        "windows": len(task.items),
                        "cost": round(task.cost, 1)})
                    return task
                if self._closed:
                    return None
                self._cond.wait(timeout=0.1)

    def _peek(self, idx: int) -> Optional[GroupTask]:
        with self._lock:
            return self._queues[idx][0] if self._queues[idx] else None

    def _commit_stage(self, idx: int, task: GroupTask, staged) -> None:
        """Attach a prestaged upload to a still-QUEUED task.  Committed
        under the scheduler lock and only while the task remains on this
        device's own queue: popping (own or steal) happens under the
        same lock, so a task that has left the queue can never receive a
        late commit — without this, a thief could read buffers committed
        to the victim's device mid-overwrite."""
        with self._lock:
            if task in self._queues[idx]:
                task.staged = staged
                task.staged_device = idx

    def _worker(self, idx: int, solve_fn, stage_fn) -> None:
        with worker_stream(self.devices[idx]):
            self._work(idx, solve_fn, stage_fn)

    def _work(self, idx: int, solve_fn, stage_fn) -> None:
        device = self.devices[idx]
        while True:
            task = self._next(idx)
            if task is None:
                return
            # from here the task is exclusively this worker's: pops are
            # serialized under the lock and prestage commits require
            # queue membership, so no other thread writes it again
            task.device_index = idx
            t0 = time.perf_counter()
            try:
                if stage_fn is not None and (task.staged is None
                                             or task.staged_device != idx):
                    # stolen (or never-staged) group: its upload targets
                    # THIS device now
                    task.staged = stage_fn(device, task)
                    task.staged_device = idx
                # per-device staged-upload pipeline: enqueue the NEXT
                # queued group's async device_put before blocking in this
                # group's solve, so the transfer rides under the solve
                # (a thief re-stages if it takes the group first — the
                # wasted upload is bounded by one group per device)
                nxt = self._peek(idx)
                if stage_fn is not None and nxt is not None \
                        and nxt.staged is None:
                    self._commit_stage(idx, nxt, stage_fn(device, nxt))
                result = solve_fn(device, idx, task)
                err = None
            except BaseException as e:    # propagated on the dispatch thread
                result, err = None, e
            dt = time.perf_counter() - t0
            with self._lock:
                self.busy_s[idx] += dt
                self.groups[idx] += 1
                self.windows[idx] += len(task.items)
                self._qcost[idx] -= task.cost   # outstanding -> done
                self._inflight[idx] = False
                # a queue may have refilled behind a busy worker — wake
                # potential thieves now that stealing from it is legal
                self._cond.notify_all()
            self._done.put((task, result, err))

    # -- dispatch-thread side ------------------------------------------
    def start(self, solve_fn: Callable, stage_fn: Optional[Callable] = None
              ) -> "ElasticScheduler":
        self._t0 = time.perf_counter()
        for i in range(len(self.devices)):
            t = threading.Thread(target=self._worker,
                                 args=(i, solve_fn, stage_fn),
                                 name=f"dervet-elastic-d{i}", daemon=True)
            self._threads.append(t)
            t.start()
        return self

    def completions(self):
        """Yield ``(task, result, error)`` for every submitted group, in
        completion order; returns when all submitted groups completed
        (requires ``close_submissions`` to have been called by then).
        Raising out of the consuming loop (scatter errors, preemption)
        is safe — ``shutdown()`` stops the workers."""
        while True:
            with self._lock:
                if self._closed and self._completed >= self._submitted:
                    return
            try:
                item = self._done.get(timeout=0.5)
            except _queue.Empty:
                if not any(t.is_alive() for t in self._threads):
                    with self._lock:
                        drained = (self._completed >= self._submitted
                                   and self._closed)
                    if drained:
                        return
                    raise RuntimeError(
                        "elastic scheduler: all workers exited with "
                        f"{self._submitted - self._completed} group(s) "
                        "unaccounted")
                continue
            with self._lock:
                self._completed += 1
            self._wall = time.perf_counter() - self._t0
            yield item

    def shutdown(self) -> None:
        """Stop the workers (current solves finish; queued groups are
        abandoned — the preemption/error path) and join them."""
        self._stop.set()
        with self._lock:
            self._cond.notify_all()
        for t in self._threads:
            t.join()
        if self._t0 is not None and not self._wall:
            self._wall = time.perf_counter() - self._t0

    # -- observability --------------------------------------------------
    def stats(self) -> Dict:
        """The round's elastic observables for ``solve_ledger.elastic``:
        per-device occupancy (busy wall over round wall — the >= 70%
        serving gate), group/window/steal counts, placement cost."""
        wall = self._wall or (time.perf_counter() - self._t0
                              if self._t0 else 0.0)
        devices = {}
        for i in range(len(self.devices)):
            devices[str(i)] = {
                "groups": self.groups[i],
                "windows": self.windows[i],
                "busy_s": round(self.busy_s[i], 4),
                "occupancy": round(self.busy_s[i] / wall, 4) if wall else 0.0,
                "steals_in": self.steals_in[i],
                "steals_out": self.steals_out[i],
                "placed_cost": round(self.placed_cost[i], 1),
            }
        return {
            "n_devices": len(self.devices),
            "round_wall_s": round(wall, 4),
            "devices": devices,
            "n_steals": len(self.steals),
            "steals": self.steals[:64],
            "devices_with_groups": sum(1 for g in self.groups if g),
        }
