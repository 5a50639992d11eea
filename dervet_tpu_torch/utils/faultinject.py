"""Deterministic fault injection for the solver resilience layer.

PDLP-family first-order solvers have heavy-tailed iteration counts on
ill-conditioned instances (PAPERS.md: MPAX; DuaLip), so the dispatch loop
treats non-convergence as an expected operating condition and recovers
through an escalation ladder (scenario.resolve_group): boosted-budget
retry -> exact CPU fallback -> case quarantine.  Recovery code that only
runs on rare hardware/numerical events is effectively untested — this
module lets tests (and operators debugging a sweep) FORCE a failure at
each rung deterministically, so every recovery path is exercised rather
than trusted.

Two activation paths:

* context manager (tests)::

      with faultinject.inject(nonconverge={1}, rungs={"solve", "retry"}):
          scenario.optimize_problem_loop(backend="cpu")

* environment variables (whole-process, e.g. a driver run)::

      DERVET_TPU_FAULT_NONCONVERGE=3,7   force windows 3 and 7 to report
                                         non-convergence ('all' matches
                                         every window)
      DERVET_TPU_FAULT_RUNGS=solve,retry rungs at which the forced
                                         non-convergence applies
                                         (default: solve)
      DERVET_TPU_FAULT_POISON_CASE=2     poison case 2's assembled inputs
                                         with NaN before dispatch
      DERVET_TPU_FAULT_CPU_FAIL=3        make the exact-CPU fallback rung
                                         itself report failure for these
                                         windows ('all' for every window)
      DERVET_TPU_FAULT_HANG=1            hang the solve of window 1 (sleep
                                         DERVET_TPU_FAULT_HANG_S, default
                                         60 s) at the configured rungs —
                                         exercises the solve watchdog
      DERVET_TPU_FAULT_SLOW=1            slow the solve of window 1 by
                                         DERVET_TPU_FAULT_SLOW_S (default
                                         1 s) at the configured rungs
      DERVET_TPU_FAULT_PREEMPT_AFTER=2   self-deliver SIGTERM after 2
                                         window-batch boundaries —
                                         exercises graceful shutdown +
                                         the resume manifest (requires a
                                         RunSupervisor to be installed,
                                         or the default disposition kills
                                         the process)
      DERVET_TPU_FAULT_CORRUPT=1         deterministically perturb window
                                         1's RETURNED solution vector at
                                         the configured rungs (scale
                                         DERVET_TPU_FAULT_CORRUPT_SCALE,
                                         default 0.05) — exercises the
                                         float64 certification layer:
                                         the solver reports success, the
                                         numbers are wrong, and only the
                                         independent certifier can catch
                                         it ('all' matches every window)
      DERVET_TPU_FAULT_OVERLOAD=1        force the scenario service's
                                         admission queue to report FULL —
                                         every submit is rejected with the
                                         typed queue-full error (clean
                                         backpressure, never a crash), so
                                         overload handling and client
                                         retry-after logic are drillable;
                                         DERVET_TPU_FAULT_OVERLOAD_N=2
                                         bounds it to the first 2
                                         admissions (then the queue
                                         behaves normally)
      DERVET_TPU_FAULT_DEVICE_LOSS=1     raise a DeviceLossError (the
                                         injected analogue of an
                                         XlaRuntimeError device loss)
                                         from inside the solve call —
                                         exercises the service's
                                         backend-loss recovery: teardown,
                                         warmup_devices re-init, in-round
                                         replay from checkpoints, CPU
                                         failover.
                                         DERVET_TPU_FAULT_DEVICE_LOSS_AFTER=2
                                         arms it after 2 solve calls
                                         complete (default 0: the first
                                         call dies);
                                         DERVET_TPU_FAULT_DEVICE_LOSS_N=3
                                         fires 3 consecutive losses
                                         (default 1) — drills N-failed-
                                         re-inits -> a lost round.
                                         DERVET_TPU_FAULT_DEVICE_LOSS=sticky
                                         on a CUDA device provokes a
                                         REAL device-side assert (an
                                         out-of-range gather, then a
                                         synchronize) where the typed
                                         error is raised: the process's
                                         CUDA context stays unusable, so
                                         every re-init fails.  Arm it in
                                         a child process's environment
                                         only (a fleet replica) — never
                                         in a process whose context must
                                         survive.  On the CPU it raises
                                         the typed error.
      DERVET_TPU_FAULT_STALE_SEED=1      deterministically corrupt window
                                         1's WARM-START seed (x and y)
                                         before the seeded solve (scale
                                         DERVET_TPU_FAULT_STALE_SEED_SCALE,
                                         default 0.5) — exercises the
                                         warm-start safety contract: a
                                         stale/poisoned seed is demoted
                                         from exact substitution to
                                         iterate seeding, the solve still
                                         runs full convergence criteria
                                         (and certification), and the
                                         corruption can only cost
                                         iterations, never correctness
                                         ('all' matches every window)
      DERVET_TPU_FAULT_STRAGGLER=1       straggler DEVICE: every elastic
                                         per-device solve on ONE device
                                         (index DERVET_TPU_FAULT_
                                         STRAGGLER_DEVICE, default 0) is
                                         delayed by DERVET_TPU_FAULT_
                                         STRAGGLER_S (default 0.75 s)
                                         seconds — a deterministic slow
                                         device, so the elastic
                                         scheduler's work stealing is
                                         drillable: the healthy devices
                                         must steal the straggler's
                                         queued groups and the round
                                         must finish correct
      DERVET_TPU_FAULT_REPLICA_CRASH=2   fleet replica drill: the serve
                                         loop hard-exits (``os._exit``,
                                         the SIGKILL analogue — no drain,
                                         no atexit, no journal flush
                                         beyond what already fsync'd)
                                         once 2 spool requests have been
                                         admitted — exercises the fleet
                                         router's death detection +
                                         journal failover path
                                         deterministically; one-shot via
                                         the env-plan memo
      DERVET_TPU_FAULT_REPLICA_HANG=2    fleet replica drill: the serve
                                         SCAN loop (the thread that
                                         writes heartbeats) sleeps
                                         DERVET_TPU_FAULT_REPLICA_HANG_S
                                         (default 3600 s) once 2 requests
                                         have been admitted — heartbeats
                                         stop while the process stays
                                         alive, the shape of failure only
                                         the router's missed-heartbeat
                                         watchdog can see; one-shot
      DERVET_TPU_FAULT_POISON=rid.0      poison-REQUEST crash: dispatching
                                         the targeted case raises an
                                         injected crash EVERY time it is
                                         attempted ('all' matches every
                                         case) — unlike the NaN poison
                                         above, which the input guards
                                         absorb gracefully, this models a
                                         request that keeps killing the
                                         whole round it is co-batched
                                         into; exercises the service's
                                         poison-quarantine path
                                         (isolation re-runs, two-strike
                                         fingerprint blocklist, typed
                                         PoisonRequestError)

Faults are observational flips, input corruptions, delays, and signals
only — the injector never touches solver internals, so the production
code path under test is exactly the path a real failure takes.  When no
knob is set every hook is a cheap no-op.
"""
from __future__ import annotations

import contextlib
import os
import signal
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np

# ladder rung names (also recorded in FaultPlan.fired)
RUNG_SOLVE = "solve"       # the initial (batched) group solve
RUNG_RETRY = "retry"       # the boosted-budget re-solve of failed members
RUNG_CPU = "cpu"           # the exact CPU fallback
EVENT_POISON = "poison"    # input poisoning of a case
EVENT_HANG = "hang"        # solve call put to sleep past the watchdog
EVENT_SLOW = "slow_solve"  # solve call delayed (bounded)
EVENT_PREEMPT = "preempt"  # self-delivered SIGTERM at a batch boundary
EVENT_CORRUPT = "corrupt_solution"  # solution vector perturbed post-solve
EVENT_OVERLOAD = "overload"         # service admission forced to reject
EVENT_DEVICE_LOSS = "device_loss"   # backend death raised mid-solve
EVENT_POISON_CASE = "poison_case"   # targeted case crashes its dispatch
EVENT_STALE_SEED = "stale_seed"     # warm-start seed corrupted pre-solve
EVENT_STRAGGLER = "straggler"       # one device's solves slowed (elastic)
EVENT_REPLICA_CRASH = "replica_crash"   # serve loop hard-exits (SIGKILL-like)
EVENT_REPLICA_HANG = "replica_hang"     # serve loop sleeps; heartbeats stop
EVENT_DIVERGING_DUALS = "diverging_duals"  # portfolio dual update corrupted
EVENT_BAD_SAMPLE = "bad_sample"     # one MC sampled trajectory NaN-poisoned


class InjectedCrashError(RuntimeError):
    """The ``poison_case`` fault's crash: an arbitrary non-backend
    runtime error raised from inside a targeted case's dispatch — the
    shape of failure the service's poison-request quarantine attributes
    and blocklists.  Deliberately NOT a DeviceLossError: backend-loss
    recovery must not try to re-init the device over it."""


def _norm(values) -> frozenset:
    """Normalize labels/case ids to a set of strings ('all'/'*' matches
    everything)."""
    if values is None:
        return frozenset()
    if isinstance(values, str):
        values = [v for v in values.split(",") if v.strip()]
    return frozenset(str(v).strip() for v in values)


def _match(targets: frozenset, value) -> bool:
    if not targets:
        return False
    return "all" in targets or "*" in targets or str(value) in targets


class FaultPlan:
    """One configured set of faults; records every fired event so tests
    can assert the rungs executed in order."""

    def __init__(self, nonconverge: Iterable = (), rungs: Iterable = (RUNG_SOLVE,),
                 poison_cases: Iterable = (), cpu_fail: Iterable = (),
                 hang: Iterable = (), hang_seconds: float = 60.0,
                 slow: Iterable = (), slow_seconds: float = 1.0,
                 preempt_after: Optional[int] = None,
                 corrupt: Iterable = (), corrupt_scale: float = 0.05,
                 overload: bool = False,
                 overload_n: Optional[int] = None,
                 device_loss: bool = False,
                 device_loss_after: int = 0,
                 device_loss_n: int = 1,
                 device_loss_sticky: bool = False,
                 crash_cases: Iterable = (),
                 stale_seed: Iterable = (),
                 stale_seed_scale: float = 0.5,
                 straggler: bool = False,
                 straggler_device: int = 0,
                 straggler_seconds: float = 0.75,
                 replica_crash_after: Optional[int] = None,
                 replica_hang_after: Optional[int] = None,
                 replica_hang_seconds: float = 3600.0,
                 diverge_duals_round: Optional[int] = None,
                 diverge_duals_scale: float = 25.0,
                 bad_sample: Iterable = ()):
        self.nonconverge = _norm(nonconverge)
        self.rungs = _norm(rungs)
        self.poison_cases = _norm(poison_cases)
        self.cpu_fail = _norm(cpu_fail)
        # hang/slow target window labels and honor the same ``rungs`` set
        # as nonconverge, so a hang can be drilled at any ladder rung
        self.hang = _norm(hang)
        self.hang_seconds = float(hang_seconds)
        self.slow = _norm(slow)
        self.slow_seconds = float(slow_seconds)
        # preempt: SIGTERM self-delivery after N window-batch boundaries
        self.preempt_after = (None if preempt_after is None
                              else int(preempt_after))
        # corrupt_solution: perturb a RETURNED solution vector (targets
        # window labels, honors ``rungs`` like nonconverge)
        self.corrupt = _norm(corrupt)
        self.corrupt_scale = float(corrupt_scale)
        # overload: admission-queue rejections (service backpressure drill);
        # overload_n bounds the drill to the first N admissions, None = all
        self.overload = bool(overload)
        self.overload_n = None if overload_n is None else int(overload_n)
        self._overload_fired = 0
        # device_loss: kill the backend from inside a solve call —
        # armed after `device_loss_after` solve calls complete, fires
        # `device_loss_n` consecutive times (so N-failed-re-init ->
        # lost-round ladders are drillable), then the backend "heals"
        self.device_loss = bool(device_loss)
        self.device_loss_after = int(device_loss_after)
        self.device_loss_n = int(device_loss_n)
        # sticky: the loss is a genuine device-side assert on a CUDA
        # device (see maybe_device_loss), not only the typed error
        self.device_loss_sticky = bool(device_loss_sticky)
        self._solve_calls = 0
        self._device_loss_fired = 0
        # crash_cases (the `poison_case` kind): dispatching a targeted
        # case raises an InjectedCrashError EVERY attempt — a genuinely
        # poisonous request keeps crashing on retry, which is exactly
        # what the two-strike quarantine needs to observe
        self.crash_cases = _norm(crash_cases)
        # stale_seed: corrupt a targeted window's warm-start seed before
        # the seeded solve (ops/warmstart.plan_group applies it) — the
        # corruption is rung-independent (seeds exist only where warm
        # starts do) and deterministic per label
        self.stale_seed = _norm(stale_seed)
        self.stale_seed_scale = float(stale_seed_scale)
        # straggler: slow every elastic solve on ONE device — the
        # deterministic work-stealing drill (healthy devices must steal
        # the slow device's queued groups; correctness is untouched
        # because the delay is outside the solver)
        self.straggler = bool(straggler)
        self.straggler_device = int(straggler_device)
        self.straggler_seconds = float(straggler_seconds)
        # replica_crash / replica_hang (fleet failover drills): fire once
        # the serve loop has admitted N spool requests — "mid-round" by
        # construction, since the batch those admissions joined is still
        # in flight when the Nth admission lands.  Both are one-shot (the
        # env-plan memo keeps this plan object alive across hook calls).
        self.replica_crash_after = (None if replica_crash_after is None
                                    else int(replica_crash_after))
        self.replica_hang_after = (None if replica_hang_after is None
                                   else int(replica_hang_after))
        self.replica_hang_seconds = float(replica_hang_seconds)
        self._replica_crash_fired = False
        self._replica_hang_fired = False
        # diverging_duals (portfolio dual loop): corrupt the combined
        # dual-price vector ONCE, at outer round `diverge_duals_round` —
        # the loop must detect the non-monotone gap, rescale its step,
        # and still converge + certify
        self.diverge_duals_round = (None if diverge_duals_round is None
                                    else int(diverge_duals_round))
        self.diverge_duals_scale = float(diverge_duals_scale)
        self._diverge_fired = False
        # bad_sample (the MC drill): NaN-poison the SAMPLED trajectory of
        # the targeted Monte-Carlo sample indices — the pre-dispatch
        # input guards must quarantine exactly those samples (with the
        # sample-labeled case id in the diagnostic) while the rest of
        # the batch completes
        self.bad_sample = _norm(bad_sample)
        self._preempt_fired = False
        self.fired: List[Tuple[str, str]] = []   # (rung/event, label/case)

    def force_nonconverge(self, label, rung: str) -> bool:
        """Should the solve of window ``label`` at ``rung`` be reported as
        non-converged?"""
        if rung in self.rungs and _match(self.nonconverge, label):
            self.fired.append((rung, str(label)))
            return True
        return False

    def should_poison(self, case_id) -> bool:
        if _match(self.poison_cases, case_id):
            self.fired.append((EVENT_POISON, str(case_id)))
            return True
        return False

    def cpu_should_fail(self, label) -> bool:
        if _match(self.cpu_fail, label):
            self.fired.append((RUNG_CPU, str(label)))
            return True
        return False

    def sleep_seconds(self, labels, rung: str) -> Tuple[float, str]:
        """Delay (seconds, event kind) the solve of any of ``labels`` at
        ``rung`` should suffer — (0, "") when untargeted.  ``hang`` wins
        over ``slow_solve`` when both match."""
        if rung not in self.rungs:
            return 0.0, ""
        if not isinstance(labels, (list, tuple, set, frozenset)):
            labels = (labels,)
        for kind, targets, secs in (
                (EVENT_HANG, self.hang, self.hang_seconds),
                (EVENT_SLOW, self.slow, self.slow_seconds)):
            hit = [lb for lb in labels if _match(targets, lb)]
            if hit:
                self.fired.append((kind, str(hit[0])))
                return secs, kind
        return 0.0, ""

    def corrupt_due(self, label, rung: str) -> bool:
        """Should window ``label``'s solution be perturbed at ``rung``?"""
        if rung in self.rungs and _match(self.corrupt, label):
            self.fired.append((EVENT_CORRUPT, str(label)))
            return True
        return False

    def overload_due(self) -> bool:
        """Should the next service admission be rejected as queue-full?"""
        if not self.overload:
            return False
        if self.overload_n is not None and \
                self._overload_fired >= self.overload_n:
            return False
        self._overload_fired += 1
        self.fired.append((EVENT_OVERLOAD, str(self._overload_fired)))
        return True

    def device_loss_due(self) -> bool:
        """Should THIS solve call die with a device loss?  Counts solve
        calls; fires on calls ``after < n_calls <= after + n``."""
        if not self.device_loss:
            return False
        self._solve_calls += 1
        if self._solve_calls <= self.device_loss_after or \
                self._device_loss_fired >= self.device_loss_n:
            return False
        self._device_loss_fired += 1
        self.fired.append((EVENT_DEVICE_LOSS, str(self._solve_calls)))
        return True

    def stale_seed_due(self, label) -> bool:
        """Should window ``label``'s warm-start seed be corrupted?"""
        if _match(self.stale_seed, label):
            self.fired.append((EVENT_STALE_SEED, str(label)))
            return True
        return False

    def straggler_delay(self, device_index: int) -> float:
        """Seconds an elastic solve on device ``device_index`` should be
        delayed (0 when the straggler fault is off or targets another
        device)."""
        if not self.straggler or int(device_index) != self.straggler_device:
            return 0.0
        self.fired.append((EVENT_STRAGGLER, str(device_index)))
        return self.straggler_seconds

    def should_crash(self, case_id) -> bool:
        if _match(self.crash_cases, case_id):
            self.fired.append((EVENT_POISON_CASE, str(case_id)))
            return True
        return False

    def replica_crash_due(self, admissions_done: int) -> bool:
        """Should the serve loop hard-exit now (``admissions_done`` spool
        requests admitted so far)?  One-shot."""
        if self.replica_crash_after is None or self._replica_crash_fired \
                or admissions_done < self.replica_crash_after:
            return False
        self._replica_crash_fired = True
        self.fired.append((EVENT_REPLICA_CRASH, str(admissions_done)))
        return True

    def replica_hang_seconds_due(self, admissions_done: int) -> float:
        """Seconds the serve scan loop should wedge for (0 when the
        ``replica_hang`` fault is off / not yet due / already fired)."""
        if self.replica_hang_after is None or self._replica_hang_fired \
                or admissions_done < self.replica_hang_after:
            return 0.0
        self._replica_hang_fired = True
        self.fired.append((EVENT_REPLICA_HANG, str(admissions_done)))
        return self.replica_hang_seconds

    def diverge_duals_due(self, round_idx: int) -> bool:
        """Should THIS outer dual round's price update be corrupted?
        One-shot, keyed on the round index."""
        if self.diverge_duals_round is None or self._diverge_fired or \
                int(round_idx) != self.diverge_duals_round:
            return False
        self._diverge_fired = True
        self.fired.append((EVENT_DIVERGING_DUALS, str(round_idx)))
        return True

    def bad_sample_due(self, sample_idx) -> bool:
        """Should Monte-Carlo sample ``sample_idx``'s trajectory be
        NaN-poisoned?"""
        if _match(self.bad_sample, sample_idx):
            self.fired.append((EVENT_BAD_SAMPLE, str(sample_idx)))
            return True
        return False

    def preempt_due(self, batches_done: int) -> bool:
        if self.preempt_after is None or self._preempt_fired or \
                batches_done < self.preempt_after:
            return False
        self._preempt_fired = True
        self.fired.append((EVENT_PREEMPT, str(batches_done)))
        return True


_ACTIVE: Optional[FaultPlan] = None

# env-plan memo: faults carry per-plan state (the one-shot preempt latch,
# the ``fired`` log), so the env path must hand back the SAME plan object
# across hook calls — rebuilding per call would re-deliver a "one-shot"
# SIGTERM at every batch boundary.  Keyed on a snapshot of the knob values
# so tests that monkeypatch the environment still see a fresh plan.
_ENV_VARS = ("DERVET_TPU_FAULT_NONCONVERGE", "DERVET_TPU_FAULT_POISON_CASE",
             "DERVET_TPU_FAULT_CPU_FAIL", "DERVET_TPU_FAULT_RUNGS",
             "DERVET_TPU_FAULT_HANG", "DERVET_TPU_FAULT_HANG_S",
             "DERVET_TPU_FAULT_SLOW", "DERVET_TPU_FAULT_SLOW_S",
             "DERVET_TPU_FAULT_PREEMPT_AFTER", "DERVET_TPU_FAULT_CORRUPT",
             "DERVET_TPU_FAULT_CORRUPT_SCALE", "DERVET_TPU_FAULT_OVERLOAD",
             "DERVET_TPU_FAULT_OVERLOAD_N", "DERVET_TPU_FAULT_DEVICE_LOSS",
             "DERVET_TPU_FAULT_DEVICE_LOSS_AFTER",
             "DERVET_TPU_FAULT_DEVICE_LOSS_N", "DERVET_TPU_FAULT_POISON",
             "DERVET_TPU_FAULT_STALE_SEED",
             "DERVET_TPU_FAULT_STALE_SEED_SCALE",
             "DERVET_TPU_FAULT_STRAGGLER",
             "DERVET_TPU_FAULT_STRAGGLER_DEVICE",
             "DERVET_TPU_FAULT_STRAGGLER_S",
             "DERVET_TPU_FAULT_REPLICA_CRASH",
             "DERVET_TPU_FAULT_REPLICA_HANG",
             "DERVET_TPU_FAULT_REPLICA_HANG_S",
             "DERVET_TPU_FAULT_DIVERGE_DUALS",
             "DERVET_TPU_FAULT_DIVERGE_DUALS_SCALE",
             "DERVET_TPU_FAULT_BAD_SAMPLE",
             "DERVET_TPU_FAULT_BAD_SAMPLE_IDX")
_ENV_PLAN: Optional[FaultPlan] = None
_ENV_SNAPSHOT: Optional[tuple] = None


def _plan_from_env() -> Optional[FaultPlan]:
    nc = os.environ.get("DERVET_TPU_FAULT_NONCONVERGE")
    pc = os.environ.get("DERVET_TPU_FAULT_POISON_CASE")
    cf = os.environ.get("DERVET_TPU_FAULT_CPU_FAIL")
    hg = os.environ.get("DERVET_TPU_FAULT_HANG")
    sl = os.environ.get("DERVET_TPU_FAULT_SLOW")
    pa = os.environ.get("DERVET_TPU_FAULT_PREEMPT_AFTER")
    cr = os.environ.get("DERVET_TPU_FAULT_CORRUPT")
    ov = os.environ.get("DERVET_TPU_FAULT_OVERLOAD", "").strip().lower()
    ov_on = ov not in ("", "0", "false", "off")
    dl = os.environ.get("DERVET_TPU_FAULT_DEVICE_LOSS", "").strip().lower()
    dl_on = dl not in ("", "0", "false", "off")
    crash = os.environ.get("DERVET_TPU_FAULT_POISON")
    ss = os.environ.get("DERVET_TPU_FAULT_STALE_SEED")
    st = os.environ.get("DERVET_TPU_FAULT_STRAGGLER", "").strip().lower()
    st_on = st not in ("", "0", "false", "off")
    rcr = os.environ.get("DERVET_TPU_FAULT_REPLICA_CRASH")
    rhg = os.environ.get("DERVET_TPU_FAULT_REPLICA_HANG")
    dd = os.environ.get("DERVET_TPU_FAULT_DIVERGE_DUALS")
    bs = os.environ.get("DERVET_TPU_FAULT_BAD_SAMPLE", "").strip().lower()
    bs_on = bs not in ("", "0", "false", "off")
    if not (nc or pc or cf or hg or sl or pa or cr or ov_on or dl_on
            or crash or ss or st_on or rcr or rhg or dd or bs_on):
        return None
    # bad_sample targets: the _IDX knob wins; else the BAD_SAMPLE value
    # itself when it names indices ("3" / "3,7" / "all"); a plain
    # boolean-truthy value ("1"/"true"/"on") defaults to sample 0
    bs_idx = os.environ.get("DERVET_TPU_FAULT_BAD_SAMPLE_IDX")
    if not bs_on:
        bad_sample = ()
    elif bs_idx:
        bad_sample = bs_idx
    elif bs in ("1", "true", "on", "yes"):
        bad_sample = "0"
    else:
        bad_sample = bs
    ov_n = os.environ.get("DERVET_TPU_FAULT_OVERLOAD_N")
    rungs = os.environ.get("DERVET_TPU_FAULT_RUNGS", RUNG_SOLVE)
    return FaultPlan(
        nonconverge=nc or (), rungs=rungs,
        poison_cases=pc or (), cpu_fail=cf or (),
        hang=hg or (),
        hang_seconds=float(os.environ.get("DERVET_TPU_FAULT_HANG_S", 60)),
        slow=sl or (),
        slow_seconds=float(os.environ.get("DERVET_TPU_FAULT_SLOW_S", 1)),
        preempt_after=int(pa) if pa else None,
        corrupt=cr or (),
        corrupt_scale=float(
            os.environ.get("DERVET_TPU_FAULT_CORRUPT_SCALE", 0.05)),
        overload=ov_on,
        overload_n=int(ov_n) if ov_n else None,
        device_loss=dl_on,
        device_loss_after=int(
            os.environ.get("DERVET_TPU_FAULT_DEVICE_LOSS_AFTER", 0)),
        device_loss_n=int(
            os.environ.get("DERVET_TPU_FAULT_DEVICE_LOSS_N", 1)),
        device_loss_sticky=(dl == "sticky"),
        crash_cases=crash or (),
        stale_seed=ss or (),
        stale_seed_scale=float(
            os.environ.get("DERVET_TPU_FAULT_STALE_SEED_SCALE", 0.5)),
        straggler=st_on,
        straggler_device=int(
            os.environ.get("DERVET_TPU_FAULT_STRAGGLER_DEVICE", 0)),
        straggler_seconds=float(
            os.environ.get("DERVET_TPU_FAULT_STRAGGLER_S", 0.75)),
        replica_crash_after=int(rcr) if rcr else None,
        replica_hang_after=int(rhg) if rhg else None,
        replica_hang_seconds=float(
            os.environ.get("DERVET_TPU_FAULT_REPLICA_HANG_S", 3600)),
        diverge_duals_round=int(dd) if dd else None,
        diverge_duals_scale=float(
            os.environ.get("DERVET_TPU_FAULT_DIVERGE_DUALS_SCALE", 25.0)),
        bad_sample=bad_sample)


def get_plan() -> Optional[FaultPlan]:
    """The active fault plan: the innermost ``inject()`` context if one is
    open, else one parsed from the environment (memoized per knob
    snapshot, so stateful faults stay one-shot), else None (the normal,
    zero-overhead case)."""
    global _ENV_PLAN, _ENV_SNAPSHOT
    if _ACTIVE is not None:
        return _ACTIVE
    snap = tuple(os.environ.get(k) for k in _ENV_VARS)
    if snap != _ENV_SNAPSHOT:
        _ENV_SNAPSHOT = snap
        _ENV_PLAN = _plan_from_env()
    return _ENV_PLAN


@contextlib.contextmanager
def inject(**kwargs):
    """Install a :class:`FaultPlan` for the duration of the block and yield
    it (its ``fired`` log lets tests assert rung ordering)."""
    global _ACTIVE
    plan = FaultPlan(**kwargs)
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def maybe_poison(case_id, lp) -> bool:
    """If ``case_id`` is targeted, corrupt the assembled LP's cost vector
    with NaN (in place) — exercising the pre-dispatch input guards exactly
    as corrupted upstream data would."""
    plan = get_plan()
    if plan is None or not plan.should_poison(case_id):
        return False
    c = np.asarray(lp.c)
    c[: max(1, c.shape[0] // 16)] = np.nan
    return True


def maybe_sleep(labels, rung: str) -> float:
    """``hang``/``slow_solve`` injection point, called INSIDE the
    watchdog-guarded solve closure so a targeted delay is observed
    exactly where a wedged device call would be.  Returns the seconds
    slept (0 in the no-plan fast path)."""
    plan = get_plan()
    if plan is None:
        return 0.0
    secs, kind = plan.sleep_seconds(labels, rung)
    if secs > 0:
        time.sleep(secs)
    return secs


def corrupt_array(x: np.ndarray, label, scale: float = 0.05) -> np.ndarray:
    """Deterministically perturb a solution vector:
    ``x += scale * (1 + |x|) * r`` with ``r ~ U[-1, 1]`` seeded by a
    cryptographic digest of the window label — the same label always
    produces the same corruption, so a caught-and-escalated drill is
    reproducible bit for bit.  The additive ``(1 + |x|)`` form perturbs
    zero entries too (bound violations) while staying scale-free on the
    active ones (balance-row violations + objective disagreement) — all
    three certificate row classes light up.  Mutates in place when the
    array is writable; device-fetched result arrays are read-only, so
    the (possibly copied) corrupted array is RETURNED and callers must
    use the return value."""
    import hashlib

    x = np.asarray(x)
    if not x.flags.writeable:
        x = x.copy()
    seed = int.from_bytes(
        hashlib.sha256(f"corrupt|{label}".encode()).digest()[:8], "big")
    r = np.random.default_rng(seed).uniform(-1.0, 1.0, size=x.shape)
    x += scale * (1.0 + np.abs(x)) * r
    return x


def maybe_corrupt(label, x, rung: str,
                  plan: Optional[FaultPlan] = None) -> Optional[np.ndarray]:
    """``corrupt_solution`` injection point: perturb window ``label``'s
    accepted solution vector when targeted at ``rung``, returning the
    corrupted array (None when untargeted — the fast path).  The
    solver's own verdict (converged, residuals, objective) is left
    untouched — exactly the silent-wrong-answer shape the float64
    certification layer exists to catch."""
    plan = plan if plan is not None else get_plan()
    if plan is None or not plan.corrupt_due(label, rung):
        return None
    return corrupt_array(x, label, plan.corrupt_scale)


def maybe_overload() -> bool:
    """``overload`` injection point at the service admission queue: when
    targeted, the admission is rejected exactly as a genuinely full queue
    would reject it (typed queue-full error with a retry-after hint) —
    so backpressure handling and client retry logic are drillable without
    actually saturating a queue."""
    plan = get_plan()
    return plan is not None and plan.overload_due()


def maybe_device_loss(device=None) -> None:
    """``device_loss`` injection point, called at the top of each solve
    call: when due, raise the injected backend-death error — exactly
    where a real CUDA runtime error would surface — so the service's
    teardown / warmup re-init / checkpoint replay / lost-round chain
    is exercised end to end.  A ``sticky`` plan on a CUDA ``device``
    first provokes a real device-side assert (:func:`provoke_device_assert`),
    whose CUDA error is what raises."""
    from .errors import DeviceLossError
    plan = get_plan()
    if plan is not None and plan.device_loss_due():
        if plan.device_loss_sticky and device is not None:
            provoke_device_assert(device)
        raise DeviceLossError(
            "fault injection: device loss — backend died mid-solve")


def provoke_device_assert(device) -> None:
    """A genuine sticky CUDA fault on ``device``: a gather at an index
    far out of range trips the indexing kernel's device-side assert, and
    the synchronize raises it ("device-side assert triggered").  The
    process's CUDA context is unusable from then on.  A no-op for a
    non-CUDA device."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    x = torch.zeros(8, device=dev)
    bad = torch.full((1,), 1 << 30, dtype=torch.long, device=dev)
    x[bad]
    torch.cuda.synchronize(dev)


def maybe_straggle(device_index: int) -> float:
    """``straggler`` injection point at the top of an elastic per-device
    solve: when this worker's device is the targeted straggler, sleep —
    the deterministic slow-device drill for the work-stealing path.
    Returns the seconds slept (0 in the no-plan fast path)."""
    plan = get_plan()
    if plan is None:
        return 0.0
    secs = plan.straggler_delay(device_index)
    if secs > 0:
        time.sleep(secs)
    return secs


def maybe_crash_case(case_id) -> None:
    """``poison_case`` injection point at the pre-dispatch boundary:
    a targeted case raises an injected crash EVERY time its dispatch is
    attempted (a genuinely poisonous request keeps crashing on retry) —
    the service's isolation re-runs attribute it, and the two-strike
    registry quarantines + blocklists its fingerprint."""
    plan = get_plan()
    if plan is not None and plan.should_crash(case_id):
        raise InjectedCrashError(
            f"fault injection: poison request crash (case {case_id})")


def maybe_replica_crash(admissions_done: int) -> None:
    """``replica_crash`` injection point in the serve scan loop, checked
    after each spool admission: when due, the process hard-exits via
    ``os._exit`` — the closest in-process analogue of a SIGKILL (no
    drain, no atexit, no buffered writes beyond what already fsync'd) —
    so the fleet router's missed-heartbeat death detection and
    journal-based failover run against a genuinely unclean death."""
    plan = get_plan()
    if plan is not None and plan.replica_crash_due(admissions_done):
        os._exit(2)


def maybe_replica_hang(admissions_done: int) -> float:
    """``replica_hang`` injection point at the top of the serve scan
    loop (the thread that writes heartbeats): when due, sleep — the
    process stays alive, its batcher may even finish in-flight work, but
    heartbeats stop; only the router's staleness watchdog can tell.
    Returns the seconds slept (0 in the no-plan fast path)."""
    plan = get_plan()
    if plan is None:
        return 0.0
    secs = plan.replica_hang_seconds_due(admissions_done)
    if secs > 0:
        time.sleep(secs)
    return secs


def maybe_diverge_duals(round_idx: int, price: np.ndarray
                        ) -> Optional[np.ndarray]:
    """``diverging_duals`` injection point in the portfolio outer loop,
    called on the combined dual-price vector right after a dual update:
    when due, return a deterministically corrupted copy (scaled +
    perturbed, clipped non-negative — a wildly wrong but sign-valid
    price vector); None in the no-plan fast path.  The loop's
    non-monotone-gap detector must catch the regression, rescale its
    dual step, and still converge + certify — dual corruption costs
    outer rounds, never correctness."""
    plan = get_plan()
    if plan is None or not plan.diverge_duals_due(round_idx):
        return None
    bad = corrupt_array(np.array(price, np.float64, copy=True),
                        f"diverge_duals|{round_idx}",
                        plan.diverge_duals_scale)
    return np.maximum(bad, 0.0)


def maybe_bad_sample(sample_idx, frame) -> bool:
    """``bad_sample`` injection point inside the Monte-Carlo sampler:
    when sample ``sample_idx`` is targeted, NaN-poison the head of its
    freshly sampled time-series frame (in place) — corrupted upstream
    data for exactly one sample of the batch.  The pre-dispatch input
    guards must quarantine that sample (its ``mc.sNNNNN`` case id names
    it in the diagnostic) while every other sample completes."""
    plan = get_plan()
    if plan is None or not plan.bad_sample_due(sample_idx):
        return False
    n = max(1, len(frame) // 16)
    frame.iloc[:n, 0] = np.nan
    return True


def maybe_preempt(batches_done: int) -> bool:
    """``preempt`` injection point at a window-batch boundary: when due,
    self-deliver SIGTERM — the exact signal a preemptible-VM reclaim
    sends — so the supervisor's graceful-shutdown path is exercised
    end-to-end (stop flag -> checkpoint flush -> manifest -> distinct
    exit code)."""
    plan = get_plan()
    if plan is None or not plan.preempt_due(batches_done):
        return False
    os.kill(os.getpid(), signal.SIGTERM)
    return True
