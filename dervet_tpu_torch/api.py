"""Top-level API: the DERVET class and case pipeline.

Re-designs dervet/DERVET.py:50-90 (reference: builds Params cases + Result
registry, runs every case through the 5-step scenario pipeline, times the
run).  ``DERVET(path).solve()`` returns the Results registry.  The
'torch' backend solves on the GPU unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

from .io.params import CaseParams, Params
from .scenario.scenario import MicrogridScenario
from .telemetry import trace as telemetry_trace
from .utils.errors import TellUser


class DERVET:
    """One model-parameters file -> N sensitivity cases -> results."""

    def __init__(self, model_parameters_path, verbose: bool = False,
                 base_path=None):
        self.start_time = time.time()
        self.init_seconds = 0.0
        self.verbose = verbose
        self.cases: Dict[int, CaseParams] = Params.initialize(
            model_parameters_path, base_path=base_path, verbose=verbose)
        # Results.errors_log_path routes the run log to a file (reference:
        # the ErrorHandling log file configured from the Results tag)
        paths = {str(c.results.get("errors_log_path") or "").strip()
                 for c in self.cases.values()}
        if len(paths) > 1:
            # a sensitivity sweep over errors_log_path: one run log file is
            # kept (first case's) — all cases' lines interleave into it
            TellUser.warning(
                f"cases disagree on errors_log_path ({sorted(paths)}); "
                "using the first case's value for the single run log")
        log_dir = str(self.cases[min(self.cases)].results.get(
            "errors_log_path") or "").strip()
        if log_dir and log_dir not in (".", "nan"):
            if " " in log_dir and "/" not in log_dir and "\\" not in log_dir:
                # the canonical template ships placeholder prose here
                # ("Enter absolute path here (include the folder ...)") —
                # spaces without any path separator; real paths with
                # spaces carry separators and pass through
                TellUser.warning(f"errors_log_path {log_dir!r} does not "
                                 "look like a path — no error log written")
            else:
                import re
                from pathlib import PureWindowsPath
                if re.match(r"^[A-Za-z]:", log_dir) or \
                        log_dir.startswith("\\\\"):
                    # a Windows drive (absolute OR drive-relative) or UNC
                    # path cannot be honored on POSIX — refusing beats
                    # mkdir'ing a literal 'C:'/'\\\\server'-named dir
                    TellUser.warning(f"errors_log_path {log_dir!r} is a "
                                     "Windows drive/UNC path — no error "
                                     "log written on this platform")
                    target = None
                elif log_dir.startswith("/"):
                    target = Path(log_dir)     # POSIX absolute: as given
                else:
                    # reference inputs carry Windows-style RELATIVE paths
                    # ('.\\Results\\x\\'); normalize separators so the
                    # directory lands under ./Results, not a literal
                    # backslash-named dir
                    parts = [p for p in PureWindowsPath(log_dir).parts
                             if p not in (".", "\\", "/")]
                    target = Path(*parts) if parts else Path(log_dir)
                if target is not None:
                    try:
                        TellUser.attach_file(target, name="errors_log.log")
                    except OSError as e:
                        TellUser.warning(f"could not open errors_log_path "
                                         f"{log_dir!r}: {e}")
        TellUser.info(f"Initialized {len(self.cases)} case(s) from "
                      f"{model_parameters_path}")
        self.init_seconds = time.time() - self.start_time

    @classmethod
    def from_cases(cls, cases, verbose: bool = False) -> "DERVET":
        """Build a DERVET around already-constructed :class:`CaseParams`
        (a dict keyed by case id, or an iterable) — the file-free entry
        the scenario service and benchmarks use, bypassing only the
        params parsing, never the solve pipeline."""
        self = cls.__new__(cls)
        self.start_time = time.time()
        self.init_seconds = 0.0
        self.verbose = verbose
        self.cases = (dict(cases) if isinstance(cases, dict)
                      else dict(enumerate(cases)))
        if not self.cases:
            raise ValueError("from_cases needs at least one case")
        return self

    # "auto" backend routing: below this many windows x cases the card's
    # near-fixed cost of a solve (its check windows, ~1 s for one monthly
    # case) loses to exact HiGHS at ~35 ms a monthly window, so small runs
    # ride HiGHS.  Measured with ``python -m dervet_tpu_torch.crossover``
    # on one H100 (700 W): HiGHS faster up to 48 windows, the card from
    # 96 on.  Explicit backend="torch"/"cpu" is always honored.
    AUTO_TORCH_MIN_WINDOWS = 96

    # Result.phase_seconds keys that are plain sums over the phases of
    # one call (prep_s adds init_seconds to its sum)
    PHASE_KEYS = ("dispatch_s", "post_s", "dispatch_assembly_s",
                  "dispatch_solve_s", "dispatch_stage_s", "certify_s",
                  "escalate_s", "solver_setup_s", "outage_walk_s",
                  "post_work_s")

    def solve(self, backend: str = "auto", solver_opts=None,
              checkpoint_dir=None, request_id=None, device=None):
        """Solve every case; returns the :class:`Result` registry.

        The call is one ``valuation`` phase tree (``telemetry.trace``):
        ``results.phase_seconds`` holds its per-phase sums, and
        ``results.trace`` its spans when telemetry records (write them
        with ``telemetry.trace.export_chrome_trace(results.trace, path)``).
        """
        with telemetry_trace.phase("valuation", root=True,
                                   cases=len(self.cases)) as run:
            results = self._solve(run, backend, solver_opts,
                                  checkpoint_dir, request_id, device)
        results.trace = run.trace
        sums = run.totals
        # params load (init) + this call's case prep; the rest as summed
        # over the call's phases, cumulative across threads
        results.phase_seconds = {
            "prep_s": round(self.init_seconds + sums.get("prep_s", 0.0), 3),
            **{k: round(sums.get(k, 0.0), 3) for k in self.PHASE_KEYS}}
        TellUser.info(f"DERVET runtime: "
                      f"{self.init_seconds + run.elapsed:.2f} s")
        return results

    def _solve(self, run, backend, solver_opts, checkpoint_dir, request_id,
               device):
        from .results.result import Result
        if self.verbose:
            from .io.summary import class_summary
            class_summary(self.cases)
        results = Result.initialize(self.cases)
        # request-scoped runs (the serving layer, or any caller running
        # concurrent solves into one output dir) namespace their run
        # artifacts; None keeps today's single-run filenames
        results.request_id = request_id
        # all cases dispatch through ONE driver call: windows with identical
        # constraint structure batch across the sensitivity-case axis into
        # single device calls (replaces the reference's serial per-case
        # loop, dervet/DERVET.py:75-83)
        from .scenario.scenario import run_dispatch
        with telemetry_trace.phase("prep", "prep_s", cases=len(self.cases)):
            scenarios = {}
            for key, case in self.cases.items():
                TellUser.info(f"Preparing case {key}...")
                scenarios[key] = MicrogridScenario(case)
            if backend == "auto":
                total = sum(len(s.windows) for s in scenarios.values())
                backend = ("torch" if total >= self.AUTO_TORCH_MIN_WINDOWS
                           else "cpu")
                TellUser.info(
                    f"backend=auto: {total} window-LPs across "
                    f"{len(scenarios)} case(s) -> {backend!r} "
                    f"(threshold {self.AUTO_TORCH_MIN_WINDOWS}; pass "
                    "backend='torch'/'cpu' to force)")
        run.set_attr("backend", backend)
        # preemption-safe sweep (utils.supervisor): SIGTERM/SIGINT sets a
        # stop flag honored at window-batch boundaries — checkpoints and
        # the sweep-level run_manifest.json flush before PreemptedError
        # propagates to the caller (the CLI maps it to EXIT_PREEMPTED).
        # A prior manifest in checkpoint_dir lets fully-done cases skip
        # dispatch entirely; the supervisor's watchdog
        # (DERVET_TPU_SOLVE_DEADLINE_S) bounds each device solve.
        #
        # Per-case pandas post-processing is embarrassingly parallel and
        # was the second-largest product-path phase (11.4 s of the r5
        # 37.6 s warm leg): the on_case_solved hook fires the moment a
        # case's LAST window solves, scatters its solution (cheap, on
        # the dispatch thread) and hands the frame building to a worker
        # pool — so post OVERLAPS the remaining in-flight device solves
        # instead of serializing after them.  DERVET_TPU_PIPELINE=0
        # restores the strict serial path (used by the byte-identical
        # pipeline tests).
        import concurrent.futures as cf
        import os
        from .scenario.scenario import _pipeline_enabled
        from .utils.supervisor import RunSupervisor
        post_futs: Dict[int, cf.Future] = {}
        key_of = {id(s): key for key, s in scenarios.items()}
        post_pool = None
        if _pipeline_enabled():
            post_pool = cf.ThreadPoolExecutor(
                max_workers=min(4, os.cpu_count() or 1),
                thread_name_prefix="dervet-post")

        def on_case_solved(scenario):
            scenario._scatter_to_ders(scenario._solution)
            scenario._scattered = True
            # the post pool's threads have no ambient phase: the case's
            # post parents under the run's root
            post_futs[key_of[id(scenario)]] = post_pool.submit(
                results.build_instance, scenario, run)

        try:
            with RunSupervisor() as sup:
                run_dispatch(list(scenarios.values()), backend=backend,
                             solver_opts=solver_opts,
                             checkpoint_dir=checkpoint_dir, supervisor=sup,
                             on_case_solved=(on_case_solved
                                             if post_pool is not None
                                             else None),
                             device=device)
        except BaseException:
            if post_pool is not None:
                post_pool.shutdown(wait=True, cancel_futures=True)
            raise
        TellUser.debug(f"dispatch ({len(scenarios)} case(s)): "
                       f"{run.totals.get('dispatch_s', 0.0):.2f}s")
        with telemetry_trace.phase("post", "post_s"):
            self._post(run, results, scenarios, post_futs, post_pool)
        return results

    def _post(self, run, results, scenarios, post_futs, post_pool) -> None:
        """Everything after the dispatch: the run-health report, the
        cases' results (those the dispatch did not hand to the post pool
        already), the invariant audit, the sensitivity summary and the
        solve ledger."""
        # run-health report (resilience layer): per-window ladder counts
        # aggregated over the sweep, logged AND attached to the results so
        # save_as_csv persists it next to the output set.  Quarantined
        # cases are excluded from result collection — their partial
        # dispatch is not a valid result — but stay visible here.
        from .io.summary import log_health_report, run_health_report
        report = run_health_report(
            {key: getattr(s, "health", {}) for key, s in scenarios.items()},
            {key: s.quarantine for key, s in scenarios.items()
             if s.quarantine is not None},
            certification_by_case={
                key: getattr(s, "certification", None)
                for key, s in scenarios.items()})
        results.run_health = report
        log_health_report(report)
        # cases the hook never saw (degradation-coupled, manifest-resumed,
        # cpu-path tails) fan out over the same pool; registration happens
        # HERE, on this thread, in the cases' original order — so the
        # result surface is identical whether or not post overlapped
        for key, scenario in scenarios.items():
            if scenario.quarantine is None and key not in post_futs \
                    and post_pool is not None:
                post_futs[key] = post_pool.submit(results.build_instance,
                                                  scenario, run)
        try:
            for key, scenario in scenarios.items():
                if scenario.quarantine is not None:
                    TellUser.error(
                        f"case {key} excluded from results (quarantined): "
                        f"{scenario.quarantine['reason']}")
                    continue
                if key in post_futs:
                    results.instances[key] = post_futs[key].result()
                else:
                    results.add_instance(key, scenario)
        finally:
            if post_pool is not None:
                post_pool.shutdown(wait=True)
        # physical-invariant audit (numerical trust layer): every
        # collected case's assembled results re-checked against the SOE
        # recurrence / seam pins / rating bounds / POI balance /
        # objective-component reconciliation (ops/certify.audit_case,
        # run inside collect_results) — aggregated into run_health so the
        # persisted report carries the verdict
        from .ops.certify import aggregate_audits
        audit = aggregate_audits(
            {key: getattr(inst, "invariant_audit", None)
             for key, inst in results.instances.items()})
        report["invariant_audit"] = audit
        if not audit["ok"]:
            TellUser.warning(
                "invariant audit FAILED for case(s) "
                f"{sorted(audit['failing'])} — see run_health.json "
                "invariant_audit for the violated checks")
        results.sensitivity_summary()
        if scenarios:
            # the per-group solve ledger (VERDICT r5 #1): the solve
            # phase decomposed into named device-traffic line items,
            # published by bench.py under legs.*.solve_ledger
            s0 = next(iter(scenarios.values()))
            results.solve_ledger = s0.solve_metadata.get("solve_ledger")
            if isinstance(results.solve_ledger, dict):
                # provenance stamp, mirrored in run_health: the
                # request-cache key (service/reqcache.py) folds this in
                # so a solver upgrade invalidates memoized answers
                from .ops.pdhg import SOLVER_VERSION
                results.solve_ledger.setdefault("solver_version",
                                                str(SOLVER_VERSION))
                # the dispatch pipeline's in-flight groups and streams
                from .scenario.scenario import PIPELINE_KEYS
                report["pipeline"] = {k: results.solve_ledger.get(k)
                                      for k in PIPELINE_KEYS}
