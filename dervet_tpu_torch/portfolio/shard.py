"""Fleet-sharded portfolio dual rounds.

The dual loop runs one outer round as ONE ``run_dispatch`` over every
member site's window LPs.  That is the right shape for a handful of
sites, but a 10^4-10^6 site axis needs one round's member batch to
spread — across concurrent in-process dispatches AND across fleet
replicas (DuaLip-GPU, arxiv 2603.04621, scales exactly this
dual-decomposition shape across accelerators).  This module is that
spread:

* :func:`plan_shards` — a STRUCTURE-AWARE shard planner: sites that
  share an LP structure fingerprint stay together (their windows
  co-batch into one device solve; splitting them trades batch
  occupancy for nothing), large structure groups split into contiguous
  chunks, and chunks pack LPT onto shards by window count.  The plan is
  computed once per portfolio solve and FIXED across rounds — shard
  composition is part of the determinism contract (per-site columns and
  costs are identical to the single-host path for a fixed plan).

* :class:`MonolithicExecutor` / :class:`LocalShardExecutor` /
  :class:`FleetShardExecutor` — one interface (``dispatch_round``) over
  the three ways a round's member batch can run: today's one-dispatch
  path bit for bit, N concurrent in-process dispatches (each shard keeps
  its OWN long-lived ``SolverCache`` so ``dual_iterate`` hint warmth and
  solver affinity survive round over round), and N fleet
  requests through :meth:`~dervet_tpu_torch.service.router.FleetRouter.
  submit_shards` (shard payloads ride the existing ``ReplicaHandle``
  transport with the dual-price vector; results merge into one column
  set; a dead replica's shard re-routes via the router's exactly-once
  machinery; replica→shard assignment is sticky across rounds so the
  target replica's hint table and cached solvers stay warm).

* :func:`solve_portfolio_shard` / :class:`PortfolioShardRound` — the
  REPLICA side: one shard request is one ``run_dispatch`` over its
  sites' window LPs at the carried dual prices, against the replica
  service's persistent solver cache (which is exactly why stickiness
  pays), answered as a :class:`PortfolioShardResult` (per-site true
  cost, shifted cost, activity, solution arrays, certificates).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import pickle
import time
from typing import Dict, List, Optional

import numpy as np

from ..telemetry import trace as telemetry_trace
from ..utils.errors import (DeadlineExpiredError, RequestFailedError,
                            TellUser)

SHARD_RESULT_FILE = "shard_result.pkl"

# rid suffix for the one-shot full-payload resend after a replica-side
# shard-case-cache miss (rids are once-only across the fleet)
RESEED_RID_SUFFIX = ".f"


def _is_shard_cache_miss(e: BaseException) -> bool:
    """A replica answered (or rejected at admission) with the typed
    shard-case-cache miss — synchronously as
    :class:`~dervet_tpu_torch.utils.errors.ShardCacheMissError` on the local
    transport, or as a
    :class:`~dervet_tpu_torch.utils.errors.ReplicaAnswerError` whose payload
    carries the ``shard_cache_miss`` kind after the spool hop."""
    from ..utils.errors import ReplicaAnswerError, ShardCacheMissError
    if isinstance(e, ShardCacheMissError):
        return True
    return (isinstance(e, ReplicaAnswerError)
            and (e.payload or {}).get("kind") == "shard_cache_miss")


# ---------------------------------------------------------------------------
# Per-site round outcome (what the dual loop needs from one dispatch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SiteOutcome:
    """One site's contribution to one dual round, transport-neutral:
    everything the outer loop reads off a dispatched
    ``PortfolioSiteScenario`` — and nothing else, so a shard solved on a
    fleet replica merges indistinguishably from a local one."""

    phi: float                       # true cost c_base @ x (float64)
    shifted: float                   # (c_base + dc) @ x — the dual bound's raw material
    activity: np.ndarray             # full-horizon aggregate variable activity
    solution: Dict[str, np.ndarray]  # full solution arrays (final blend)
    windows: int
    certification: Optional[Dict] = None
    health: Optional[Dict] = None
    quarantine: Optional[Dict] = None


def site_outcome(s) -> SiteOutcome:
    """Extract one dispatched site scenario's round outcome."""
    return SiteOutcome(
        phi=s.true_cost_cx(),
        shifted=s.shifted_cost_cx(),
        activity=s.activity_series(),
        solution={n: np.array(a) for n, a in s._solution.items()},
        windows=len(s.windows),
        certification=getattr(s, "certification", None),
        health=dict(getattr(s, "health", None) or {}),
        quarantine=s.quarantine)


@dataclasses.dataclass
class RoundData:
    """One dual round's merged dispatch output."""

    outcomes: Dict[str, SiteOutcome]
    summary: Dict                    # merged ledger digest (round record)
    ledger: Optional[Dict]           # one representative full solve ledger
    shard_records: List[Dict]        # per-shard observability records


def round_summary(scen_list) -> Dict:
    """The round-record digest of one dispatched scenario set (the
    fields ``solve_portfolio`` publishes per round)."""
    ledger = scen_list[0].solve_metadata.get("solve_ledger") or {}
    led_tot = ledger.get("totals") or {}
    warm = ledger.get("warm_start") or {}
    return {
        "iters_p50": (ledger.get("iters") or {}).get("p50"),
        "iters_p50_seeded": warm.get("iters_p50_seeded"),
        "iters_p50_cold": warm.get("iters_p50_cold"),
        "seeded": int(warm.get("seeded", 0)),
        "dual_iterate": int(warm.get("dual_iterate", 0)),
        "substituted": int(warm.get("substituted", 0)),
        "compile_events": int(led_tot.get("compile_events", 0)),
        "windows": int(led_tot.get("windows", 0)),
    }


def merge_summaries(parts: List[Dict]) -> Dict:
    """Merge per-shard round digests into one: counters sum; the
    iteration p50 is the windows-weighted median of the shard medians
    (exact enough for the round record — the full distribution lives in
    each shard's ledger)."""
    if len(parts) == 1:
        return dict(parts[0])
    out = {k: 0 for k in ("seeded", "dual_iterate", "substituted",
                          "compile_events", "windows")}
    p50s: List[float] = []
    weights: List[int] = []
    seeded_p50s, cold_p50s = [], []
    for p in parts:
        for k in out:
            out[k] += int(p.get(k, 0))
        if p.get("iters_p50") is not None:
            p50s.append(float(p["iters_p50"]))
            weights.append(max(1, int(p.get("windows", 1))))
        if p.get("iters_p50_seeded") is not None:
            seeded_p50s.append(float(p["iters_p50_seeded"]))
        if p.get("iters_p50_cold") is not None:
            cold_p50s.append(float(p["iters_p50_cold"]))

    def wmedian(vals, ws):
        if not vals:
            return None
        order = np.argsort(vals)
        vals = np.asarray(vals, float)[order]
        ws = np.asarray(ws, float)[order]
        cum = np.cumsum(ws)
        return float(vals[int(np.searchsorted(cum, 0.5 * cum[-1]))])

    out["iters_p50"] = wmedian(p50s, weights)
    out["iters_p50_seeded"] = (float(np.median(seeded_p50s))
                               if seeded_p50s else None)
    out["iters_p50_cold"] = (float(np.median(cold_p50s))
                             if cold_p50s else None)
    return out


# ---------------------------------------------------------------------------
# The shard planner
# ---------------------------------------------------------------------------

def plan_shards(scens: Dict[str, object], n_shards: int,
                fingerprints: Optional[Dict[str, str]] = None
                ) -> List[List[str]]:
    """Partition member sites into ``n_shards`` structure-aware shards.

    Sites sharing an LP structure fingerprint stay together
    (their windows co-batch into one device program); a structure group
    whose window count exceeds the per-shard target splits into
    contiguous chunks; chunks then pack LPT (largest first onto the
    least-loaded shard) by window count.  Deterministic: keys sort,
    groups sort by (-cost, fingerprint), ties break by shard index —
    the FIXED plan is part of the parity contract.  Empty shards are
    dropped (fewer sites than shards)."""
    n_shards = max(1, min(int(n_shards), len(scens)))
    if n_shards == 1:
        return [sorted(scens, key=str)]
    if fingerprints is None:
        from ..service.fleet import structure_fingerprint
        fingerprints = {}
        for key in sorted(scens, key=str):
            case = getattr(scens[key], "case", None)
            fingerprints[key] = (structure_fingerprint({key: case})
                                 if case is not None else "?")
    cost = {key: max(1, len(getattr(scens[key], "windows", ())) or 1)
            for key in scens}
    groups: Dict[str, List[str]] = {}
    for key in sorted(scens, key=str):
        groups.setdefault(fingerprints[key], []).append(key)
    total = sum(cost.values())
    target = max(1, math.ceil(total / n_shards))
    chunks: List[List[str]] = []
    for fp in sorted(groups, key=lambda f: (-sum(cost[k] for k in groups[f]),
                                            f)):
        keys = groups[fp]
        gcost = sum(cost[k] for k in keys)
        n_chunks = max(1, math.ceil(gcost / target))
        size = math.ceil(len(keys) / n_chunks)
        for i in range(0, len(keys), size):
            chunks.append(keys[i:i + size])
    chunks.sort(key=lambda c: (-sum(cost[k] for k in c), c[0]))
    shards: List[List[str]] = [[] for _ in range(n_shards)]
    loads = [0] * n_shards
    for chunk in chunks:
        j = min(range(n_shards), key=lambda i: (loads[i], i))
        shards[j].extend(chunk)
        loads[j] += sum(cost[k] for k in chunk)
    return [sorted(s, key=str) for s in shards if s]


# ---------------------------------------------------------------------------
# Executors: one interface over monolithic / local-sharded / fleet rounds
# ---------------------------------------------------------------------------

class MonolithicExecutor:
    """Today's path, bit for bit: one ``run_dispatch`` over every member
    site (the shard plan is one all-sites shard)."""

    kind = "monolithic"

    def __init__(self, scens: Dict[str, object], *, backend: str,
                 solver_opts=None, solver_cache=None, supervisor=None,
                 breaker_board=None, cert_ctx=None, device=None):
        import contextlib
        self.scens = scens
        self.scen_list = list(scens.values())
        self.backend = backend
        self.device = device
        self.solver_opts = solver_opts
        self.solver_cache = solver_cache
        self.supervisor = supervisor
        self.breaker_board = breaker_board
        self.cert_ctx = cert_ctx or contextlib.nullcontext

    def dispatch_round(self, price: np.ndarray, round_idx: int,
                       request_id=None) -> RoundData:
        from ..scenario.scenario import run_dispatch
        for s in self.scen_list:
            s.coupling_price = price
        t0 = time.monotonic()
        with self.cert_ctx():
            run_dispatch(self.scen_list, backend=self.backend,
                         solver_opts=self.solver_opts,
                         supervisor=self.supervisor,
                         solver_cache=self.solver_cache,
                         breaker_board=self.breaker_board,
                         device=self.device)
        wall = time.monotonic() - t0
        summary = round_summary(self.scen_list)
        return RoundData(
            outcomes={k: site_outcome(s) for k, s in self.scens.items()},
            summary=summary,
            ledger=self.scen_list[0].solve_metadata.get("solve_ledger"),
            shard_records=[{"shard": 0, "sites": len(self.scens),
                            "windows": summary["windows"],
                            "replica": None,
                            "wall_s": round(wall, 3)}])


class LocalShardExecutor:
    """In-process sharding: each shard's sites run their own concurrent
    ``run_dispatch`` on the one device, against a PER-SHARD long-lived
    ``SolverCache`` created once and reused every round — solvers and
    ``dual_iterate`` hint warmth are shard-sticky exactly like a fleet
    replica's.

    Thread model: the shard workers launch the chunk kernels from
    concurrent threads onto one device; the launch glue sets each
    kernel instance's attributes once per process, so concurrent
    launches at different shapes are safe."""

    kind = "local"

    def __init__(self, scens: Dict[str, object], plan: List[List[str]],
                 *, backend: str, solver_opts=None, supervisor=None,
                 breaker_board=None, cert_ctx=None, memory=None,
                 device=None):
        import contextlib

        from ..scenario.scenario import SolverCache
        self.scens = scens
        self.plan = plan
        self.backend = backend
        self.solver_opts = solver_opts
        self.supervisor = supervisor
        self.breaker_board = breaker_board
        self.cert_ctx = cert_ctx or contextlib.nullcontext
        # per-shard solver caches, but ONE SolutionMemory:
        # ``memory`` (the caller's long-lived cache's) keeps
        # dual_iterate hints + exact entries visible across shards,
        # across requests, and to the fleet memory-handoff export —
        # a service solving repeated sharded portfolios stays warm
        self.caches = [SolverCache(pad_grid=(backend != "cpu"),
                                   warm_start=True, memory=memory,
                                   device=device)
                       for _ in plan]

    def _run_shard(self, idx: int, price: np.ndarray) -> Dict:
        from ..scenario.scenario import run_dispatch
        shard_scens = [self.scens[k] for k in self.plan[idx]]
        for s in shard_scens:
            s.coupling_price = price
        t0 = time.monotonic()
        # the certification policy override is THREAD-LOCAL:
        # each shard worker enters the degraded context itself
        with self.cert_ctx():
            run_dispatch(shard_scens, backend=self.backend,
                         solver_opts=self.solver_opts,
                         supervisor=self.supervisor,
                         solver_cache=self.caches[idx],
                         breaker_board=self.breaker_board)
        return {"summary": round_summary(shard_scens),
                "ledger": shard_scens[0].solve_metadata.get(
                    "solve_ledger"),
                "wall_s": time.monotonic() - t0}

    def dispatch_round(self, price: np.ndarray, round_idx: int,
                       request_id=None) -> RoundData:
        from concurrent.futures import ThreadPoolExecutor
        spans = [telemetry_trace.start_span(
            "portfolio_shard", rid=request_id,
            attrs={"shard": i, "round": round_idx, "transport": "local",
                   "sites": len(self.plan[i])})
            for i in range(len(self.plan))]
        try:
            with ThreadPoolExecutor(max_workers=len(self.plan),
                                    thread_name_prefix="pf-shard") as ex:
                futs = [ex.submit(self._run_shard, i, price)
                        for i in range(len(self.plan))]
                parts = [f.result() for f in futs]
        except BaseException as e:
            for sp in spans:
                sp.end(error=e)
            raise
        records = []
        for i, part in enumerate(parts):
            records.append({"shard": i, "sites": len(self.plan[i]),
                            "windows": part["summary"]["windows"],
                            "replica": None,
                            "wall_s": round(part["wall_s"], 3)})
            spans[i].set_attrs({"windows": part["summary"]["windows"],
                                "wall_s": round(part["wall_s"], 3)})
            spans[i].end()
        return RoundData(
            outcomes={k: site_outcome(self.scens[k]) for k in self.scens},
            summary=merge_summaries([p["summary"] for p in parts]),
            ledger=parts[0]["ledger"],
            shard_records=records)


class FleetShardExecutor:
    """Fleet sharding: each shard rides the existing ``ReplicaHandle``
    transport as one ``portfolio_shard`` request per round (pickled site
    cases + the dual-price vector), solved by the target replica's
    persistent service and answered as a :class:`PortfolioShardResult`.
    Shard→replica assignment is sticky across rounds (the router's
    per-shard affinity key), a dead replica's shard re-routes through
    the router's exactly-once failover, and results merge into one column
    set indistinguishable from the local executors'."""

    kind = "fleet"

    def __init__(self, members: Dict[str, object], plan: List[List[str]],
                 fleet, *, backend: str, solver_opts=None,
                 portfolio_id: str = "pf", deadline_s: float = 3600.0):
        self.members = members
        self.plan = plan
        self.fleet = fleet
        self.backend = backend
        self.solver_opts = solver_opts
        self.portfolio_id = str(portfolio_id)
        self.deadline_s = float(deadline_s)
        # shard i's sites never change (fixed plan): the full site
        # payload ships ONCE (round 0, plus a one-shot reseed after a
        # replica-side cache miss); every later round is a REFERENCE
        # payload — dual-price vector + plan fingerprint — resolved
        # against the target replica's bounded shard-case cache
        # (ScenarioService._resolve_shard_cases)
        self.site_payloads = [{k: members[k] for k in shard}
                              for shard in plan]
        # plan_fp: a CONTENT fingerprint of the shard's site set — the
        # replica cache key is (seed_tag, plan_fp), so a same-named
        # portfolio with edited cases can never resolve a stale site
        # set.  A case that defeats content digesting disables ref mode
        # for its shard (every round ships full — correct, just slower).
        self.plan_fps: List[Optional[str]] = []
        self.site_bytes: List[int] = []
        for shard in plan:
            try:
                from ..service import reqcache
                h = hashlib.sha256()
                for k in shard:
                    h.update(str(k).encode())
                    h.update(reqcache.case_content_digest(
                        members[k]).encode())
                self.plan_fps.append(h.hexdigest())
            except Exception:
                self.plan_fps.append(None)
        for sp in self.site_payloads:
            try:
                self.site_bytes.append(len(pickle.dumps(
                    sp, protocol=pickle.HIGHEST_PROTOCOL)))
            except Exception:
                self.site_bytes.append(0)
        self._seeded = [False] * len(plan)
        self.assignments: List[Dict[int, str]] = []   # per round
        self.wire_bytes_rounds: List[int] = []        # per round total

    def _shard_payload(self, i: int, price: np.ndarray, round_idx: int,
                       *, full: bool) -> Dict:
        payload = {
            "price": np.asarray(price, np.float64),
            "seed_tag": f"{self.portfolio_id}.s{i:02d}",
            "shard": i,
            "round": int(round_idx),
            "backend": self.backend,
            "solver_opts": self.solver_opts,
        }
        if self.plan_fps[i] is not None:
            payload["plan_fp"] = self.plan_fps[i]
        if full or self.plan_fps[i] is None:
            payload["sites"] = self.site_payloads[i]
        return payload

    def _payload_bytes(self, i: int, payload: Dict) -> int:
        """Approximate bytes-on-wire for one shard dispatch: the
        non-site fields pickle cheaply every time; the site set's size
        was measured once at init (re-pickling it per round to measure
        it would spend exactly what ref mode saves)."""
        try:
            base = len(pickle.dumps(
                {k: v for k, v in payload.items() if k != "sites"},
                protocol=pickle.HIGHEST_PROTOCOL))
        except Exception:
            base = 0
        return base + (self.site_bytes[i] if "sites" in payload else 0)

    def _submit_one(self, i: int, payloads: List[Dict],
                    nbytes: List[int], price: np.ndarray,
                    round_idx: int):
        """Admit shard ``i``; a synchronous cache miss (local
        transport rejects the reference at admission) re-seeds with the
        full payload once, under a fresh rid."""
        try:
            return self.fleet.submit_shards(
                [payloads[i]], portfolio_id=self.portfolio_id,
                round_idx=round_idx, deadline_s=self.deadline_s)[i]
        except Exception as e:
            if not (_is_shard_cache_miss(e)
                    and "sites" not in payloads[i]):
                raise
            TellUser.info(
                f"portfolio shard {i} round {round_idx}: replica shard "
                "cache cold — re-sending the full site payload")
        payloads[i] = self._shard_payload(i, price, round_idx, full=True)
        nbytes[i] += self._payload_bytes(i, payloads[i])
        return self.fleet.submit_shards(
            [payloads[i]], portfolio_id=self.portfolio_id,
            round_idx=round_idx, deadline_s=self.deadline_s,
            rid_suffix=RESEED_RID_SUFFIX)[i]

    def dispatch_round(self, price: np.ndarray, round_idx: int,
                       request_id=None) -> RoundData:
        n = len(self.plan)
        payloads = [self._shard_payload(
            i, price, round_idx,
            full=not self._seeded[i]) for i in range(n)]
        nbytes = [self._payload_bytes(i, p)
                  for i, p in enumerate(payloads)]
        spans = [telemetry_trace.start_span(
            "portfolio_shard", rid=request_id,
            attrs={"shard": i, "round": round_idx, "transport": "fleet",
                   "sites": len(self.plan[i]),
                   "ref_mode": "sites" not in payloads[i]})
            for i in range(n)]
        futs: Dict[int, object] = {}
        try:
            for i in range(n):
                futs[i] = self._submit_one(i, payloads, nbytes, price,
                                           round_idx)
        except BaseException as e:
            for sp in spans:
                sp.end(error=e)
            raise
        results: Dict[int, "PortfolioShardResult"] = {}
        assignment: Dict[int, str] = {}
        deadline = time.monotonic() + self.deadline_s
        err: Optional[BaseException] = None
        for i, fut in futs.items():
            try:
                routed = fut.result(
                    timeout=max(0.1, deadline - time.monotonic()))
            except Exception as e:
                if _is_shard_cache_miss(e) and "sites" not in payloads[i]:
                    # the reference landed on a COLD replica (failover
                    # moved the shard / eviction / restart): one-shot
                    # full resend under a fresh rid re-seeds its cache
                    spans[i].event("shard_cache_miss")
                    TellUser.info(
                        f"portfolio shard {i} round {round_idx}: "
                        "replica shard cache cold — re-sending the "
                        "full site payload")
                    payloads[i] = self._shard_payload(
                        i, price, round_idx, full=True)
                    nbytes[i] += self._payload_bytes(i, payloads[i])
                    try:
                        routed = self.fleet.submit_shards(
                            [payloads[i]],
                            portfolio_id=self.portfolio_id,
                            round_idx=round_idx,
                            deadline_s=max(
                                0.1, deadline - time.monotonic()),
                            rid_suffix=RESEED_RID_SUFFIX)[i].result(
                            timeout=max(
                                0.1, deadline - time.monotonic()))
                    except Exception as e2:
                        err = err or RequestFailedError({
                            f"shard{i}": "portfolio shard round "
                            f"{round_idx} failed after a full-payload "
                            f"reseed: {type(e2).__name__}: {e2}"})
                        spans[i].end(error=e2)
                        continue
                else:
                    err = err or RequestFailedError({
                        f"shard{i}": f"portfolio shard round {round_idx} "
                                     f"failed on the fleet: "
                                     f"{type(e).__name__}: {e}"})
                    spans[i].end(error=e)
                    continue
            res = routed.result
            if res is None and routed.results_dir is not None:
                res = load_shard_result(routed.results_dir)
            if res is None:
                err = err or RequestFailedError({
                    f"shard{i}": "portfolio shard answered without a "
                                 f"readable {SHARD_RESULT_FILE}"})
                spans[i].end(error="missing shard result")
                continue
            if "sites" in payloads[i] and self.plan_fps[i] is not None:
                self._seeded[i] = True
            results[i] = res
            assignment[i] = routed.replica
            spans[i].set_attrs({
                "replica": routed.replica,
                "windows": res.summary.get("windows"),
                "recovered": bool(routed.recovered),
                "payload_bytes": nbytes[i],
                "wall_s": routed.latency_s})
            spans[i].end()
        if err is not None:
            raise err
        self.assignments.append(assignment)
        self.wire_bytes_rounds.append(int(sum(nbytes)))
        outcomes: Dict[str, SiteOutcome] = {}
        for res in results.values():
            outcomes.update(res.outcomes)
        records = [{"shard": i, "sites": len(self.plan[i]),
                    "windows": results[i].summary.get("windows"),
                    "replica": assignment[i],
                    "payload_bytes": nbytes[i],
                    "ref_mode": "sites" not in payloads[i],
                    "wall_s": (round(float(futs_latency), 3)
                               if (futs_latency := results[i].wall_s)
                               is not None else None)}
                   for i in sorted(results)]
        return RoundData(
            outcomes=outcomes,
            summary=merge_summaries(
                [results[i].summary for i in sorted(results)]),
            ledger=results[min(results)].ledger,
            shard_records=records)


# ---------------------------------------------------------------------------
# Replica side: one shard request = one dispatch at the carried prices
# ---------------------------------------------------------------------------

class PortfolioShardResult:
    """One shard's answer: per-site round outcomes + the shard's ledger
    digest.  Carries the spool results contract (``save_as_csv`` +
    ``fidelity``) so the serve loop's delivery path needs no special
    casing — the artifact is a pickle (same trust domain as the request
    payload) plus a small JSON summary for humans."""

    def __init__(self, shard_idx: int, round_idx: int,
                 outcomes: Dict[str, SiteOutcome], summary: Dict,
                 ledger: Optional[Dict], wall_s: Optional[float] = None):
        self.shard_idx = int(shard_idx)
        self.round_idx = int(round_idx)
        self.outcomes = outcomes
        self.summary = summary
        self.ledger = ledger
        self.wall_s = wall_s
        self.fidelity = "certified"
        self.resubmit_hint: Optional[str] = None
        self.request_id: Optional[str] = None

    def save_as_csv(self, out_dir) -> None:
        import json
        from pathlib import Path

        from ..utils.supervisor import atomic_write
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        # atomic_write fsyncs before the rename — a host crash must
        # never deliver a torn pickle through the spool (the executor
        # would fail the whole dual round on an unreadable answer)
        atomic_write(out / SHARD_RESULT_FILE,
                     pickle.dumps(self, protocol=pickle.HIGHEST_PROTOCOL))
        atomic_write(out / "shard_result.json", json.dumps({
            "shard": self.shard_idx, "round": self.round_idx,
            "sites": sorted(self.outcomes),
            "summary": self.summary,
            "wall_s": self.wall_s,
        }, indent=2, default=str))


def load_shard_result(results_dir) -> Optional[PortfolioShardResult]:
    from pathlib import Path
    path = Path(results_dir) / SHARD_RESULT_FILE
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except (OSError, pickle.UnpicklingError, EOFError):
        return None


def solve_portfolio_shard(payload: Dict, *, backend: Optional[str] = None,
                          solver_opts=None, solver_cache=None,
                          supervisor=None, breaker_board=None,
                          request_id=None,
                          device=None) -> PortfolioShardResult:
    """Solve one portfolio shard (replica side): build the shard's site
    scenarios, apply the carried dual-price vector, run ONE
    ``run_dispatch`` against the (persistent) ``solver_cache`` — the
    ``dual_iterate`` hint keys are ``(portfolio, seed_tag, site,
    window)``, stable across rounds, so the sticky replica reseeds round
    k+1 from its own round-k iterates exactly like the single-host
    loop.  ``device`` is the replica's (the cache's when one is given)."""
    import dataclasses as _dc

    from ..scenario.scenario import run_dispatch
    from .site import PortfolioSiteScenario
    sites = payload["sites"]
    price = np.asarray(payload["price"], np.float64)
    seed_tag = str(payload.get("seed_tag") or "pfshard")
    backend = backend or payload.get("backend") or "torch"
    opts = solver_opts if solver_opts is not None \
        else payload.get("solver_opts")
    scens: Dict[str, PortfolioSiteScenario] = {}
    for key in sorted(sites, key=str):
        case = sites[key]
        if request_id:
            case = _dc.replace(case, case_id=f"{request_id}.{key}")
        s = PortfolioSiteScenario(case, site_key=str(key),
                                  seed_tag=seed_tag)
        if request_id:
            s.request_id = str(request_id)
        s.coupling_price = price
        scens[str(key)] = s
    scen_list = list(scens.values())
    t0 = time.monotonic()
    run_dispatch(scen_list, backend=backend, solver_opts=opts,
                 supervisor=supervisor, solver_cache=solver_cache,
                 breaker_board=breaker_board, device=device)
    wall = time.monotonic() - t0
    res = PortfolioShardResult(
        shard_idx=int(payload.get("shard", 0)),
        round_idx=int(payload.get("round", 0)),
        outcomes={k: site_outcome(s) for k, s in scens.items()},
        summary=round_summary(scen_list),
        ledger=scen_list[0].solve_metadata.get("solve_ledger"),
        wall_s=round(wall, 3))
    res.request_id = request_id
    return res


class PortfolioShardRound:
    """The ``portfolio_shard`` phase of one replica batch cycle: solve
    each shard request against the service's persistent solver cache and
    answer its future.  Every failure mode answers the future HERE."""

    def __init__(self, requests: List, *, backend: str, solver_opts=None,
                 solver_cache=None, supervisor=None, board=None,
                 device=None):
        self.requests = requests
        self.backend = backend
        self.device = device
        self.solver_opts = solver_opts
        self.solver_cache = solver_cache
        self.supervisor = supervisor
        self.board = board
        self.answered: List = []
        self.stats = {"shard_requests": 0, "shard_windows": 0,
                      "shard_failed": 0, "shard_s": 0.0}

    def run(self) -> None:
        from ..utils.errors import PreemptedError, RequestPreemptedError
        for i, req in enumerate(self.requests):
            if req.expired():
                req.future.set_exception(DeadlineExpiredError(
                    f"portfolio shard {req.request_id!r} expired before "
                    "its dispatch started"))
                self.answered.append(req)
                continue
            span = telemetry_trace.start_span(
                "portfolio_shard", rid=req.request_id,
                attrs={"backend": self.backend, "side": "replica",
                       "sites": len((req.shard_payload or {})
                                    .get("sites", ()))})
            t0 = time.monotonic()
            try:
                # the PAYLOAD's backend wins: the owner stamped its
                # portfolio certificate's inner_exact flag from the
                # backend IT requested — a torch replica quietly solving
                # a cpu-requested shard in f32 would falsify it
                res = solve_portfolio_shard(
                    req.shard_payload,
                    backend=(req.shard_payload or {}).get("backend")
                    or self.backend,
                    solver_opts=(req.shard_payload or {}).get(
                        "solver_opts") or self.solver_opts,
                    solver_cache=self.solver_cache,
                    supervisor=self.supervisor,
                    breaker_board=self.board,
                    request_id=req.request_id,
                    device=self.device)
            except PreemptedError as e:
                span.end(error=e)
                for later in self.requests[i:]:
                    if not later.future.done():
                        later.future.set_exception(RequestPreemptedError(
                            f"portfolio shard {later.request_id!r} "
                            f"preempted ({e}); the router re-routes it"))
                        self.answered.append(later)
                raise
            except Exception as e:
                self.stats["shard_failed"] += 1
                span.end(error=e)
                TellUser.error(f"portfolio shard {req.request_id}: "
                               f"{type(e).__name__}: {e}")
                req.future.set_exception(e)
                self.answered.append(req)
                continue
            self.stats["shard_requests"] += 1
            self.stats["shard_windows"] += int(
                res.summary.get("windows", 0))
            self.stats["shard_s"] += time.monotonic() - t0
            span.set_attrs({"windows": res.summary.get("windows"),
                            "round": res.round_idx,
                            "shard": res.shard_idx})
            span.end()
            req.future.set_result(res)
            self.answered.append(req)
