"""Warm-start solution memory: seed PDHG from nearby converged iterates.

BENCH_r05 puts the hot-path cost squarely on iteration count (iters p50
1664 / p99 2176 per window LP at 0.26% FLOPs utilization), and the
PDLP-family literature (PAPERS.md: MPAX, arxiv 2412.09734; PDHG-unrolled
L2O, arxiv 2406.01908) shows that seeding PDHG from a nearby converged
iterate cuts iteration counts 2-10x on structure-identical LP families —
exactly the serving workload, where ``SolverCache`` already fingerprints
structure-identical windows across requests.

This module is the memory half of that design: a bounded LRU
:class:`SolutionMemory` that a long-lived :class:`~dervet_tpu.scenario.
scenario.SolverCache` carries across dispatches, storing converged
UNSCALED ``(x, y)`` iterates per LP structure key.  Two lookup grades:

* **exact** — the member's ``(c, q, l, u)`` bytes AND solver-tolerance
  tag match a stored entry (a repeat request, a re-screened candidate at
  the same tier).  The stored solution is re-verified against the FULL
  convergence criteria — a float64 host replica of the solver's own KKT
  test, plus a bounds-box check the device never needs (its iterates are
  clipped by construction) — and, if it passes, shipped verbatim with
  zero device work and ``iters == 0``.  Because the stored vector is the
  byte-exact device output of the earlier solve, a warm repeat is
  BYTE-IDENTICAL to its cold counterpart across the whole results
  surface.  A stored solution that fails the check (stored at a looser
  tier, marginal convergence) falls through to iterate seeding.
* **near** — same structure, different data: the quantized-data digest
  (float16 cast of ``(c, q, l, u)`` — the "hash of quantized data"
  proximity key) finds numerically-near entries fast, and a small
  bucketed-mean feature vector picks the nearest entry by L2 distance
  otherwise.  The entry seeds the solver's iterates via
  ``init_state(..., x0=, y0=)`` — clipped into the scaled box, restart
  anchors reset — and the solve runs its normal convergence criteria
  from there.

A third, caller-keyed grade serves the portfolio dual loop
(``dervet_tpu_torch/portfolio``): a **dual_iterate** hint.  A dual-price
update perturbs EVERY price entry of a member's ``c`` at once, so the
float16 quantized digest moves in every price feature and the near
grade degrades to the feature-nearest fallback (or cold) exactly on the
workload it was built for.  Callers that KNOW two solves are successive
iterates of one outer loop attach ``lp.seed_hint = (tag, site,
window)``; the memory keeps a side table of the latest converged
iterate per hint key (:meth:`SolutionMemory.store_hint` /
:meth:`SolutionMemory.lookup_hint`), and :func:`plan_group` ranks a
hint hit ABOVE near/predicted (the member's own last iterate beats any
neighbor) but below exact substitution (byte-identical data still ships
verbatim with zero device work).  A hint seed is iterate seeding only —
the data differs by construction, so it can never substitute.

Safety argument: a warm-started window still runs full convergence
criteria and full PR-4 float64 certification, so a stale, evicted, or
poisoned seed can only cost iterations, never correctness — the
``stale_seed`` fault kind (utils/faultinject.py) drills exactly that.
``DERVET_TPU_WARMSTART=0`` kills the whole subsystem (cold path,
byte-identical to pre-warm-start behavior); ``DERVET_TPU_WARMSTART_CAP``
bounds the entry count (default 512).
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import seedpredict

WARMSTART_ENV = "DERVET_TPU_WARMSTART"
CAP_ENV = "DERVET_TPU_WARMSTART_CAP"
DEFAULT_CAP = 512
# feature vector: bucketed means per data vector — coarse but cheap, and
# only consulted when the quantized digest misses
FEATURE_BUCKETS = 8
# richer cold-start features (r15): the bucketed means saturate in the
# noise regime where the price LEVEL is stable but the hourly SHAPE
# moves (1%-per-hour noise: 1.4x vs the 2.2x resubmission-grade figure)
# — per-window price quantiles capture the shape's spread independent of
# hour alignment, and the SOE boundary state (the rhs of the soe
# recurrence/seam rows: entry SOE and final target) pins the feature the
# dispatch basis actually pivots on.  Both append to the same float16-
# quantized digest the predictor trains on.
PRICE_QUANTILES = (0.05, 0.25, 0.5, 0.75, 0.95)
N_SOE_FEATURES = 4
FEATURE_DIM = 4 * FEATURE_BUCKETS + len(PRICE_QUANTILES) + N_SOE_FEATURES


def enabled() -> bool:
    """Live kill switch: read per call so a test (or an operator mid-
    incident) can force the cold path without rebuilding services."""
    return os.environ.get(WARMSTART_ENV, "1").strip().lower() \
        not in ("0", "false", "off")


def memory_cap() -> int:
    try:
        return max(1, int(os.environ.get(CAP_ENV, DEFAULT_CAP)))
    except ValueError:
        return DEFAULT_CAP


def opts_tag(opts) -> tuple:
    """The tolerance regime a solution converged under.  Exact-match
    substitution requires the SAME tag: a loose screening-tier answer
    must never substitute for a certified-tier solve on digest equality
    alone (it still serves as an iterate seed — the near path).  The
    solver dtype is part of the tag — it also sets the resolution the
    exact data digest is taken at, so two dtype regimes can never
    cross-substitute."""
    return (float(opts.eps_abs), float(opts.eps_rel),
            int(opts.max_iters), float(opts.inaccurate_factor),
            str(np.dtype(opts.dtype)))


def tag_dtype(tag: tuple) -> np.dtype:
    """The solver dtype a tag was built with (the exact-digest
    resolution)."""
    return np.dtype(tag[4])


def data_digest(lp, dtype=np.float32) -> bytes:
    """Byte-exact fingerprint of the per-instance data ``(c, q, l, u)``
    in the solver dtype (what the device actually solves)."""
    h = hashlib.sha256()
    for a in (lp.c, lp.q, lp.l, lp.u):
        h.update(np.ascontiguousarray(np.asarray(a, dtype)).tobytes())
    return h.digest()


def quant_digest(lp) -> bytes:
    """Proximity key: hash of the QUANTIZED data (float16 cast, ~3
    significant decimal digits; infinities and the reference's 1e30-ish
    no-limit sentinels all collapse to signed inf, which is what they
    mean).  Two instances whose data agree to quantization share the key
    — the fast near-neighbor path."""
    h = hashlib.sha256()
    for a in (lp.c, lp.q, lp.l, lp.u):
        with np.errstate(over="ignore"):
            h.update(np.ascontiguousarray(
                np.asarray(a, np.float64)).astype(np.float16).tobytes())
    return h.digest()


def feature_vec(lp) -> np.ndarray:
    """Small signature of ``(c, q, l, u)`` for nearest-entry selection
    and predictor training — ``FEATURE_DIM`` long: ``FEATURE_BUCKETS``
    contiguous-bucket means per vector (non-finite entries zeroed —
    sentinels would drown the signal), the per-window PRICE QUANTILES of
    the finite objective entries, and the SOE BOUNDARY STATE read from
    the rhs of the ``soe``-named row groups (entry SOE / final-target
    pins — the numbers the dispatch basis pivots on)."""
    parts = []
    for a in (lp.c, lp.q, lp.l, lp.u):
        a = np.asarray(a, np.float64)
        a = np.where(np.isfinite(a), a, 0.0)
        n = a.shape[0]
        if n == 0:
            parts.append(np.zeros(FEATURE_BUCKETS))
            continue
        pad = (-n) % FEATURE_BUCKETS
        if pad:
            a = np.concatenate([a, np.zeros(pad)])
        parts.append(a.reshape(FEATURE_BUCKETS, -1).mean(axis=1))
    # per-window price quantiles: the objective vector IS the price
    # signal in dispatch LPs (charge cost / discharge revenue per step)
    c = np.asarray(lp.c, np.float64)
    c_fin = c[np.isfinite(c)]
    parts.append(np.quantile(c_fin, PRICE_QUANTILES) if c_fin.size
                 else np.zeros(len(PRICE_QUANTILES)))
    # SOE boundary state: first/last rhs entry of every soe-named row
    # range (the entry-SOE carry and the window's final target/seam pin)
    firsts, lasts = [], []
    q = np.asarray(lp.q, np.float64)
    for name, ranges in (getattr(lp, "row_groups", None) or {}).items():
        if "soe" not in str(name).lower():
            continue
        for a0, b0 in ranges:
            if b0 > a0 and b0 <= q.shape[0]:
                firsts.append(q[a0])
                lasts.append(q[b0 - 1])
    if firsts:
        bvals = np.asarray(firsts + lasts, np.float64)
        bvals = np.where(np.isfinite(bvals), bvals, 0.0)
        soe_feat = np.array([
            float(np.mean(bvals[:len(firsts)])),
            float(np.mean(bvals[len(firsts):])),
            float(np.max(np.abs(bvals))),
            float(len(firsts)),
        ])
    else:
        soe_feat = np.zeros(N_SOE_FEATURES)
    parts.append(soe_feat)
    return np.concatenate(parts)


def _feat_dist(a: np.ndarray, b: np.ndarray) -> float:
    """L2 distance between feature vectors, inf on a dimension mismatch
    — entries stored under an OLDER feature layout (a fleet import from
    a pre-bump replica) must lose every nearest-feature contest rather
    than crash it."""
    if a.shape != b.shape:
        return float("inf")
    return float(np.linalg.norm(a - b))


def host_kkt(lp, x, y) -> Optional[Tuple[float, float, float,
                                         float, float]]:
    """Float64 host replica of the solver's KKT terms
    (``ops.pdhg._kkt_terms``) on the UNSCALED problem, plus a bounds-box
    feasibility term the device test omits only because its iterates
    are box-projected by construction.  Returns
    ``(prim, dual, gap, pobj, dobj)`` — or None for malformed vectors."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if x.shape != (lp.n,) or y.shape != (lp.m,):
        return None
    if not (np.all(np.isfinite(x)) and np.all(np.isfinite(y))):
        return None
    r = lp.q - lp.K @ x
    eq = np.arange(lp.m) < lp.n_eq
    viol = np.where(eq, np.abs(r), np.maximum(r, 0.0))
    l_fin = np.isfinite(lp.l)
    u_fin = np.isfinite(lp.u)
    # box violations fold into the primal residual (the stricter-only
    # direction: a genuine device iterate has none)
    bviol = (np.where(l_fin, np.maximum(lp.l - x, 0.0), 0.0)
             + np.where(u_fin, np.maximum(x - lp.u, 0.0), 0.0))
    prim = float(np.sqrt(np.sum(viol * viol) + np.sum(bviol * bviol)))
    lam = lp.c - lp.K.T @ y
    lam_pos = np.maximum(lam, 0.0)
    lam_neg = np.minimum(lam, 0.0)
    dres = np.where(l_fin, 0.0, lam_pos) + np.where(u_fin, 0.0, -lam_neg)
    dual = float(np.linalg.norm(dres)) if dres.size else 0.0
    pobj = float(lp.c @ x)
    dobj = float(lp.q @ y
                 + np.sum(np.where(l_fin, lam_pos * lp.l, 0.0)
                          + np.where(u_fin, lam_neg * lp.u, 0.0)))
    return prim, dual, abs(pobj - dobj), pobj, dobj


def check_converged_host(lp, x, y, opts, factor: float = 1.0) -> bool:
    """Does ``(x, y)`` satisfy the solver's full convergence criteria
    (``ops.pdhg._converged``) at ``factor``x the tolerances, evaluated
    in float64 on the unscaled problem?  ``factor=1`` is the strict
    gate exact-match substitution requires; ``factor=
    opts.inaccurate_factor`` is the INACCURATE acceptance band the cold
    path already ships (with a warning)."""
    terms = host_kkt(lp, x, y)
    if terms is None:
        return False
    prim, dual, gap, pobj, dobj = terms
    eps_abs = opts.eps_abs * factor
    eps_rel = opts.eps_rel * factor
    q_norm = float(np.linalg.norm(lp.q))
    c_norm = float(np.linalg.norm(lp.c))
    return (prim <= eps_abs + eps_rel * q_norm
            and dual <= eps_abs + eps_rel * c_norm
            and gap <= eps_abs + eps_rel * (abs(pobj) + abs(dobj)))


@dataclasses.dataclass
class SeedEntry:
    """One stored converged iterate (UNSCALED, solver dtype, trimmed —
    bucket-grid padding rows are never stored)."""
    x: np.ndarray
    y: np.ndarray
    obj: float
    feature: np.ndarray
    tag: tuple
    exact: bytes
    quant: bytes


@dataclasses.dataclass
class MemberPlan:
    """One group member's warm-start decision."""
    # "cold" | "predicted" | "near" | "dual_iterate" | "exact"
    kind: str
    entry: Optional[SeedEntry] = None
    # the member's ``lp.seed_hint`` (portfolio dual loop), kept on the
    # plan even for cold members so the post-solve store can index the
    # converged iterate for the NEXT dual iteration
    hint: Optional[tuple] = None
    substituted: bool = False        # exact hit that passed the f64 check
    stale_fault: bool = False        # seed corrupted by fault injection
    # substitution verdict + residuals (the INACCURATE band re-ships the
    # cold path's accepted-with-a-warning answer, warning included)
    inaccurate: bool = False
    prim: float = 0.0
    gap: float = 0.0
    # this member's OWN data digests from the probe, so a post-solve
    # store skips recomputing them
    exact_digest: Optional[bytes] = None
    quant_digest: Optional[bytes] = None


class SolutionMemory:
    """Bounded LRU of converged ``(x, y)`` iterates keyed by
    ``(structure key, exact data digest, tolerance tag)``.

    Thread-safe: the dispatch pipeline's workers look up and store
    concurrently.  Secondary indices serve the two proximity grades —
    ``(structure, quant digest) -> most recent entry`` and
    ``structure -> live entries`` for the nearest-by-feature fallback.
    A per-structure rolling window of COLD iteration counts provides the
    baseline the solve ledger's ``iters_saved`` is measured against."""

    def __init__(self, max_entries: Optional[int] = None):
        self.max_entries = int(max_entries) if max_entries else memory_cap()
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, SeedEntry]" = OrderedDict()
        self._by_struct: Dict[object, Dict[tuple, SeedEntry]] = {}
        self._by_quant: Dict[tuple, tuple] = {}
        self._cold_iters: Dict[object, deque] = {}
        self.stats = {"stores": 0, "evictions": 0, "hits_exact": 0,
                      "hits_near": 0, "hits_predicted": 0,
                      "hits_dual": 0, "misses": 0,
                      "substituted": 0, "stale_seed_faults": 0,
                      "invalidated": 0, "imported": 0,
                      "imported_hints": 0}
        # dual-iterate side table: hint key -> latest converged iterate
        # (the portfolio dual loop's reseeding store; see module doc)
        self._hints: "OrderedDict[tuple, SeedEntry]" = OrderedDict()
        # keys imported from another replica's export (fleet failover):
        # these serve the EXACT path only — see import_entries
        self._imported_keys: set = set()
        # learned cold-start predictor (ops/seedpredict.py): this
        # memory's entries double as its training set, and it rides the
        # memory's invalidation + fleet-handoff plumbing
        self.predictor = seedpredict.SeedPredictor()

    # -- internals (caller holds the lock) ------------------------------
    def _unlink(self, key, entry) -> None:
        """Remove one (already popped) entry from the secondary indices
        — the single place the index relationship lives, shared by
        eviction and invalidation."""
        skey = key[0]
        pool = self._by_struct.get(skey)
        if pool is not None:
            pool.pop(key, None)
            if not pool:
                del self._by_struct[skey]
        qkey = (skey, entry.quant)
        if self._by_quant.get(qkey) == key:
            del self._by_quant[qkey]
        self._imported_keys.discard(key)

    def _evict_lru(self) -> None:
        while len(self._entries) > self.max_entries:
            key, entry = self._entries.popitem(last=False)
            self._unlink(key, entry)
            self.stats["evictions"] += 1

    def bump(self, stat: str, n: int = 1) -> None:
        """Locked counter increment for planner-side events."""
        with self._lock:
            self.stats[stat] = self.stats.get(stat, 0) + n

    def ensure_capacity(self, n: int) -> None:
        """Raise the LRU cap to at least ``n`` entries (never lowers).

        Batched repeat workloads (Monte-Carlo valuation) need every
        window of one batch resident: if the cap evicts mid-batch, a
        repeat of the same request warm-starts the evicted windows
        near-grade instead of exact-grade SUBSTITUTING, and the
        re-converged iterates land on slightly different objectives
        within the loose screening tolerance — silently breaking the
        fixed-seed byte-identical replay contract."""
        with self._lock:
            self.max_entries = max(self.max_entries, int(n))

    # -- public API -----------------------------------------------------
    def lookup(self, skey, lp, tag: tuple
               ) -> Tuple[Optional[SeedEntry], Optional[str]]:
        """The best stored seed for one member: ``(entry, "exact")`` on a
        byte-exact data + tag match, ``(entry, "near")`` via the
        quantized digest or the nearest feature vector, ``(None, None)``
        when this structure has no entries."""
        entry, kind, _, _ = self.probe(skey, lp, tag)
        return entry, ("near" if kind == "feature" else kind)

    def probe(self, skey, lp, tag: tuple):
        """`lookup` plus the member's own ``(exact, quant)`` digests, so
        a later ``store`` of this member's solution skips recomputing
        the sha256 passes (~ms each at year-LP sizes).  The exact
        digest is taken at the tag's solver dtype — the resolution the
        device actually solves at.

        The two near sub-grades are distinguished here: ``"near"`` is a
        quantized-digest hit (the stored data agrees with this member's
        to ~3 significant digits — a genuinely nearby iterate), while
        ``"feature"`` is the nearest-by-feature fallback (same
        structure, arbitrarily far data) — the grade the learned
        predictor outranks in :func:`plan_group`."""
        exact = data_digest(lp, tag_dtype(tag))
        quant = quant_digest(lp)
        with self._lock:
            key = (skey, exact, tag)
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                self.stats["hits_exact"] += 1
                return e, "exact", exact, quant
            qk = self._by_quant.get((skey, quant))
            if qk is not None:
                e = self._entries.get(qk)
                if e is not None:
                    self._entries.move_to_end(qk)
                    self.stats["hits_near"] += 1
                    return e, "near", exact, quant
            pool = self._by_struct.get(skey)
            if pool:
                f = feature_vec(lp)
                best_key = min(
                    pool, key=lambda k: _feat_dist(pool[k].feature, f))
                if np.isfinite(_feat_dist(pool[best_key].feature, f)):
                    self._entries.move_to_end(best_key)
                    self.stats["hits_near"] += 1
                    return pool[best_key], "feature", exact, quant
            self.stats["misses"] += 1
            return None, None, exact, quant

    def store(self, skey, lp, tag: tuple, x, y, obj: float,
              exact: Optional[bytes] = None,
              quant: Optional[bytes] = None) -> None:
        """Store one converged member's unscaled iterates (trimmed).
        ``exact``/``quant`` pass through the digests a prior ``probe``
        of the same member already computed."""
        entry = SeedEntry(
            x=np.array(x, copy=True), y=np.array(y, copy=True),
            obj=float(obj), feature=feature_vec(lp), tag=tuple(tag),
            exact=(exact if exact is not None
                   else data_digest(lp, tag_dtype(tag))),
            quant=quant if quant is not None else quant_digest(lp))
        key = (skey, entry.exact, entry.tag)
        with self._lock:
            if key in self._entries:
                del self._entries[key]
            self._entries[key] = entry
            self._by_struct.setdefault(skey, {})[key] = entry
            self._by_quant[(skey, entry.quant)] = key
            self.stats["stores"] += 1
            self._evict_lru()

    def invalidate(self, skey, lp, dtype=np.float32) -> int:
        """Drop every entry for this structure whose data digest (at
        ``dtype``, the rejected regime's solver dtype) matches ``lp``
        — any tolerance tag.  Called when the PR-4 certifier REJECTS a
        solution the memory vouched for — without this, a
        wrong-but-convergence-passing entry would be re-substituted,
        re-rejected, and re-escalated on every exact repeat forever
        (each hit even refreshing it against LRU eviction).  The
        structure's learned seed model is dropped too: its training set
        just proved untrustworthy here.  Returns the number of entries
        dropped."""
        exact = data_digest(lp, dtype)
        with self._lock:
            doomed = [k for k in self._entries
                      if k[0] == skey and k[1] == exact]
            for key in doomed:
                self._unlink(key, self._entries.pop(key))
            self.stats["invalidated"] += len(doomed)
        self.predictor.invalidate(skey)
        # propagate the trust anomaly up to the request-level result
        # cache (service/reqcache.py): any memoized whole-request
        # answer could trace provenance to this memory — rejections
        # are rare, so every live cache conservatively clears.  Fenced:
        # cache invalidation must never break the certifier path.
        try:
            from ..service import reqcache
            reqcache.notify_memory_invalidation(skey)
        except Exception:
            pass
        return len(doomed)

    # -- dual-iterate hint table (portfolio outer loop) -----------------
    def store_hint(self, hint, x, y, obj: float) -> None:
        """Index one converged iterate under a caller-chosen hint key —
        the portfolio dual loop stores iteration k's solution here so
        iteration k+1 (same site/window, price-shifted ``c``) reseeds
        from it even though every quantized price feature moved.
        Bounded by the same LRU cap as the primary store; each key
        holds only its LATEST iterate (older dual iterates are strictly
        worse seeds)."""
        entry = SeedEntry(
            x=np.array(x, copy=True), y=np.array(y, copy=True),
            obj=float(obj), feature=np.zeros(0), tag=(), exact=b"",
            quant=b"")
        with self._lock:
            key = tuple(hint)
            self._hints.pop(key, None)
            self._hints[key] = entry
            while len(self._hints) > self.max_entries:
                self._hints.popitem(last=False)

    def lookup_hint(self, hint) -> Optional[SeedEntry]:
        """The latest iterate stored under ``hint``, or None.  Bumps the
        ``hits_dual`` counter on a hit (the caller reclassifies the
        probe's own counter — see :func:`plan_group`)."""
        with self._lock:
            e = self._hints.get(tuple(hint))
            if e is not None:
                self._hints.move_to_end(tuple(hint))
                self.stats["hits_dual"] += 1
            return e

    def entries_for_structure(self, skey) -> List[SeedEntry]:
        """Live entries for one structure, oldest-first — the learned
        predictor's training set (a locked snapshot of references; the
        entries themselves are never mutated in place)."""
        with self._lock:
            pool = self._by_struct.get(skey)
            return list(pool.values()) if pool else []

    # -- fleet failover handoff -----------------------------------------
    def export_entries(self, max_entries: int = 128) -> List[Tuple]:
        """Serializable snapshot of the most-recent entries — the
        warm-start handoff a fleet replica publishes so that, when it
        dies, the router can hand its converged iterates to the replica
        that inherits its in-flight requests (the re-solve of an
        already-solved window becomes an exact-match substitution:
        zero device work, byte-identical bytes).

        Returns ``[(key, fields), ...]`` oldest-first, where ``key`` is
        the ``(structure key, exact digest, tolerance tag)`` LRU key and
        ``fields`` the plain-array entry payload — picklable as long as
        structure keys are (they are tuples of primitives)."""
        with self._lock:
            items = list(self._entries.items())[-int(max_entries):]
            return [(key, {"x": np.array(e.x), "y": np.array(e.y),
                           "obj": e.obj, "feature": np.array(e.feature),
                           "tag": e.tag, "exact": e.exact,
                           "quant": e.quant})
                    for key, e in items]

    def import_entries(self, payload, exact_only: bool = True) -> int:
        """Install another replica's exported entries.  With
        ``exact_only`` (the default, and what fleet failover uses) the
        entries are registered in the primary store ONLY — visible to
        byte-exact substitution (which re-verifies in float64 and ships
        verbatim, preserving the fleet's byte-identical-failover
        contract) but invisible to the near-seed indices: a near-grade
        seed from foreign data would change the re-solve's iterate path
        and so its low-order result bits.  Entries already present (or
        malformed) are skipped.  Returns the number installed."""
        n = 0
        for key, f in payload:
            try:
                entry = SeedEntry(
                    x=np.asarray(f["x"]), y=np.asarray(f["y"]),
                    obj=float(f["obj"]), feature=np.asarray(f["feature"]),
                    tag=tuple(f["tag"]), exact=bytes(f["exact"]),
                    quant=bytes(f["quant"]))
                key = (key[0], bytes(key[1]), tuple(key[2]))
            except (KeyError, TypeError, ValueError, IndexError):
                continue
            with self._lock:
                if key in self._entries:
                    continue
                self._entries[key] = entry
                if exact_only:
                    self._imported_keys.add(key)
                else:
                    self._by_struct.setdefault(key[0], {})[key] = entry
                    self._by_quant[(key[0], entry.quant)] = key
                self.stats["imported"] += 1
                n += 1
                self._evict_lru()
        return n

    def export_hints(self, max_hints: int = 256) -> List[Tuple]:
        """Serializable snapshot of the most-recent ``dual_iterate``
        hint-table entries (portfolio outer-loop iterates keyed by
        ``(tag, site, window)``).  Without these in the fleet handoff, a
        failover or re-routed portfolio shard restarts its sites COLD
        mid-dual-loop — the hint is the round-k converged iterate, so
        the inheritor that imports it reseeds round k+1 exactly as the
        dead replica would have."""
        with self._lock:
            items = list(self._hints.items())[-int(max_hints):]
            return [(key, {"x": np.array(e.x), "y": np.array(e.y),
                           "obj": e.obj})
                    for key, e in items]

    def import_hints(self, payload) -> int:
        """Install another replica's exported hint entries (skipping
        malformed ones; a key already present keeps the LOCAL iterate —
        it is at least as recent).  Returns the number installed."""
        n = 0
        for key, f in payload or []:
            try:
                key = tuple(key)
                x = np.asarray(f["x"], np.float64)
                y = np.asarray(f["y"], np.float64)
                obj = float(f["obj"])
                with self._lock:
                    # an unhashable key (nested list from a foreign
                    # serialization) raises HERE — skip it, keep going
                    if key in self._hints:
                        continue
                    self._hints[key] = SeedEntry(
                        x=x, y=y, obj=obj, feature=np.zeros(0), tag=(),
                        exact=b"", quant=b"")
                    while len(self._hints) > self.max_entries:
                        self._hints.popitem(last=False)
                    self.stats["imported_hints"] += 1
                    n += 1
            except (KeyError, TypeError, ValueError):
                continue
        return n

    def export_payload(self, max_entries: int = 128,
                       max_models: int = 16,
                       max_hints: int = 256) -> Dict:
        """The full fleet-handoff payload: recent entries PLUS the
        learned seed models (ops/seedpredict.py) PLUS the bounded
        ``dual_iterate`` hint table, so the inheriting replica
        substitutes byte-exact repeats, predicts for structures it
        never solved, and stays warm mid-portfolio-dual-loop."""
        return {"entries": self.export_entries(max_entries),
                "models": self.predictor.export_models(max_models),
                "hints": self.export_hints(max_hints)}

    def import_payload(self, payload, exact_only: bool = True) -> int:
        """Install an exported payload — the ``export_payload`` dict or
        a bare ``export_entries`` list (older replicas; a dict without
        ``"hints"`` is likewise legal).  Returns the number of ENTRIES
        installed (models and hints are best-effort extras)."""
        if isinstance(payload, dict):
            self.predictor.import_models(payload.get("models"))
            self.import_hints(payload.get("hints"))
            payload = payload.get("entries") or []
        return self.import_entries(payload, exact_only=exact_only)

    def note_cold_iters(self, skey, iters) -> None:
        """Record cold members' iteration counts — the per-structure
        baseline ``iters_saved`` is measured against."""
        with self._lock:
            d = self._cold_iters.setdefault(skey, deque(maxlen=512))
            d.extend(int(v) for v in np.atleast_1d(iters))

    def cold_p50(self, skey) -> Optional[int]:
        with self._lock:
            d = self._cold_iters.get(skey)
            return int(np.percentile(list(d), 50)) if d else None

    def snapshot(self) -> Dict:
        with self._lock:
            snap = {"entries": len(self._entries),
                    "hint_entries": len(self._hints),
                    "structures": len(self._by_struct),
                    "imported_live": len(self._imported_keys),
                    "max_entries": self.max_entries,
                    "bytes": int(sum(e.x.nbytes + e.y.nbytes
                                     for e in self._entries.values())),
                    **dict(self.stats)}
        snap["predictor"] = self.predictor.snapshot()
        return snap


def plan_group(memory: SolutionMemory, skey, lps, opts, labels
               ) -> List[MemberPlan]:
    """Per-member warm-start plan for one structure group.

    Grade ladder per member: **exact** (byte-identical data + tag, may
    substitute), **dual_iterate** (the member carries an
    ``lp.seed_hint`` and the hint table holds its previous outer-loop
    iterate — the member's OWN last trajectory outranks any neighbor's),
    **near** (quantized-digest hit — a stored iterate whose data agrees
    to ~3 significant digits), **predicted** (the learned seed model's
    interpolation — outranks the nearest-by-feature fallback, whose
    entry may be arbitrarily far, but never a genuine near hit),
    feature-nearest (reported as ``near``), cold.

    Exact hits are promoted to substitution only after the stored
    solution passes :func:`check_converged_host` under the CURRENT
    options; the ``stale_seed`` fault corrupts a targeted member's seed
    COPY — stored entry or fresh prediction alike — and demotes it to
    plain iterate seeding: the production shape of a stale, evicted,
    poisoned, or mis-predicted seed, which may cost iterations but is
    always caught by the normal convergence criteria."""
    from ..utils import faultinject
    tag = opts_tag(opts)
    plans: List[MemberPlan] = []
    fplan = faultinject.get_plan()
    predictor = memory.predictor
    use_pred = seedpredict.enabled()
    if use_pred:
        # opportunistic (re)fit from this structure's live entries —
        # host-side, feature-dimension-sized, microseconds
        predictor.maybe_fit(skey, memory.entries_for_structure(skey))
    for lp, label in zip(lps, labels):
        entry, kind, exact, quant = memory.probe(skey, lp, tag)
        hint = getattr(lp, "seed_hint", None)
        if hint is not None and kind != "exact":
            # dual-iterate grade: the member's own previous outer-loop
            # iterate beats any quantized-digest neighbor — a dual
            # update shifts every price feature, so the near grade
            # degrades exactly on this workload (the PR-13 fix)
            h = memory.lookup_hint(hint)
            if h is not None:
                # RECLASSIFY the probe's counter, same discipline as
                # the predicted grade below
                memory.bump("hits_near" if kind in ("near", "feature")
                            else "misses", -1)
                entry, kind = h, "dual_iterate"
        if use_pred and kind in (None, "feature"):
            pred = predictor.predict(skey, feature_vec(lp))
            if pred is not None:
                entry = SeedEntry(
                    x=np.asarray(pred[0], tag_dtype(tag)),
                    y=np.asarray(pred[1], tag_dtype(tag)),
                    obj=float("nan"), feature=np.zeros(0), tag=tag,
                    exact=b"", quant=b"")
                # RECLASSIFY the probe's counter: the member is served
                # by the prediction, not by the feature fallback / miss
                # the probe just tallied — without this the grade
                # counters sum to more than the lookups
                memory.bump("hits_near" if kind == "feature"
                            else "misses", -1)
                kind = "predicted"
                memory.bump("hits_predicted")
        if kind == "feature":
            kind = "near"
        if entry is None:
            plans.append(MemberPlan("cold", hint=hint, exact_digest=exact,
                                    quant_digest=quant))
            continue
        if fplan is not None and fplan.stale_seed_due(label):
            bad_x = faultinject.corrupt_array(
                entry.x, f"stale_seed|{label}", fplan.stale_seed_scale)
            bad_y = faultinject.corrupt_array(
                entry.y, f"stale_seed|y|{label}", fplan.stale_seed_scale)
            stale = SeedEntry(x=bad_x, y=bad_y, obj=entry.obj,
                              feature=entry.feature, tag=entry.tag,
                              exact=b"", quant=b"")
            memory.bump("stale_seed_faults")
            plans.append(MemberPlan(
                kind if kind in ("predicted", "dual_iterate") else "near",
                stale, hint=hint, stale_fault=True, exact_digest=exact,
                quant_digest=quant))
            continue
        mp = MemberPlan(kind, entry, hint=hint, exact_digest=exact,
                        quant_digest=quant)
        if kind == "exact":
            terms = host_kkt(lp, entry.x, entry.y)
            if terms is not None:
                strict = check_converged_host(lp, entry.x, entry.y, opts)
                loose = strict or check_converged_host(
                    lp, entry.x, entry.y, opts,
                    factor=opts.inaccurate_factor)
                if loose:
                    # re-ship the stored answer under the float64
                    # re-check's OWN verdict: CONVERGED inside
                    # tolerance, INACCURATE (accepted upstream with a
                    # warning) inside the inaccurate band.  On a
                    # marginal window the f64 grading (plus the box
                    # term) can land stricter than the device's f32
                    # verdict did — the warm repeat then carries the
                    # warning the cold pass skipped, or re-solves; the
                    # divergence is one-directional (stricter) and the
                    # shipped bytes, when substituted, are identical.
                    mp.substituted = True
                    mp.inaccurate = not strict
                    mp.prim, mp.gap = terms[0], terms[2]
                    memory.bump("substituted")
        plans.append(mp)
    return plans
