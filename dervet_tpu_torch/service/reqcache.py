"""Request-level result memoization: the router's content-addressed
whole-request cache, in-flight dedup keys, and per-window delta digests.

Request memoization is the biggest requests/sec lever on the serving
path: a fleet serving many users sees mostly near-duplicate requests,
yet every one pays admission + dispatch even when some replica already
solved it bit-for-bit.  The warm-start ladder proved exact-grade
substitution is safe at *window* granularity (stored solutions
re-verify in float64 before shipping verbatim); this module lifts the
same contract to *whole requests* — the amortize-repeated-work shape
DuaLip-GPU uses for repeated extreme-scale solves and MPAX gets from
persistent compiled-program reuse.

Three pieces, all consumed by :class:`~.router.FleetRouter`:

* **Key material** (:func:`key_material` / :func:`material_key`) — a
  request is addressed by its structure fingerprint, a *content*
  digest over every input that reaches the solver (scenario/DER/stream
  params, finance, overrides, and every dataset frame — strictly more
  than ``resilience.case_fingerprint``, which only covers the
  time-series frame), the router's tolerance tag, the ACTIVE
  certification policy, and the solver version.  A tighter cert policy
  can therefore never be served an answer certified under a looser
  one, and a solver upgrade invalidates everything it might now answer
  differently.  Hits re-compare the FULL material, so even a SHA-256
  collision cannot serve wrong bytes.
* **Result cache** (:class:`RequestResultCache`) — bounded LRU over
  complete certificate-carrying artifact sets persisted under
  ``fleet/result_cache/<key>/`` with the run supervisor's atomic-rename
  discipline (build in a dot-tmp dir, ``os.replace`` into place).
  Only certified, audit-clean, quarantine-free answers are stored —
  :func:`cacheable` is the single enforcement point — and a
  certificate rejection anywhere in the process clears every live
  cache through :func:`notify_memory_invalidation` (conservative: the
  rejection is a trust anomaly, and rejections are rare).
* **Delta digests** (:func:`diff_request`) — per-optimization-window
  digests of the time-series slice (labels from the same
  ``build_optimization_levels`` the scenario itself windows with), so
  ``submit_delta`` can tell exactly which windows an edited case
  changed.  Unchanged windows exact-substitute from the target
  replica's warm memory (zero device work, byte-identical bytes);
  changed windows re-solve with near/``dual_iterate`` seeding.

``DERVET_TPU_REQUEST_CACHE=0`` kills the whole plane: no lookups, no
stores, no dedup keys, no on-disk state — today's path bit for bit.
Cache hygiene is env-tunable:
``DERVET_TPU_REQUEST_CACHE_TTL_S`` ages entries out at lookup time
(default: no TTL — LRU only), ``DERVET_TPU_REQUEST_CACHE_MAX_ENTRIES``
overrides the LRU capacity; eviction/expiry counts ride the router's
fleet telemetry exposition.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import shutil
import threading
import time
import weakref
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

ENV = "DERVET_TPU_REQUEST_CACHE"
TTL_ENV = "DERVET_TPU_REQUEST_CACHE_TTL_S"
MAX_ENTRIES_ENV = "DERVET_TPU_REQUEST_CACHE_MAX_ENTRIES"


def _env_positive_float(name: str) -> Optional[float]:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v > 0 else None


def current_solver_version() -> str:
    """The solver's version tag (``ops.pdhg.SOLVER_VERSION`` — bumped
    whenever solver numerics can change certified answers).  Part of
    every cache key, so stale-version hits are structurally
    impossible; also stamped into run_health + the solve ledger."""
    try:
        from ..ops.pdhg import SOLVER_VERSION
        return str(SOLVER_VERSION)
    except Exception:
        return "unknown"


# artifact names a dir-kind cache entry carries alongside the copied
# results tree
ENTRY_FILE = "entry.json"
ARTIFACTS_DIR = "artifacts"
RESULT_PICKLE = "result.pkl"


def enabled() -> bool:
    """Live read of the kill switch (default ON)."""
    return os.environ.get(ENV, "1").strip().lower() not in (
        "0", "false", "off", "no")


# ---------------------------------------------------------------------------
# Content digests (the "data" component of the key)
# ---------------------------------------------------------------------------

_FRAME_FIELDS = ("time_series", "monthly", "yearly", "tariff",
                 "cycle_life", "load_shed")


def _hash_frame(h, name: str, df) -> None:
    """Fold one dataset frame into ``h``.  ``hash_pandas_object``
    covers values + index for mixed dtypes; the CSV render is the
    (slow, exact) fallback for frames it cannot hash."""
    if df is None:
        h.update(f"{name}:none".encode())
        return
    h.update(f"{name}:".encode())
    h.update(repr(list(map(str, df.columns))).encode())
    try:
        import pandas as pd
        h.update(pd.util.hash_pandas_object(df, index=True)
                 .to_numpy().tobytes())
    except Exception:
        h.update(df.to_csv().encode())


def case_content_digest(case) -> str:
    """Content hash over EVERY input of one :class:`CaseParams` that
    can reach the solver or the artifact set — a strict superset of
    ``resilience.case_fingerprint`` (which hashes only the time-series
    frame): finance, overrides, CBA re-pricing, and all dataset frames
    are folded in, because any of them can change the answer bytes."""
    h = hashlib.sha256()
    h.update(repr(sorted(case.scenario.items(), key=str)).encode())
    for tag, der_id, keys in case.ders:
        h.update(repr((tag, der_id, sorted(keys.items()))).encode())
    for tag, keys in sorted(case.streams.items()):
        h.update(repr((tag, sorted(keys.items()))).encode())
    h.update(repr(sorted(getattr(case, "finance", {}).items(),
                         key=str)).encode())
    for attr in ("overrides", "cba_overrides"):
        h.update(repr(sorted(getattr(case, attr, {}).items(),
                             key=str)).encode())
    ds = getattr(case, "datasets", None)
    for name in _FRAME_FIELDS:
        _hash_frame(h, name, getattr(ds, name, None))
    return h.hexdigest()


def request_content_digest(cases: Dict) -> str:
    """Order-independent content digest of a whole request."""
    h = hashlib.sha256()
    for key in sorted(cases, key=str):
        h.update(str(key).encode())
        h.update(case_content_digest(cases[key]).encode())
    return h.hexdigest()


def cert_policy_tag() -> str:
    """Canonical JSON of the ACTIVE certification policy — part of the
    key, so a tighter policy can never be served an answer that was
    only certified under a looser one."""
    try:
        from ..ops.certify import policy_from_env
        return json.dumps(policy_from_env().as_dict(), sort_keys=True)
    except Exception:
        return "unknown"


def key_material(cases: Dict, *, content_digest: Optional[str] = None,
                 tolerance_tag: str = "default",
                 solver_version: Optional[str] = None,
                 mc_spec=None) -> Dict[str, str]:
    """The full (human-readable) key material for one request.  Stored
    verbatim in each cache entry and re-compared on every hit, so a
    digest collision can never serve a wrong answer.

    ``mc_spec`` (a :class:`~dervet_tpu_torch.stochastic.sampler.MCSpec`)
    folds the Monte-Carlo sampler identity — seed, sample count, shock
    sigmas, quantile/CVaR request — into the key as an EXTRA field, so
    two MC requests over the same base case but a different seed or
    sample count can never collide.  Plain scenario requests omit the
    field entirely: their key material (and thus every existing cache
    entry) is byte-identical to before the field existed."""
    from .fleet import structure_fingerprint
    material = {
        "structure": structure_fingerprint(cases),
        "data": (str(content_digest) if content_digest
                 else request_content_digest(cases)),
        "tolerance": str(tolerance_tag),
        "cert_policy": cert_policy_tag(),
        "solver_version": (str(solver_version) if solver_version
                           else current_solver_version()),
    }
    if mc_spec is not None:
        material["mc"] = json.dumps(mc_spec.normalized(), sort_keys=True)
    return material


def material_key(material: Dict[str, str]) -> str:
    return hashlib.sha256(
        json.dumps(material, sort_keys=True).encode()).hexdigest()


# ---------------------------------------------------------------------------
# Store guard: what is allowed into the cache
# ---------------------------------------------------------------------------

def cacheable(run_health: Optional[Dict],
              fidelity: Optional[str]) -> Tuple[bool, str]:
    """Single enforcement point for the certificate contract: only a
    CERTIFIED, audit-clean, quarantine-free answer may be memoized.
    Degraded-tier answers, certificate-rejected windows, invariant
    audit failures, and quarantined cases all refuse the store — a
    cache must never launder an uncertified answer into a certified
    byte stream."""
    if fidelity is not None and str(fidelity) != "certified":
        return False, f"fidelity={fidelity!r} (not certified)"
    if not isinstance(run_health, dict):
        return False, "no run_health artifact"
    # cases_quarantined is a list of case keys (io/summary.py)
    if run_health.get("cases_quarantined"):
        return False, "request had quarantined cases"
    windows = run_health.get("windows")
    if isinstance(windows, dict) and \
            int(windows.get("quarantined") or 0) > 0:
        return False, "request had quarantined windows"
    cert = run_health.get("certification")
    if isinstance(cert, dict):
        # per-window certificate counts nest under "windows";
        # rejected_final marks windows whose certificate was REFUSED
        # for good (rejected-then-recovered windows end certified and
        # are cacheable)
        cw = cert.get("windows")
        counts = cw if isinstance(cw, dict) else cert
        if int(counts.get("rejected_final") or 0) > 0:
            return False, "certificate-rejected windows in the answer"
    audit = run_health.get("invariant_audit")
    if isinstance(audit, dict) and audit.get("ok") is False:
        return False, "invariant audit not clean"
    return True, "ok"


# ---------------------------------------------------------------------------
# The on-disk LRU result cache
# ---------------------------------------------------------------------------

class CacheHit:
    """One resolved lookup.  ``results_dir`` for artifact (spool)
    entries, ``result`` for in-process (local transport) entries."""

    __slots__ = ("key", "rid", "results_dir", "result")

    def __init__(self, key, rid, results_dir=None, result=None):
        self.key = key
        self.rid = rid
        self.results_dir: Optional[Path] = results_dir
        self.result = result


# every live cache in the process: a certificate rejection
# (SolutionMemory.invalidate) clears them all through
# notify_memory_invalidation below
_LIVE_CACHES: "weakref.WeakSet[RequestResultCache]" = weakref.WeakSet()


def notify_memory_invalidation(skey: Optional[str] = None,
                               reason: str = "cert_rejection") -> int:
    """A warm-memory entry was invalidated by a certificate rejection:
    conservatively clear EVERY live request cache in this process.
    Rejections are rare trust anomalies; dropping the whole cache is
    cheap next to serving one answer whose provenance chain includes a
    solution float64 certification just refused.  (Cross-process
    safety does not depend on this hook — a rejected result is never
    stored in the first place, see :func:`cacheable`.)"""
    dropped = 0
    for cache in list(_LIVE_CACHES):
        try:
            dropped += cache.clear(reason=reason)
        except Exception:
            pass
    return dropped


class RequestResultCache:
    """Bounded LRU of complete request answers under ``root``.

    Layout per entry::

        root/<key>/entry.json        # full key material + rid + kind
        root/<key>/artifacts/**      # copied results/<rid>/ tree, or
        root/<key>/result.pkl        # pickled in-process Result

    Writes follow the run supervisor's atomic discipline: the entry is
    built in a
    ``root/.tmp.*`` dir and ``os.replace``d into place, so readers
    (and a crash) see either nothing or a complete entry.  The root
    dir itself is created lazily on the first store — with the kill
    switch on, no cache files OR dirs ever appear."""

    def __init__(self, root, max_entries: int = 256,
                 ttl_s: Optional[float] = None):
        self.root = Path(root)
        # env knobs win over constructor defaults so a deployment can
        # retune cache hygiene without touching router construction
        env_max = _env_positive_float(MAX_ENTRIES_ENV)
        self.max_entries = (int(env_max) if env_max is not None
                            else int(max_entries))
        self.ttl_s = (ttl_s if ttl_s is not None
                      else _env_positive_float(TTL_ENV))
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, Dict]" = OrderedDict()
        self._counters = {"hits": 0, "misses": 0, "stores": 0,
                          "evictions": 0, "expired": 0, "refused": 0,
                          "collisions": 0, "invalidations": 0}
        self._load()

    # -- persistence ----------------------------------------------------
    def _load(self) -> None:
        """Adopt entries a previous router left on disk (LRU order =
        entry-file mtime).  Unreadable/partial entries are ignored —
        they can only be dot-tmp leftovers or manual damage."""
        if not self.root.is_dir():
            return
        found = []
        for d in self.root.iterdir():
            if not d.is_dir() or d.name.startswith(".tmp"):
                continue
            ef = d / ENTRY_FILE
            try:
                entry = json.loads(ef.read_text())
                mtime = ef.stat().st_mtime
                # pre-TTL entries carry no store time: the entry file's
                # mtime is exactly when the store landed
                entry.setdefault("t", mtime)
                found.append((mtime, d.name, entry))
            except (OSError, ValueError):
                continue
        for _, key, entry in sorted(found):
            self._entries[key] = entry

    def _entry_dir(self, key: str) -> Path:
        return self.root / key

    # -- lookup ---------------------------------------------------------
    def lookup(self, key: str, material: Dict[str, str]
               ) -> Optional[CacheHit]:
        """Resolve a hit, or None.  The stored material is re-compared
        in full — a key collision on different data counts as a miss
        (and a ``collisions`` tick), never a wrong answer."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._counters["misses"] += 1
                return None
            if self.ttl_s is not None and \
                    time.time() - float(entry.get("t") or 0) > self.ttl_s:
                # aged out: drop memory + disk, count, miss
                self._entries.pop(key, None)
                self._counters["expired"] += 1
                self._counters["misses"] += 1
                shutil.rmtree(self._entry_dir(key), ignore_errors=True)
                return None
            if entry.get("material") != material:
                self._counters["collisions"] += 1
                self._counters["misses"] += 1
                return None
            d = self._entry_dir(key)
            try:
                if entry.get("kind") == "pickle":
                    blob = (d / RESULT_PICKLE).read_bytes()
                    hit = CacheHit(key, entry.get("rid", ""),
                                   result=pickle.loads(blob))
                else:
                    art = d / ARTIFACTS_DIR
                    if not art.is_dir():
                        raise OSError(f"missing {art}")
                    hit = CacheHit(key, entry.get("rid", ""),
                                   results_dir=art)
            except Exception:
                # damaged on disk (wiped mid-flight): drop and miss
                self._entries.pop(key, None)
                self._counters["misses"] += 1
                return None
            self._entries.move_to_end(key)
            self._counters["hits"] += 1
            return hit

    # -- store ----------------------------------------------------------
    def store(self, key: str, material: Dict[str, str], *, rid: str,
              results_dir: Optional[Path] = None, result=None,
              run_health: Optional[Dict] = None,
              fidelity: Optional[str] = None) -> bool:
        """Persist one delivered answer (certificate contract enforced
        here — see :func:`cacheable`).  Returns True when the entry is
        live on disk."""
        ok, _reason = cacheable(run_health, fidelity)
        if not ok:
            with self._lock:
                self._counters["refused"] += 1
            return False
        entry = {"key": key, "material": material, "rid": str(rid),
                 "kind": "dir" if results_dir is not None else "pickle",
                 "solver_version": material.get("solver_version"),
                 "t": round(time.time(), 3)}
        tmp = self.root / f".tmp.{key[:16]}.{os.getpid()}"
        try:
            self.root.mkdir(parents=True, exist_ok=True)
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            if results_dir is not None:
                shutil.copytree(results_dir, tmp / ARTIFACTS_DIR)
                # a cached answer is re-served under NEW rids whose
                # run_health.<rid>.json can't exist — materialize the
                # bare-name fallback load_run_health() reads
                for base in ("run_health.json", "solve_ledger.json"):
                    stem, suffix = base.rsplit(".", 1)
                    named = (tmp / ARTIFACTS_DIR /
                             f"{stem}.{rid}.{suffix}")
                    bare = tmp / ARTIFACTS_DIR / base
                    if named.exists() and not bare.exists():
                        shutil.copyfile(named, bare)
            else:
                (tmp / RESULT_PICKLE).write_bytes(
                    pickle.dumps(result, pickle.HIGHEST_PROTOCOL))
            (tmp / ENTRY_FILE).write_text(
                json.dumps(entry, sort_keys=True, indent=1))
            dest = self._entry_dir(key)
            with self._lock:
                if key in self._entries:        # concurrent store won
                    shutil.rmtree(tmp, ignore_errors=True)
                    self._entries.move_to_end(key)
                    return True
                os.replace(tmp, dest)
                self._entries[key] = entry
                self._counters["stores"] += 1
                while len(self._entries) > self.max_entries:
                    old, _ = self._entries.popitem(last=False)
                    self._counters["evictions"] += 1
                    shutil.rmtree(self._entry_dir(old),
                                  ignore_errors=True)
            return True
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            return False

    # -- invalidation ---------------------------------------------------
    def clear(self, reason: str = "") -> int:
        """Drop every entry (memory + disk).  The conservative answer
        to a warm-memory certificate rejection."""
        with self._lock:
            keys = list(self._entries)
            self._entries.clear()
            if keys:
                self._counters["invalidations"] += 1
        for key in keys:
            shutil.rmtree(self._entry_dir(key), ignore_errors=True)
        return len(keys)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> Dict:
        with self._lock:
            return {"entries": len(self._entries),
                    "max_entries": self.max_entries,
                    "ttl_s": self.ttl_s,
                    **self._counters}


def open_cache(root, max_entries: int = 256,
               ttl_s: Optional[float] = None) -> RequestResultCache:
    """Construct + register a cache with the process-wide invalidation
    registry (so certificate rejections reach it)."""
    cache = RequestResultCache(root, max_entries=max_entries, ttl_s=ttl_s)
    _LIVE_CACHES.add(cache)
    return cache


# ---------------------------------------------------------------------------
# Per-window delta digests (submit_delta)
# ---------------------------------------------------------------------------

def window_digests(case) -> Optional[Tuple[str, Dict[int, str]]]:
    """``(non_ts_digest, {window_label: ts_slice_digest})`` for one
    case, labeling the time series with the SAME
    ``build_optimization_levels`` the scenario itself windows with —
    so "window" here is exactly the solver's dispatch window.  None
    when the case has no time series or cannot be labeled (callers
    treat that as "everything changed")."""
    ds = getattr(case, "datasets", None)
    ts = getattr(ds, "time_series", None)
    if ts is None or len(ts) == 0:
        return None
    try:
        from ..scenario.window import build_optimization_levels
        labels = build_optimization_levels(
            ts.index, case.scenario.get("n", "year"),
            float(case.scenario.get("dt", 1)))
        lab = np.asarray(labels.to_numpy(), dtype=np.int64)
        arr = np.ascontiguousarray(
            ts.to_numpy(dtype=np.float64, na_value=np.nan))
    except Exception:
        return None
    per: Dict[int, str] = {}
    for v in np.unique(lab):
        per[int(v)] = hashlib.sha256(
            arr[lab == v].tobytes()).hexdigest()
    h = hashlib.sha256()
    h.update(repr(sorted(case.scenario.items(), key=str)).encode())
    for tag, der_id, keys in case.ders:
        h.update(repr((tag, der_id, sorted(keys.items()))).encode())
    for tag, keys in sorted(case.streams.items()):
        h.update(repr((tag, sorted(keys.items()))).encode())
    h.update(repr(sorted(getattr(case, "finance", {}).items(),
                         key=str)).encode())
    for attr in ("overrides", "cba_overrides"):
        h.update(repr(sorted(getattr(case, attr, {}).items(),
                             key=str)).encode())
    h.update(repr(list(map(str, ts.columns))).encode())
    for name in _FRAME_FIELDS:
        if name != "time_series":
            _hash_frame(h, name, getattr(ds, name, None))
    return h.hexdigest(), per


def diff_case(base_case, edited_case
              ) -> Optional[Tuple[List[int], int]]:
    """``(changed_window_labels, total_windows)`` between two cases,
    or None when they are not window-comparable (different structure,
    window scheme, or any non-time-series input changed) — the caller
    must then treat the whole case as changed."""
    a = window_digests(base_case)
    b = window_digests(edited_case)
    if a is None or b is None:
        return None
    (ga, pa), (gb, pb) = a, b
    if ga != gb or set(pa) != set(pb):
        return None
    changed = sorted(k for k in pb if pa[k] != pb[k])
    return changed, len(pb)


def diff_request(base_cases: Dict, edited_cases: Dict
                 ) -> Optional[Dict]:
    """Whole-request delta summary: ``{"windows_changed",
    "windows_total", "per_case"}`` or None when the requests are not
    comparable case-for-case (conservative: all windows changed)."""
    if set(map(str, base_cases)) != set(map(str, edited_cases)):
        return None
    by_str_b = {str(k): v for k, v in base_cases.items()}
    changed = total = 0
    per_case = {}
    for k, edited in edited_cases.items():
        d = diff_case(by_str_b[str(k)], edited)
        if d is None:
            return None
        c, t = d
        changed += len(c)
        total += t
        per_case[str(k)] = {"changed": c, "total": t}
    return {"windows_changed": changed, "windows_total": total,
            "per_case": per_case}
