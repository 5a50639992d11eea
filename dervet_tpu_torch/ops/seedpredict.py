"""Learned cold-start seed predictor: SolutionMemory as a training set.

Warm starts (ops/warmstart.py) zeroed out repeat traffic, but a COLD
instance — same window structure, genuinely new data — still pays the
full iteration bill (BENCH_r05: iters p50 1664 per window LP).  The
PDHG-unrolled L2O line (PAPERS.md: arxiv 2406.01908) shows a small
learned model mapping LP features -> initial iterates closes most of
that gap, and this codebase already has everything such a model needs:

* a training set — every converged ``(x, y)`` the :class:`~dervet_tpu.
  ops.warmstart.SolutionMemory` stores, keyed by structure, with a
  float16-quantized feature digest per entry (the ``feature_vec``
  bucketed means, the same proximity signal the near grade ranks by);
* a safety net — the solver's full convergence criteria plus the PR-4
  float64 certification run on every predicted-seeded window, so a bad
  prediction costs iterations, never correctness (the ``stale_seed``
  fault drill covers exactly the corrupted-prediction shape).

The model is deliberately cheap: one RIDGE REGRESSION per structure key
from the (d+1)-dimensional quantized feature vector (d =
``warmstart.FEATURE_DIM``: 4 x ``FEATURE_BUCKETS`` bucketed means plus
the per-window price quantiles and SOE boundary state, + bias) to the
stacked ``[x; y]`` iterate, solved by normal equations on the host —
microseconds to fit at d ~ 41, independent of how large ``n + m`` is
(the Gram matrix is feature-sized; the target projection is one
(N, d+1)^T @ (N, n+m) matmul over at most a few hundred memory
entries).  Models fitted under an older feature dimension are dropped
on fleet import (``import_models``) and skipped at fit time.  Below
``min_entries`` the model abstains and the planner falls back to the
nearest-feature near grade; a certificate rejection on a structure drops
its model outright (``invalidate``).

Predictions serve as the ``predicted`` warm-start grade — below
``near`` (a genuinely nearby stored iterate beats an interpolation),
above cold.  Like exact entries, fitted models export/import across the
fleet (``export_models`` / ``import_models`` ride the memory handoff
payload), so a replica inheriting a dead sibling's traffic can predict
for structures it has never solved.

``DERVET_TPU_SEEDPREDICT=0`` kills the subsystem (predicted grade
disappears; near/exact grades untouched); ``DERVET_TPU_SEEDPREDICT_CAP``
bounds the per-process model count (default 64, LRU).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

SEEDPREDICT_ENV = "DERVET_TPU_SEEDPREDICT"
CAP_ENV = "DERVET_TPU_SEEDPREDICT_CAP"
DEFAULT_CAP = 64
# abstain below this many training entries: a 1-2 point "fit" is the
# nearest-neighbor seed with extra steps
DEFAULT_MIN_ENTRIES = 4
# refit when a structure gained this many stores since its last fit
DEFAULT_REFIT_EVERY = 8
RIDGE_LAMBDA = 1e-4


def enabled() -> bool:
    """Live kill switch (read per call, like warmstart.enabled)."""
    return os.environ.get(SEEDPREDICT_ENV, "1").strip().lower() \
        not in ("0", "false", "off")


def model_cap() -> int:
    try:
        return max(1, int(os.environ.get(CAP_ENV, DEFAULT_CAP)))
    except ValueError:
        return DEFAULT_CAP


def _quantize(f: np.ndarray) -> np.ndarray:
    """Features at float16 resolution (the proximity-digest quantization
    — training and serving must see the same grid)."""
    with np.errstate(over="ignore"):
        return np.asarray(f, np.float64).astype(np.float16) \
            .astype(np.float64)


class _Model:
    """One structure's fitted ridge map feature -> [x; y] (+ the bias
    row), with the bookkeeping refit decisions need."""

    __slots__ = ("W", "n", "m", "trained_on", "feat_dim")

    def __init__(self, W: np.ndarray, n: int, m: int, trained_on: int):
        self.W = W                  # (d+1, n+m)
        self.n = int(n)
        self.m = int(m)
        self.trained_on = int(trained_on)
        self.feat_dim = int(W.shape[0]) - 1


class SeedPredictor:
    """Per-structure ridge models trained from SolutionMemory entries.

    Thread-safe; owned by a :class:`~dervet_tpu.ops.warmstart.
    SolutionMemory` (``memory.predictor``) so invalidation, export, and
    the fleet handoff ride the memory's existing plumbing."""

    def __init__(self, min_entries: int = DEFAULT_MIN_ENTRIES,
                 refit_every: int = DEFAULT_REFIT_EVERY,
                 ridge_lambda: float = RIDGE_LAMBDA,
                 max_models: Optional[int] = None):
        self.min_entries = int(min_entries)
        self.refit_every = int(refit_every)
        self.ridge_lambda = float(ridge_lambda)
        self.max_models = int(max_models) if max_models else model_cap()
        self._lock = threading.Lock()
        self._models: Dict[object, _Model] = {}
        self._lru: List[object] = []
        self.stats = {"fits": 0, "predictions": 0, "abstained": 0,
                      "invalidated": 0, "exported": 0, "imported": 0}

    # -- training -------------------------------------------------------
    def _fit(self, feats: np.ndarray, targets: np.ndarray,
             n: int, m: int) -> _Model:
        N, d = feats.shape
        F = np.concatenate([feats, np.ones((N, 1))], axis=1)
        # normal equations with ridge on the weights (not the bias):
        # feature-sized linear solve, target projection is one matmul
        A = F.T @ F + self.ridge_lambda * np.eye(d + 1)
        A[d, d] -= self.ridge_lambda
        W = np.linalg.solve(A, F.T @ targets)
        return _Model(W, n, m, trained_on=N)

    def maybe_fit(self, skey, entries) -> Optional[_Model]:
        """(Re)fit ``skey``'s model from the memory's live entries when
        it is missing or stale (``refit_every`` stores behind).  Entries
        whose shapes disagree with the majority are skipped (a structure
        key collision must not crash the fit)."""
        if not entries or len(entries) < self.min_entries:
            return self._models.get(skey)
        with self._lock:
            model = self._models.get(skey)
            if model is not None and \
                    len(entries) < model.trained_on + self.refit_every:
                return model
        n, m = entries[-1].x.shape[0], entries[-1].y.shape[0]
        # the reference feature layout is the CURRENT one
        # (warmstart.FEATURE_DIM, lazy import — warmstart imports this
        # module): entries stored under an OLDER feature dimension
        # (fleet imports from a pre-feature-bump replica) are skipped
        # exactly like shape-mismatched iterates, even when such an
        # entry happens to be the newest in the pool — anchoring on
        # entries[-1] would let one old-dim import invert the skip and
        # replace a healthy model with one predict() must then refuse
        from . import warmstart as _ws
        d_ref = _ws.FEATURE_DIM
        feats, targets = [], []
        for e in entries:
            if e.x.shape[0] != n or e.y.shape[0] != m:
                continue
            if np.asarray(e.feature).shape[0] != d_ref:
                continue
            xy = np.concatenate([np.asarray(e.x, np.float64),
                                 np.asarray(e.y, np.float64)])
            if not np.all(np.isfinite(xy)):
                continue
            feats.append(_quantize(e.feature))
            targets.append(xy)
        if len(feats) < self.min_entries:
            return self._models.get(skey)
        model = self._fit(np.stack(feats), np.stack(targets), n, m)
        with self._lock:
            self._models[skey] = model
            if skey in self._lru:
                self._lru.remove(skey)
            self._lru.append(skey)
            self.stats["fits"] += 1
            while len(self._lru) > self.max_models:
                dead = self._lru.pop(0)
                self._models.pop(dead, None)
        return model

    # -- serving --------------------------------------------------------
    def predict(self, skey, feature: np.ndarray
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Predicted UNSCALED ``(x0, y0)`` for one member, or None when
        no (finite) model serves this structure.  The seed flows through
        the same ``init_state`` clipping/projection as any stored seed,
        so an extrapolated prediction is box-safe by construction."""
        with self._lock:
            model = self._models.get(skey)
            if model is None:
                self.stats["abstained"] += 1
                return None
            if skey in self._lru:
                self._lru.remove(skey)
                self._lru.append(skey)
        f = _quantize(feature)
        if f.shape[0] != model.feat_dim:
            return None
        xy = np.concatenate([f, [1.0]]) @ model.W
        if not np.all(np.isfinite(xy)):
            return None
        with self._lock:
            self.stats["predictions"] += 1
        return xy[:model.n], xy[model.n:]

    def has_model(self, skey) -> bool:
        with self._lock:
            return skey in self._models

    def invalidate(self, skey) -> bool:
        """Drop ``skey``'s model — called when the PR-4 certifier rejects
        a solution on this structure: the training set just proved
        untrustworthy there, and the next fit waits for fresh (post-
        invalidation) stores to accumulate."""
        with self._lock:
            hit = self._models.pop(skey, None) is not None
            if skey in self._lru:
                self._lru.remove(skey)
            if hit:
                self.stats["invalidated"] += 1
            return hit

    # -- fleet handoff --------------------------------------------------
    def export_models(self, max_models: int = 16) -> List[Tuple]:
        """Picklable snapshot of the most-recently-used models —
        appended to the warm-start memory export so a failover inheritor
        can predict for structures it never solved."""
        with self._lock:
            keys = self._lru[-int(max_models):]
            out = []
            for k in keys:
                mdl = self._models.get(k)
                if mdl is None:
                    continue
                out.append((k, {"W": np.array(mdl.W), "n": mdl.n,
                                "m": mdl.m,
                                "trained_on": mdl.trained_on}))
            self.stats["exported"] += len(out)
            return out

    def import_models(self, payload) -> int:
        """Install another replica's exported models.  Existing local
        models win (they were trained on locally-verified solves);
        malformed records are skipped, and models fitted under an OLDER
        feature dimension are DROPPED on load (a pre-feature-bump
        replica's model would silently mis-predict against the current
        feature layout — ``predict`` would abstain anyway, so keeping
        them only wastes LRU slots).  Returns the number installed."""
        from . import warmstart as _ws
        n_in = 0
        for k, f in payload or ():
            try:
                W = np.asarray(f["W"], np.float64)
                mdl = _Model(W, int(f["n"]), int(f["m"]),
                             int(f["trained_on"]))
                if W.ndim != 2 or W.shape[1] != mdl.n + mdl.m \
                        or not np.all(np.isfinite(W)):
                    continue
                if mdl.feat_dim != _ws.FEATURE_DIM:
                    continue        # old-dim model: dropped on load
                key = k     # structure keys pickle round-trip as-is
            except (KeyError, TypeError, ValueError, IndexError):
                continue
            with self._lock:
                if key in self._models:
                    continue
                self._models[key] = mdl
                self._lru.append(key)
                self.stats["imported"] += 1
                n_in += 1
                while len(self._lru) > self.max_models:
                    dead = self._lru.pop(0)
                    self._models.pop(dead, None)
        return n_in

    def snapshot(self) -> Dict:
        with self._lock:
            return {"models": len(self._models),
                    "max_models": self.max_models,
                    "min_entries": self.min_entries,
                    **dict(self.stats)}
