"""Canonical LP intermediate representation and block builder.

This is the TPU-native replacement for the reference's CVXPY expression-tree
assembly (reference: dervet/MicrogridScenario.py:322-346 builds per-window
CVXPY objectives/constraints from every DER and value stream; we instead have
every component emit *structured blocks* — cost vectors, bound vectors and
sparse constraint rows — into one canonical LP that a batched first-order
solver consumes).

Canonical form::

    minimize    c @ x
    subject to  (K @ x - q)[:n_eq]  == 0        (equality rows first)
                (K @ x - q)[n_eq:]  >= 0        (inequality rows, GE sense)
                l <= x <= u

All rows are stored with GE sense; ``add_rows(..., sense='le')`` negates the
block on entry.  ``q``/``c``/``l``/``u`` may later be swapped per-scenario
(batched) while ``K`` is shared across the batch — the structure of the
dispatch problem is scenario-independent, only prices/loads/bounds vary.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

_INF = np.inf


@dataclasses.dataclass(frozen=True)
class VarRef:
    """A named contiguous slice of the decision vector."""

    name: str
    start: int
    size: int

    @property
    def sl(self) -> slice:
        return slice(self.start, self.start + self.size)


@dataclasses.dataclass
class LP:
    """Assembled canonical LP (numpy / scipy on host; ship to device to solve)."""

    c: np.ndarray            # (n,)
    K: sp.csr_matrix         # (m, n) equality rows first
    q: np.ndarray            # (m,)
    n_eq: int                # rows [0, n_eq) are ==, rest are >=
    l: np.ndarray            # (n,)
    u: np.ndarray            # (n,)
    var_refs: Dict[str, VarRef]
    # name -> list of (start, stop) row ranges; a group name may be used by
    # several add_rows calls, and eq/ge rows are emitted in separate regions
    row_groups: Dict[str, List[Tuple[int, int]]]
    c0: float = 0.0          # constant objective offset (reporting only)
    # label -> (cost vector over x, constant) for per-component objective
    # reporting (reference: objective_values CSV columns, e.g. 'retailETS')
    cost_groups: Dict[str, Tuple[np.ndarray, float]] = dataclasses.field(
        default_factory=dict)
    # (n,) 0/1 integrality marks (scipy.optimize.milp convention) when any
    # variable block was declared binary; None for a pure LP.  The binary
    # on/off formulation solves on the exact CPU MILP backend — the PDHG
    # TPU kernel is continuous-only (SURVEY §7 hard part #5)
    integrality: Optional[np.ndarray] = None
    # structure fingerprint + cached presolve-clamp operators, set by
    # build(): lets ``LPBuilder.build_data`` verify that a sibling
    # sensitivity case shares this LP's constraint matrix byte-for-byte
    # and then assemble only c/q/l/u against the shared K (VERDICT r5 #1
    # — the K assembly is ~2/3 of a window build)
    structure_digest: Optional[bytes] = None
    clamp_pos: Optional[sp.csr_matrix] = None
    clamp_neg: Optional[sp.csr_matrix] = None

    def objective_breakdown(self, x: np.ndarray) -> Dict[str, float]:
        """Per-label objective contributions for a solution vector."""
        return {label: float(vec @ x + const)
                for label, (vec, const) in self.cost_groups.items()}

    @property
    def n(self) -> int:
        return self.c.shape[0]

    @property
    def m(self) -> int:
        return self.q.shape[0]

    def dense_K(self) -> np.ndarray:
        return np.asarray(self.K.todense())

    def value(self, x: np.ndarray, name: str) -> np.ndarray:
        """Extract a named variable block from a solution vector (batched ok)."""
        return x[..., self.var_refs[name].sl]


class LPBuilder:
    """Accumulates variable blocks, bounds, cost terms, and constraint rows.

    Components (DER technologies, value streams, the POI) call:
      * ``var(name, size, lb, ub)``  — register a decision-variable block
      * ``add_cost(ref, vec)``       — add a linear cost on a block
      * ``add_rows(name, terms, sense, rhs)`` — add ``k`` constraint rows where
        each term is ``(ref, coef)`` and ``coef`` is either a scalar, a
        ``(k,)`` diagonal (applied to a size-``k`` block), or a ``(k, ref.size)``
        dense/sparse matrix.
    """

    def __init__(self):
        self._vars: List[VarRef] = []
        self._by_name: Dict[str, VarRef] = {}
        self._lb: Dict[str, np.ndarray] = {}
        self._ub: Dict[str, np.ndarray] = {}
        self._cost: List[Tuple[VarRef, np.ndarray, Optional[str]]] = []
        self._c0 = 0.0
        self._c0_by_label: Dict[str, float] = {}
        # rows split by sense; each entry: (group_name, k, terms, rhs)
        self._eq_rows: List[Tuple[str, int, list, np.ndarray]] = []
        self._ge_rows: List[Tuple[str, int, list, np.ndarray]] = []
        self._n = 0
        self._binary: set = set()

    # ---------------- variables ----------------
    def var(self, name: str, size: int, lb=-_INF, ub=_INF,
            binary: bool = False, integer: bool = False) -> VarRef:
        if name in self._by_name:
            raise ValueError(f"duplicate variable block {name!r}")
        ref = VarRef(name, self._n, size)
        self._vars.append(ref)
        self._by_name[name] = ref
        if binary:
            lb, ub = 0.0, 1.0
        if binary or integer:
            self._binary.add(name)
        self._lb[name] = np.broadcast_to(np.asarray(lb, np.float64), (size,)).copy()
        self._ub[name] = np.broadcast_to(np.asarray(ub, np.float64), (size,)).copy()
        self._n += size
        return ref

    def __getitem__(self, name: str) -> VarRef:
        return self._by_name[name]

    def has(self, name: str) -> bool:
        return name in self._by_name

    def set_bounds(self, ref: VarRef, lb=None, ub=None):
        if ref.name not in self._by_name:
            raise KeyError(f"unknown variable block {ref.name!r}")
        if lb is not None:
            self._lb[ref.name] = np.broadcast_to(
                np.asarray(lb, np.float64), (ref.size,)).copy()
        if ub is not None:
            self._ub[ref.name] = np.broadcast_to(
                np.asarray(ub, np.float64), (ref.size,)).copy()

    # ---------------- objective ----------------
    def add_cost(self, ref: VarRef, vec, label: Optional[str] = None) -> None:
        self._cost.append((ref, np.broadcast_to(
            np.asarray(vec, np.float64), (ref.size,)).copy(), label))

    def add_const_cost(self, val: float, label: Optional[str] = None) -> None:
        self._c0 += float(val)
        if label:
            self._c0_by_label[label] = self._c0_by_label.get(label, 0.0) + float(val)

    # ---------------- constraints ----------------
    def add_rows(self, name: str, terms, sense: str, rhs) -> None:
        """Add ``k`` rows:  sum_j coef_j @ x[ref_j]  (sense)  rhs.

        ``sense`` in {'eq', 'ge', 'le'}.  'le' rows are negated into 'ge'.
        """
        if sense not in ("eq", "ge", "le"):
            raise ValueError(f"bad sense {sense!r}")
        if not terms:
            raise ValueError(f"constraint group {name!r} has no terms")
        norm_terms = []
        k = None
        for ref, coef in terms:
            coef = np.asarray(coef, np.float64) if not sp.issparse(coef) else coef
            if sp.issparse(coef):
                kk = coef.shape[0]
            elif coef.ndim == 2:
                kk = coef.shape[0]
            elif coef.ndim == 1:
                kk = coef.shape[0]
            else:  # scalar => diagonal over the whole block
                kk = ref.size
            if k is None:
                k = kk
            elif k != kk:
                raise ValueError(f"inconsistent row counts in {name}: {k} vs {kk}")
            norm_terms.append((ref, coef))
        rhs = np.broadcast_to(np.asarray(rhs, np.float64), (k,)).copy()
        if sense == "le":
            norm_terms = [(r, -c) for r, c in norm_terms]
            rhs = -rhs
        target = self._eq_rows if sense == "eq" else self._ge_rows
        target.append((name, k, norm_terms, rhs))

    # ---------------- assembly ----------------
    @staticmethod
    def _coef_to_coo(coef, ref: VarRef, row0: int, k: int):
        """Yield (rows, cols, vals) arrays for one term."""
        if sp.issparse(coef):
            coo = coef.tocoo()
            return coo.row + row0, coo.col + ref.start, coo.data
        coef = np.asarray(coef, np.float64)
        if coef.ndim == 2:
            rows, cols = np.nonzero(coef)
            return rows + row0, cols + ref.start, coef[rows, cols]
        if coef.ndim == 1 and ref.size == k:
            idx = np.nonzero(coef)[0]
            return idx + row0, idx + ref.start, coef[idx]
        if coef.ndim == 1:
            raise ValueError("1-D coef requires matching block size")
        # scalar diagonal
        idx = np.arange(ref.size)
        return idx + row0, idx + ref.start, np.full(ref.size, float(coef))

    def _structure_digest(self) -> bytes:
        """Fingerprint of everything that determines K / n_eq / the
        variable layout: var names+sizes+binaries in order, row groups in
        emission order with sense and row counts, and every coefficient's
        exact bytes.  Two builders with equal digests assemble
        byte-identical constraint matrices, so ``build_data`` may reuse a
        template's K.  Bounds, costs, and rhs are deliberately NOT
        covered — they are the per-case data."""
        import hashlib

        h = hashlib.sha256()
        for ref in self._vars:
            h.update(f"v|{ref.name}|{ref.size}|"
                     f"{ref.name in self._binary}|".encode())
        for sense_tag, block_list in (("eq", self._eq_rows),
                                      ("ge", self._ge_rows)):
            for name, k, terms, _rhs in block_list:
                h.update(f"r|{sense_tag}|{name}|{k}|".encode())
                for ref, coef in terms:
                    h.update(f"t|{ref.name}|".encode())
                    if sp.issparse(coef):
                        csr = coef.tocsr()
                        h.update(csr.indptr.tobytes())
                        h.update(csr.indices.tobytes())
                        h.update(csr.data.tobytes())
                    else:
                        a = np.ascontiguousarray(
                            np.asarray(coef, np.float64))
                        h.update(str(a.shape).encode())
                        h.update(a.tobytes())
        return h.digest()

    def _data_vectors(self):
        """(c, cost_groups, c0-map, l, u) — the per-case data that
        ``build`` and ``build_data`` assemble identically."""
        n = self._n
        c = np.zeros(n)
        cost_groups: Dict[str, Tuple[np.ndarray, float]] = {}
        for ref, vec, label in self._cost:
            c[ref.sl] += vec
            if label:
                if label not in cost_groups:
                    cost_groups[label] = (np.zeros(n), 0.0)
                cost_groups[label][0][ref.sl] += vec
        for label, const in self._c0_by_label.items():
            if label not in cost_groups:
                cost_groups[label] = (np.zeros(n), 0.0)
            vec, _ = cost_groups[label]
            cost_groups[label] = (vec, const)
        l = (np.concatenate([self._lb[v.name] for v in self._vars])
             if self._vars else np.zeros(0))
        u = (np.concatenate([self._ub[v.name] for v in self._vars])
             if self._vars else np.zeros(0))
        return c, cost_groups, l, u

    def build_data(self, template: Optional[LP]) -> LP:
        """Assemble an LP that shares ``template``'s constraint matrix,
        computing only the per-case data vectors (c, q, l, u).

        Safe by verification, not assumption: the structure digest covers
        every coefficient byte, so a sensitivity parameter that DOES
        enter K (an rte sweep, a DR event window) mismatches and falls
        back to a full ``build()`` transparently.  With a match, the
        ~2/3 of window-assembly time spent on COO/CSR construction and
        presolve operator extraction is skipped (VERDICT r5 #1)."""
        dig = self._structure_digest()
        if template is None or template.structure_digest != dig \
                or template.n != self._n:
            return self.build(_digest=dig)
        c, cost_groups, l, u = self._data_vectors()
        q_parts = [rhs for block_list in (self._eq_rows, self._ge_rows)
                   for _, _, _, rhs in block_list]
        q = np.concatenate(q_parts) if q_parts else np.zeros(0)
        n_eq = template.n_eq
        if template.m > n_eq and template.clamp_pos is not None:
            act_min = np.asarray(template.clamp_pos @ l
                                 + template.clamp_neg @ u).ravel()
            qi = q[n_eq:]
            with np.errstate(invalid="ignore"):
                q[n_eq:] = np.where(np.isfinite(act_min),
                                    np.maximum(qi, act_min), qi)
        return LP(c=c, K=template.K, q=q, n_eq=n_eq, l=l, u=u,
                  var_refs=template.var_refs,
                  row_groups=template.row_groups, c0=self._c0,
                  cost_groups=cost_groups,
                  integrality=template.integrality,
                  structure_digest=dig, clamp_pos=template.clamp_pos,
                  clamp_neg=template.clamp_neg)

    def build(self, _digest: Optional[bytes] = None) -> LP:
        n = self._n
        c, cost_groups, l, u = self._data_vectors()

        rows_i, cols_i, vals_i = [], [], []
        q_parts, groups = [], {}
        row0 = 0
        for block_list in (self._eq_rows, self._ge_rows):
            for name, k, terms, rhs in block_list:
                for ref, coef in terms:
                    r, cidx, v = self._coef_to_coo(coef, ref, row0, k)
                    rows_i.append(r)
                    cols_i.append(cidx)
                    vals_i.append(v)
                groups.setdefault(name, []).append((row0, row0 + k))
                q_parts.append(rhs)
                row0 += k
            if block_list is self._eq_rows:
                n_eq = row0
        m = row0
        K = sp.coo_matrix(
            (np.concatenate(vals_i) if vals_i else np.zeros(0),
             (np.concatenate(rows_i) if rows_i else np.zeros(0, int),
              np.concatenate(cols_i) if cols_i else np.zeros(0, int))),
            shape=(m, n),
        ).tocsr()
        q = np.concatenate(q_parts) if q_parts else np.zeros(0)
        # Presolve: tighten never-binding inequality rhs to each row's own
        # activity lower bound.  CONTRACT: the clamp is exact for the
        # build-time box [l, u] and for any per-instance bounds INSIDE it
        # (tightening only shrinks row activity ranges); a caller who
        # widens l/u beyond the build-time box at solve time while
        # defaulting q must rebuild the LP instead — the clamped rhs
        # could then bind where the original sentinel never would.
        # Input data carries "no limit" sentinels
        # (the reference datasets use 999999-style placeholders; our
        # requirement fills use 1e30) that an exact simplex ignores but
        # that dominate ||q||_2 and poison the PDHG solver's RELATIVE
        # termination criterion (residual <= eps_rel * ||q||) — a window
        # can then "converge" with kWh-scale physical violations.  For a
        # 'ge' row, min_x K_row @ x over the box [l, u] is
        # sum_j min(K_ij*l_j, K_ij*u_j); if q_i is below that, the row can
        # never bind and raising q_i to the bound is exact.
        clamp_pos = clamp_neg = None
        if m > n_eq:
            Kge = K[n_eq:]
            clamp_pos = Kge.multiply(Kge > 0).tocsr()
            clamp_neg = Kge.multiply(Kge < 0).tocsr()
            act_min = np.asarray(clamp_pos @ l + clamp_neg @ u).ravel()
            qi = q[n_eq:]
            with np.errstate(invalid="ignore"):
                q[n_eq:] = np.where(np.isfinite(act_min),
                                    np.maximum(qi, act_min), qi)
        integrality = None
        if self._binary:
            integrality = np.zeros(n, np.int8)
            for name in self._binary:
                integrality[self._by_name[name].sl] = 1
        return LP(c=c, K=K, q=q, n_eq=n_eq, l=l, u=u,
                  var_refs=dict(self._by_name), row_groups=groups, c0=self._c0,
                  cost_groups=cost_groups, integrality=integrality,
                  structure_digest=(_digest if _digest is not None
                                    else self._structure_digest()),
                  clamp_pos=clamp_pos, clamp_neg=clamp_neg)
