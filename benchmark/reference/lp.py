"""The plain reference: one dispatch window of a deployment as an LP,
built from the case's own inputs, solved exactly, and used to judge an
answer of the program.

It is written from DER-VET's published semantics (a battery's state of
energy, PV, rotating generators, CHP heat recovery, the site's thermal
balance, the DA price, the Reliability stream's minimum state of energy)
with NumPy and SciPy: its variables, rows and order are its own, and it
imports nothing of the program.  Each DER or stream is a part of its own
under ``parts/``, found by its tag.  Variables are labelled as the
program's results label them ("Battery-1/ene"), so that an answer can be
read by name.

Every number an answer is judged by is relative:

* ``obj_gap``: |the answer's objective - the exact optimum| over
  max(|optimum|, 1), the objective including the constant terms (the
  site load's energy cost, fixed O&M), as a user reads it;
* ``prim_viol``: the largest violation of a row or a bound, each row's
  over 1 + the sum of |coefficient x value| of its terms + |its
  right-hand side|, each bound's over 1 + |the bound|.
"""
from __future__ import annotations

import importlib

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog


class WindowLP:
    """Variables, costs and rows of one window, assembled in
    :meth:`matrices` into ``min c x + const`` s.t. ``A_eq x = b_eq``,
    ``A_ge x >= b_ge``, ``lb <= x <= ub``."""

    def __init__(self, T: int, dt: float):
        self.T, self.dt = T, dt
        self.blocks: dict = {}          # name -> (start, size)
        self.lb, self.ub, self.c = [], [], []
        self.const = 0.0
        self.eq, self.ge = [], []       # [(terms, rhs)]
        self.power: dict = {}           # name -> +1 export / -1 import
        self.soe: list = []             # state-of-energy blocks
        self.heat: dict = {"steam": [], "hotwater": []}
        self.n = 0

    def var(self, name: str, size: int, lb, ub) -> str:
        self.blocks[name] = (self.n, size)
        self.lb.append(np.broadcast_to(np.asarray(lb, float), (size,)).copy())
        self.ub.append(np.broadcast_to(np.asarray(ub, float), (size,)).copy())
        self.c.append(np.zeros(size))
        self.n += size
        return name

    def cost(self, name: str, vec) -> None:
        i = list(self.blocks).index(name)
        self.c[i] = self.c[i] + np.broadcast_to(np.asarray(vec, float),
                                                self.c[i].shape)

    def rows(self, sense: str, terms, rhs) -> None:
        """``terms``: [(block, (k, size) sparse or dense matrix)]."""
        k = terms[0][1].shape[0]
        rhs = np.broadcast_to(np.asarray(rhs, float), (k,)).copy()
        (self.eq if sense == "eq" else self.ge).append((terms, rhs))

    def matrices(self):
        if getattr(self, "_mats", None) is None:
            A_eq, b_eq = self._stack(self.eq)
            A_ge, b_ge = self._stack(self.ge)
            self._mats = (np.concatenate(self.c), A_eq, b_eq, A_ge, b_ge,
                          np.concatenate(self.lb), np.concatenate(self.ub))
        return self._mats

    def _stack(self, blocks):
        rows, cols, vals, rhs, r0 = [], [], [], [], 0
        for terms, b in blocks:
            for name, coef in terms:
                coo = sp.coo_matrix(coef)
                rows.append(coo.row + r0)
                cols.append(coo.col + self.blocks[name][0])
                vals.append(coo.data)
            rhs.append(b)
            r0 += b.shape[0]
        if not rhs:
            return sp.csr_matrix((0, self.n)), np.zeros(0)
        A = sp.coo_matrix((np.concatenate(vals),
                           (np.concatenate(rows), np.concatenate(cols))),
                          shape=(r0, self.n)).tocsr()
        return A, np.concatenate(rhs)

    def vector(self, named: dict) -> np.ndarray:
        """An answer given by block name as one vector in this layout."""
        x = np.zeros(self.n)
        for name, (s, size) in self.blocks.items():
            x[s:s + size] = np.asarray(named[name], float)
        return x


def eye(T: int):
    return sp.identity(T, format="csr")


def build(case: dict, start: int, T: int, requirements: dict) -> WindowLP:
    """Window [start, start + T) of ``case`` (``series.case_dict``): each
    DER's part, then each stream's, then the site's thermal balance.
    ``requirements`` holds what a stream computes over the whole horizon
    once (the Reliability stream's minimum state of energy)."""
    scen = case["scenario"]
    lp = WindowLP(T, float(scen["dt"]))
    ts = case["time_series"].iloc[start:start + T]
    for tag, der_id, keys in case["ders"]:
        part(tag).build(lp, f"{tag}-{der_id}", keys, ts)
    for tag, keys in case["streams"].items():
        part(tag).build(lp, keys, ts, case, requirements.get(tag), start)
    if scen.get("incl_thermal_load"):
        for kind, col in (("steam", "Site Steam Thermal Load (BTU/hr)"),
                          ("hotwater", "Site Hot Water Thermal Load (BTU/hr)")):
            if col in ts and lp.heat[kind]:
                lp.rows("ge", [(b, eye(T)) for b in lp.heat[kind]],
                        ts[col].to_numpy())
    return lp


def part(tag: str):
    return importlib.import_module(f"{__package__}.parts.{tag}")


def horizon_requirements(case: dict) -> dict:
    """What each stream computes once over the whole horizon."""
    out = {}
    for tag, keys in case["streams"].items():
        fn = getattr(part(tag), "horizon", None)
        if fn is not None:
            out[tag] = fn(keys, case)
    return out


def windows(case: dict) -> list:
    """(start, T) of each monthly window of the case's year (DER-VET's
    ``n = month``)."""
    scen = case["scenario"]
    if scen["n"] != "month":
        raise ValueError(f"window rule n={scen['n']!r} is not in the "
                         "reference")
    idx = case["time_series"].index
    months = idx.month.to_numpy()
    out, s = [], 0
    for m in np.unique(months):
        T = int((months == m).sum())
        out.append((s, T))
        s += T
    return out


def solve(lp: WindowLP, c=None):
    """(optimal objective including the constant, x) with HiGHS."""
    c0, A_eq, b_eq, A_ge, b_ge, lb, ub = lp.matrices()
    c = c0 if c is None else c
    res = linprog(c, A_eq=A_eq if A_eq.shape[0] else None,
                  b_eq=b_eq if A_eq.shape[0] else None,
                  A_ub=-A_ge if A_ge.shape[0] else None,
                  b_ub=-b_ge if A_ge.shape[0] else None,
                  bounds=np.stack([lb, ub], axis=1), method="highs")
    if res.status != 0:
        raise RuntimeError(f"reference LP not solved: {res.message}")
    return float(res.fun) + lp.const, res.x


def judge(lp: WindowLP, x: np.ndarray, best: float, c=None,
          reported=None) -> dict:
    """The numbers an answer ``x`` (this LP's layout) is judged by, against
    the exact optimum ``best``; ``reported``, where the program reports an
    objective of its own, is held to the optimum too."""
    c0, A_eq, b_eq, A_ge, b_ge, lb, ub = lp.matrices()
    c = c0 if c is None else c
    viol = [np.zeros(1)]
    absA = abs(sp.vstack([A_eq, A_ge]).tocsr()) if (A_eq.shape[0]
                                                    + A_ge.shape[0]) else None
    if absA is not None:
        act = absA @ np.abs(x)
        r_eq = np.abs(A_eq @ x - b_eq)
        r_ge = np.maximum(b_ge - A_ge @ x, 0.0)
        r = np.concatenate([r_eq, r_ge])
        viol.append(r / (1.0 + act + np.abs(np.concatenate([b_eq, b_ge]))))
    with np.errstate(invalid="ignore"):
        lo = np.where(np.isfinite(lb), np.maximum(lb - x, 0.0)
                      / (1.0 + np.abs(lb)), 0.0)
        hi = np.where(np.isfinite(ub), np.maximum(x - ub, 0.0)
                      / (1.0 + np.abs(ub)), 0.0)
    viol += [lo, hi]
    scale = max(abs(best), 1.0)
    gaps = [abs(float(c @ x) + lp.const - best) / scale]
    if reported is not None:
        gaps.append(abs(float(reported) - best) / scale)
    bad = ~np.isfinite(x)
    return {"obj_gap": float("inf") if bad.any() else max(gaps),
            "prim_viol": float("inf") if bad.any()
            else float(max(v.max() for v in viol))}
