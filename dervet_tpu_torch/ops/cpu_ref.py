"""CPU reference LP solver (scipy HiGHS) for cross-validation.

Plays the role the pinned GLPK/ECOS/OSQP stack plays in the reference
(requirements.txt:1-27): an exact simplex/IPM answer to validate the
first-order TPU solver against (acceptance: NPV within 1% — see BASELINE.md).
Also usable as a per-problem fallback backend (``backend='cpu'``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog

from ..utils.errors import TellUser
from .lp import LP


class CPUResult(NamedTuple):
    x: np.ndarray
    obj: float
    status: int       # 0 = optimal
    message: str


def solve_lp_cpu(lp: LP, c=None, q=None, l=None, u=None) -> CPUResult:
    c = lp.c if c is None else np.asarray(c)
    q = lp.q if q is None else np.asarray(q)
    l = lp.l if l is None else np.asarray(l)
    u = lp.u if u is None else np.asarray(u)
    if lp.integrality is not None and lp.integrality.any():
        # relax first: on typical dispatch windows the LP optimum is
        # already binary-repairable (gates cost nothing), so the exact
        # branch-and-bound only runs when the relaxation actually
        # exploited fractional on/off
        relaxed = dataclasses.replace(lp, integrality=None)
        res = solve_lp_cpu(relaxed, c, q, l, u)
        if res.status == 0 and binary_feasible(lp, res.x, q=q):
            return res
        if res.status == 2:
            # relaxation proven infeasible => the MILP is too; don't
            # spend branch-and-bound re-proving it
            return res
        return _solve_milp(lp, c, q, l, u)
    K_eq = lp.K[: lp.n_eq]
    K_ge = lp.K[lp.n_eq:]
    A_ub = (-K_ge).tocsc() if K_ge.shape[0] else None
    b_ub = -q[lp.n_eq:] if K_ge.shape[0] else None
    A_eq = K_eq.tocsc() if lp.n_eq else None
    b_eq = q[: lp.n_eq] if lp.n_eq else None
    res = linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                  bounds=np.stack([l, u], axis=1), method="highs")
    x = res.x if res.x is not None else np.full(lp.n, np.nan)
    return CPUResult(x=x, obj=float(res.fun) if res.fun is not None else np.nan,
                     status=int(res.status), message=str(res.message))


def _solve_milp(lp: LP, c, q, l, u) -> CPUResult:
    """Binary on/off formulation on HiGHS branch-and-bound (the role
    GLPK_MI plays behind CVXPY in the reference, SURVEY §2.9).  The
    1e-4 relative MIP gap matches the dispatch tolerance everywhere else
    (PDHGOptions.eps_rel); a near-optimal incumbent at the time limit is
    accepted with its message (near-symmetric on/off schedules can stall
    branch-and-bound indefinitely otherwise)."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    rhs_ub = np.where(np.arange(lp.m) < lp.n_eq, q, np.inf)
    con = LinearConstraint(lp.K.tocsc(), q, rhs_ub)   # eq: q<=Kx<=q; ge: Kx>=q
    res = milp(c, constraints=con, bounds=Bounds(l, u),
               integrality=lp.integrality,
               options={"mip_rel_gap": 1e-4, "time_limit": 300.0})
    x = res.x if res.x is not None else np.full(lp.n, np.nan)
    ok = res.x is not None and res.status in (0, 1)  # 1 = limit w/ incumbent
    if ok and res.status == 1:
        # incumbent accepted at the time limit: optimality gap unknown —
        # surface it like the PDHG STATUS_INACCURATE path does
        TellUser.warning(
            f"MILP hit its time limit; using the incumbent ({res.message})")
    return CPUResult(x=x, obj=float(res.fun) if res.fun is not None else np.nan,
                     status=0 if ok else int(res.status or 1),
                     message=str(res.message))


def binary_feasible(lp: LP, x: np.ndarray, tol: float = 1e-4,
                    q=None) -> bool:
    """Is a RELAXED solution feasible for the binary problem with some
    0/1 assignment of the gate variables?  Gates carry no objective cost,
    so a feasible gated point keeps the relaxation's objective — i.e. the
    relaxation did not exploit fractional on/off (simultaneous
    charge+discharge, sub-min-power operation).  Greedy minimal repair:
    start with every gate at 0, raise exactly the gates whose violated
    ``ge`` rows can be fixed by a positive gate coefficient (cap rows),
    then re-check; rows only fixable by LOWERING a gate (min-power,
    mutual exclusion) mean the relaxation genuinely cheated -> re-solve
    that window on the exact MILP path.  Gates are raised to 1 only:
    integer unit-commitment counts needing >1 conservatively fall
    through to the MILP."""
    if lp.integrality is None or not lp.integrality.any():
        return True
    q = lp.q if q is None else np.asarray(q, float)
    bmask = lp.integrality.astype(bool)
    bidx = np.nonzero(bmask)[0]
    x = np.asarray(x, float)
    xh = x.copy()
    xh[bidx] = 0.0
    K = lp.K.tocsr()
    absK = K.copy()
    absK.data = np.abs(absK.data)
    scale = 1.0 + np.abs(q) + absK @ np.abs(x)
    # judge the REPAIRED point against the solution's OWN residual, not
    # against zero: the caller already accepted x at the solver's
    # accuracy, so repair only needs to not make any row meaningfully
    # worse.  An absolute test here rejected ~97% of first-order (PDHG)
    # solutions whose eq-rows carry ~1e-3-scale residual noise that gate
    # assignment cannot even touch (gates appear only in ge rows) —
    # every such window then paid an unnecessary exact-MILP re-solve
    # (profiled r4: 1486 of 1536 windows in a 128-case sweep).
    r_x = K @ x - q
    eq_ok_base = np.abs(r_x[: lp.n_eq]) + tol * scale[: lp.n_eq]
    ge_ok_base = np.minimum(r_x[lp.n_eq:], 0.0) - tol * scale[lp.n_eq:]
    Kb = K[:, bidx].tocsr()
    for _ in range(2):
        r = K @ xh - q
        viol_eq = np.abs(r[: lp.n_eq]) > eq_ok_base
        viol_ge = r[lp.n_eq:] < ge_ok_base
        if not viol_eq.any() and not viol_ge.any():
            return True
        if viol_eq.any():
            return False          # gate rows are all inequalities here
        rows = lp.n_eq + np.nonzero(viol_ge)[0]
        sub = Kb[rows]
        raise_cols = np.unique(sub.indices[sub.data > 0])
        newly = raise_cols[xh[bidx[raise_cols]] < 1.0]
        if newly.size == 0:
            return False          # only lowering a gate could fix it
        xh[bidx[newly]] = 1.0
    r = K @ xh - q
    return bool((np.abs(r[: lp.n_eq]) <= eq_ok_base).all()
                and (r[lp.n_eq:] >= ge_ok_base).all())


def solve_lp_cpu_batch(lp: LP, c_b=None, q_b=None, l_b=None, u_b=None):
    """Serial loop over a batch — reference semantics, used only in tests."""
    batched = [arr.shape[0] for arr in (c_b, q_b, l_b, u_b)
               if arr is not None and arr.ndim == 2]
    B = max(batched) if batched else 1

    def pick(arr, i, default):
        if arr is None:
            return default
        return arr[i] if arr.ndim == 2 else arr

    return [solve_lp_cpu(lp,
                         pick(c_b, i, lp.c), pick(q_b, i, lp.q),
                         pick(l_b, i, lp.l), pick(u_b, i, lp.u))
            for i in range(B)]
