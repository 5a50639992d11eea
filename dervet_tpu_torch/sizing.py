"""Grid sizing sweep — now a thin compatibility shim over the design
engine (``dervet_tpu_torch/design``).

The original module enumerated a (power x energy) candidate grid and
batched every candidate's year of dispatch windows into one PDHG call
per window-length group.  That machinery has been promoted into the
BOOST design subsystem — explicit-grid population generation
(``design/population.py``), batched evaluation through the real
``run_dispatch`` pipeline (``design/screen.py``), and a certified
frontier (``design/frontier.py``) — so this function now just drives
the engine in legacy mode: the grid IS the population (deduplicated and
sorted, so duplicate ``(kW, kWh)`` pairs can no longer solve twice or
make the winner tie-dependent on input order), screening runs at FULL
fidelity (the caller's solver options, not the loose ordinal tier —
the legacy contract is that every surface value is a real solve), and
``top_k=1`` certifies the winner, asserting parity with the surface's
own argmin.

Callers that want the modern surface — huge sampled populations, loose
ordinal screening with refinement, a certified top-k frontier — should
use :func:`dervet_tpu_torch.design.run_design` directly.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import pandas as pd

from .io.params import CaseParams
from .ops.pdhg import PDHGOptions
from .utils.errors import ParameterError, TellUser


def sizing_sweep(case: CaseParams, kw_grid: Sequence[float],
                 kwh_grid: Sequence[float], der_tag: str = "Battery",
                 der_id: str = "1", solver_opts: Optional[PDHGOptions] = None,
                 *, backend: str = "torch", device=None) -> pd.DataFrame:
    """Sweep an ESS power/energy grid; dispatch every candidate's year on
    the batch axis.

    Returns a DataFrame with one row per DISTINCT (kW, kWh) candidate
    (duplicates deduplicated, rows sorted by (kW, kWh)):

    * ``operating_value`` — total dispatch objective over the year
      (negative = net benefit), summed across windows
    * ``capex`` — the candidate's capital cost
    * ``total`` — operating_value + capex (rank by this; it is the
      sweep's analogue of the sizing LP's objective)
    * ``converged`` — all of the candidate's windows converged
    * ``lifetime_npv`` — the optimized year's net operating value
      recurring with inflation over the project horizon, discounted,
      less capex

    The grid is dense by construction — callers read the response
    surface, pick a region, and refine with a tighter grid or the exact
    continuous-sizing path.  ``backend``/``device`` choose where the
    grid solves, as for :func:`~dervet_tpu_torch.design.run_design`
    (``device=None`` -> the GPU, raising when none is visible).
    """
    from .design.frontier import run_design
    from .design.population import DERBounds, DesignSpec

    kw_grid = [float(kw) for kw in kw_grid]
    kwh_grid = [float(kwh) for kwh in kwh_grid]
    pairs = sorted({(kw, kwh) for kw in kw_grid for kwh in kwh_grid})
    if not pairs:
        raise ParameterError("sizing_sweep: empty candidate grid")
    if len(pairs) < len(kw_grid) * len(kwh_grid):
        TellUser.warning(
            f"sizing_sweep: candidate grid had duplicate (kW, kWh) "
            f"pairs — deduplicated to {len(pairs)} distinct candidate(s)")
    kws = [p[0] for p in pairs]
    kwhs = [p[1] for p in pairs]
    spec = DesignSpec(
        bounds={(der_tag, der_id): DERBounds(
            kw=(min(kws), max(kws)), kwh=(min(kwhs), max(kwhs)))},
        population=0, grid=pairs, top_k=1, refine_rounds=0)
    # legacy full-fidelity contract: every candidate solves at the
    # caller's tolerances (the ordinal screening tier is opt-in via
    # design.run_design); the engine still batches the whole grid onto
    # the device axis per window-length group
    frontier = run_design(case, spec, backend=backend, device=device,
                          solver_opts=solver_opts,
                          screen_opts_override=solver_opts
                          or PDHGOptions())

    out = frontier.population[
        ["kW", "kWh", "operating_value", "capex", "total", "converged",
         "lifetime_npv"]].copy()
    out = out.sort_values(["kW", "kWh"]).reset_index(drop=True)
    best = out.loc[out[out.converged]["total"].idxmin()] if \
        out.converged.any() else None
    if best is not None:
        TellUser.info(f"sizing_sweep: best candidate {best['kW']:.0f} kW / "
                      f"{best['kWh']:.0f} kWh (total {best['total']:.0f})")
        # parity assertion against the engine's certified winner: the
        # surface's argmin and the certified top-1 must agree (up to a
        # genuine near-tie — the certified re-solve is an independent
        # dispatch of the same LP)
        w = frontier.winner
        if w is not None and np.isfinite(w.get("total", np.nan)):
            same = (float(w["kW"]) == float(best["kW"])
                    and float(w["kWh"]) == float(best["kWh"]))
            scale = max(1.0, abs(float(best["total"])))
            if not same and abs(float(w["total"])
                                - float(best["total"])) / scale > 1e-4:
                TellUser.warning(
                    "sizing_sweep: certified winner "
                    f"({w['kW']:.0f} kW / {w['kWh']:.0f} kWh, total "
                    f"{w['total']:.0f}) disagrees with the surface argmin "
                    "beyond tie tolerance — trust the certified answer")
    return out
