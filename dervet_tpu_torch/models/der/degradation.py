"""Battery cycle-degradation: rainflow counting + damage accumulation.

Re-implements the behavior of the storagevet battery degradation module
(SURVEY.md §2.8 BatteryTech surface: ``incl_cycle_degrade``,
``degrade_data``, ``degrade_perc``, ``degraded_energy_capacity()``,
``calc_degradation``; driven from dervet/MicrogridDER/Battery.py:69-179):

* rainflow cycle counting (ASTM E1049 half/full-cycle rules) on the
  normalized state-of-charge profile of each optimization window — the
  reference depends on the ``rainflow`` package (requirements.txt:21,
  hooks/hook-rainflow.py)
* each counted cycle of depth d contributes ``count / N(d)`` of life,
  where N(d) is the 'Cycle Life Value' for the smallest 'Cycle Depth
  Upper Limit' >= d in the battery's cycle-life table
  (data/battery_cycle_life.csv format)
* calendar fade adds ``yearly_degrade`` percent per year, pro-rated by
  window length
* when remaining capacity falls to ``state_of_health`` x nameplate the
  system is replaced (degradation resets) if ``replaceable``, and the
  year is recorded for the financial layer's failure-year machinery
  (reference Battery.py:87-110).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import pandas as pd


def turning_points(x: np.ndarray) -> np.ndarray:
    """Strip monotone runs and plateaus to local extrema (keep endpoints)."""
    x = np.asarray(x, np.float64)
    # collapse repeated values first so plateaus cannot mask extrema
    x = x[np.concatenate([[True], np.diff(x) != 0])]
    if len(x) < 3:
        return x
    d = np.diff(x)
    keep = np.ones(len(x), bool)
    keep[1:-1] = d[:-1] * d[1:] < 0
    return x[keep]


def rainflow(x: np.ndarray) -> List[Tuple[float, float]]:
    """ASTM E1049 rainflow counting.

    Returns ``(range, count)`` pairs with count 1.0 for full cycles and
    0.5 for residual half cycles.
    """
    pts = list(turning_points(np.asarray(x, np.float64)))
    stack: List[float] = []
    out: List[Tuple[float, float]] = []
    for p in pts:
        stack.append(p)
        while len(stack) >= 3:
            X = abs(stack[-2] - stack[-1])
            Y = abs(stack[-3] - stack[-2])
            if X < Y:
                break
            if len(stack) == 3:
                # half cycle on the leading residue
                out.append((Y, 0.5))
                stack.pop(0)
            else:
                out.append((Y, 1.0))
                last = stack.pop()
                stack.pop()
                stack.pop()
                stack.append(last)
    for i in range(len(stack) - 1):
        out.append((abs(stack[i] - stack[i + 1]), 0.5))
    return [(r, c) for r, c in out if r > 0]


class CycleDegradation:
    """Depth-binned cycle-life damage model."""

    def __init__(self, cycle_life: pd.DataFrame):
        cols = {str(c).strip().lower(): c for c in cycle_life.columns}
        depth_col = next(c for k, c in cols.items() if "depth" in k)
        life_col = next(c for k, c in cols.items() if "life" in k)
        df = cycle_life.sort_values(depth_col)
        self.depths = df[depth_col].to_numpy(np.float64)
        self.lives = df[life_col].to_numpy(np.float64)

    def life_at(self, depth: float) -> float:
        """Cycle life at a given depth-of-cycle fraction: smallest upper
        limit bin containing the depth (last bin for deeper cycles)."""
        i = int(np.searchsorted(self.depths, depth, side="left"))
        i = min(i, len(self.lives) - 1)
        return float(self.lives[i])

    def damage(self, soc_profile: np.ndarray) -> float:
        """Fractional life consumed by one window's normalized SOC profile."""
        total = 0.0
        for rng, count in rainflow(soc_profile):
            life = self.life_at(rng)
            if life > 0:
                total += count / life
        return total
