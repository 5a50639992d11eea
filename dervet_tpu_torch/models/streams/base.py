"""Value-stream contract for the LP-block architecture.

Replaces the reference's storagevet ``ValueStream`` base surface
(SURVEY.md §2.8): each service emits objective cost vectors and
constraint rows into the shared :class:`~dervet_tpu.ops.lp.LPBuilder`,
can post system requirements (min/max energy/power profiles the POI
enforces), and reports its timeseries/proforma contributions afterwards.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from ...ops.lp import LPBuilder
from ...scenario.window import WindowContext


class SystemRequirement:
    """A profile requirement a value stream imposes on the aggregate system
    (reference: storagevet.SystemRequirement.Requirement surface —
    Requirement(kind, sense, source_name, array))."""

    def __init__(self, kind: str, sense: str, source: str, series: pd.Series):
        # import limits are expressed as 'poi export' minima (net export =
        # -import), so a single sign convention reaches the POI
        assert kind in ("energy", "charge", "discharge", "poi export")
        assert sense in ("min", "max")
        self.kind = kind
        self.sense = sense
        self.source = source
        self.series = series  # indexed by timestep

    def window_array(self, index: pd.DatetimeIndex) -> np.ndarray:
        return self.series.reindex(index).to_numpy(dtype=np.float64)


class ValueStream:
    """Base service/value stream."""

    #: fill-forward behavior of this stream's proforma columns: True means
    #: escalate at ``proforma_growth`` (which defaults to the stream's
    #: growth key); False means the value is paid only in optimized years
    fill_forward: bool = True
    #: optional override of the fill-forward escalation rate (fraction/yr);
    #: None means "use the stream's growth key"
    proforma_growth: Optional[float] = None

    def __init__(self, tag: str, keys: Dict, scenario: Dict, datasets):
        self.tag = tag
        self.keys = keys
        self.scenario = scenario
        self.datasets = datasets
        self.name = tag

    # ---------- pre-loop ------------------------------------------------
    def system_requirements(self, ders, years: List[int],
                            index: pd.DatetimeIndex) -> List[SystemRequirement]:
        return []

    # ---------- per-window LP assembly ----------------------------------
    def build(self, b: LPBuilder, ctx: WindowContext, ders) -> None:
        """Add objective terms / variables / constraints for one window."""

    # ---------- results -------------------------------------------------
    def timeseries_report(self, index: pd.DatetimeIndex) -> pd.DataFrame:
        return pd.DataFrame(index=index)

    def monthly_report(self) -> pd.DataFrame:
        return pd.DataFrame()

    def proforma_report(self, opt_years: List[int], poi,
                        results: pd.DataFrame) -> Optional[pd.DataFrame]:
        """Per-year $ rows (positive = benefit), column named after the
        stream; index pd.Period years."""
        return None

    def drill_down_dfs(self, results: pd.DataFrame, dt: float
                       ) -> Dict[str, pd.DataFrame]:
        """Extra output frames (reference: drill-down CSVs, §2.7)."""
        return {}
