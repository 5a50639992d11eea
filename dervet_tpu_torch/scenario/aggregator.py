"""Service aggregator: owns the value streams, collects system requirements.

Re-designs dervet/MicrogridServiceAggregator.py (reference :41-115) +
the storagevet ServiceAggregator surface (SURVEY.md §2.8).
"""
from __future__ import annotations

from typing import Dict, List

import pandas as pd

from ..models.streams.base import SystemRequirement, ValueStream
from ..utils.errors import ParameterError


# the reference counts only the capacity/regulation markets as wholesale
# (MicrogridServiceAggregator.py:73-79); DA energy time-shift is not one
WHOLESALE_TAGS = {"FR", "SR", "NSR", "LF"}


class ServiceAggregator:

    def __init__(self, value_streams: Dict[str, ValueStream]):
        self.value_streams = value_streams
        self.system_requirements: List[SystemRequirement] = []

    def identify_system_requirements(self, der_list, opt_years: List[int],
                                     index: pd.DatetimeIndex
                                     ) -> List[SystemRequirement]:
        self.system_requirements = []
        for vs in self.value_streams.values():
            self.system_requirements.extend(
                vs.system_requirements(der_list, opt_years, index))
        return self.system_requirements

    # predicates (reference: MicrogridServiceAggregator.py:41-115)
    def is_whole_sale_market(self) -> bool:
        return bool(WHOLESALE_TAGS & self.value_streams.keys())

    def is_reliability_only(self) -> bool:
        return set(self.value_streams.keys()) == {"Reliability"}

    def post_facto_reliability_only(self) -> bool:
        rel = self.value_streams.get("Reliability")
        return (self.is_reliability_only() and rel is not None
                and getattr(rel, "post_facto_only", False))

    def post_facto_reliability_only_and_user_defined_constraints(self) -> bool:
        rel = self.value_streams.get("Reliability")
        return (set(self.value_streams.keys()) == {"Reliability", "User"}
                and rel is not None and getattr(rel, "post_facto_only", False))

    def build(self, b, ctx, ders) -> None:
        for vs in self.value_streams.values():
            vs.build(b, ctx, ders)

    def timeseries_report(self, index) -> pd.DataFrame:
        frames = [vs.timeseries_report(index) for vs in self.value_streams.values()]
        frames = [f for f in frames if f is not None and len(f.columns)]
        if not frames:
            return pd.DataFrame(index=index)
        return pd.concat(frames, axis=1)

    def monthly_report(self) -> pd.DataFrame:
        frames = [vs.monthly_report() for vs in self.value_streams.values()]
        frames = [f for f in frames if f is not None and len(f.columns)]
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, axis=1)

    def drill_down_dfs(self, results: pd.DataFrame, dt: float
                       ) -> Dict[str, pd.DataFrame]:
        out: Dict[str, pd.DataFrame] = {}
        for vs in self.value_streams.values():
            fn = getattr(vs, "drill_down_dfs", None)
            if fn is not None:
                out.update(fn(results, dt))
        return out
