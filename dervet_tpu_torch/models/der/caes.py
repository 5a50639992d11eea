"""Compressed-air energy storage.

Re-implements dervet/MicrogridDER/CAES.py (SURVEY.md §2.4): storage
physics shared with the battery, plus natural-gas fuel burned on
discharge (``heat_rate_high`` BTU/kWh x monthly gas price).  Sizing is
explicitly disallowed (reference CAES.py:56-65 errors if any rating is 0).
"""
from __future__ import annotations

from typing import Dict

from ...ops.lp import LPBuilder
from ...scenario.window import WindowContext
from ...utils.errors import ParameterError
from .ess import EnergyStorage

GAS_PRICE_COL = "Natural Gas Price ($/MillionBTU)"


class CAES(EnergyStorage):

    def __init__(self, keys: Dict, scenario: Dict, der_id: str = "",
                 datasets=None):
        super().__init__("CAES", der_id, keys, scenario)
        self.heat_rate_high = float(keys.get("heat_rate_high", 0) or 0)
        self.datasets = datasets
        if not (self.ene_max_rated and self.ch_max_rated and self.dis_max_rated):
            raise ParameterError(
                "CAES sizing is not supported: ene/ch/dis ratings must all be "
                "nonzero (reference dervet/MicrogridDER/CAES.py:56-65)")

    def build(self, b: LPBuilder, ctx: WindowContext) -> None:
        super().build(b, ctx)
        price = ctx.monthly_value(GAS_PRICE_COL, default=0.0) or 0.0
        fuel_per_kwh = self.heat_rate_high / 1e6 * price
        if fuel_per_kwh:
            b.add_cost(b[self.vname("dis")],
                       fuel_per_kwh * ctx.dt * ctx.annuity_scalar,
                       label=f"{self.name} fuel_cost")
