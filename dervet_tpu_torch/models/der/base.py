"""DER base class: the component contract for the LP-block architecture.

Replaces the reference's CVXPY-variable DER base
(storagevet.Technology.DistributedEnergyResource.DER surface, SURVEY.md
§2.8): instead of returning CVXPY expression trees from
``initialize_variables``/``constraints``/``objective_function``, each DER
emits named variable blocks, structured constraint rows, and linear cost
vectors into an :class:`~dervet_tpu.ops.lp.LPBuilder`, once per
optimization window.  Dispatch results come back as named slices of the
batched solution tensor.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from ...ops.lp import LPBuilder, VarRef
from ...scenario.window import WindowContext


def integer_size(value: float, upper: float = 0.0) -> float:
    """Snap a solved CONTINUOUS size variable onto the reference's integer
    grid (every reference size var is ``cvx.Variable(integer=True)`` —
    ESSSizing.py:83-138, IntermittentResourceSizing.py:71,
    RotatingGeneratorSizing.py:61).  Ceil preserves feasibility of every
    capacity-type constraint the relaxation satisfied; when a finite user
    upper bound forbids rounding up, fall back to its integer floor —
    exactly the largest value the reference's integer solver could pick.
    The dispatch windows then RE-SOLVE at the snapped ratings (one extra
    batched solve), so reported dispatch is consistent with reported
    sizes (VERDICT r3 #6)."""
    v = float(np.ceil(value - 1e-6))
    if upper and v > upper:
        v = float(np.floor(upper + 1e-9))
    return v


class DER:
    """Base distributed energy resource."""

    technology_type = "DER"

    def __init__(self, tag: str, der_id: str, keys: Dict, scenario: Dict):
        self.tag = tag
        self.id = der_id or ""
        # the reference lowercases DER names in every output column: input
        # name=ES yields 'BATTERY: es ...' in its frozen goldens, name=Battery
        # yields 'BATTERY: battery Discharge (kW)' (test_technology_features)
        self.name = str(keys.get("name", tag)).lower()
        self.dt = float(scenario.get("dt", 1))
        self.keys = keys
        self.scenario = scenario
        # full-year dispatch results, filled by the scenario loop
        self.variables_df: Optional[pd.DataFrame] = None

    # ---------- identity / column naming (matches reference outputs) ----
    @property
    def unique_tech_id(self) -> str:
        return f"{self.tag.upper()}: {self.name}"

    def col(self, quantity: str) -> str:
        """Reference output column name, e.g. 'BATTERY: es Discharge (kW)'."""
        return f"{self.unique_tech_id} {quantity}"

    # ---------- LP assembly --------------------------------------------
    def vname(self, var: str) -> str:
        return f"{self.tag}-{self.id or '1'}/{var}"

    def build(self, b: LPBuilder, ctx: WindowContext) -> None:
        """Register variables/constraints/costs for one window.

        Implementations must create identical *structure* for equal window
        length T (data may differ) so same-length windows share one
        compiled solver and batch onto the TPU together.
        """
        raise NotImplementedError

    # ---------- POI interface ------------------------------------------
    def power_terms(self, b: LPBuilder) -> List[Tuple[VarRef, float]]:
        """Decision-variable contributions to net power at the POI.

        Returns ``(ref, sign)`` pairs; sign +1 injects power to the grid
        (discharge/generation), -1 consumes (charge/load).
        """
        return []

    def fixed_load(self, ctx: WindowContext) -> Optional[np.ndarray]:
        """Constant (non-decision) load profile in kW, or None."""
        return None

    def soe_term(self, b: LPBuilder) -> Optional[VarRef]:
        """State-of-energy block for aggregate energy requirements."""
        return None

    def market_headroom(self, b: LPBuilder, direction: str
                        ) -> Tuple[List[Tuple[VarRef, float]], float]:
        """Available capacity for market services in kW as an affine
        expression ``const + sum(coef * var)``.

        ``direction`` 'up' = extra injection capability (raise discharge /
        cut charge); 'down' = extra absorption.  Default: cannot
        participate (reference: base DER zero-valued up/down schedules,
        SURVEY.md §2.8 ``get_charge_up/down_schedule``).
        """
        return [], 0.0

    # full-horizon report series for the POI totals (post-solve)
    def load_series(self) -> Optional[np.ndarray]:
        """Effective load (kW) this DER contributes, incl. fixed loads."""
        return None

    def generation_series(self) -> Optional[np.ndarray]:
        """Generation (kW) this DER contributes (storage reports separately)."""
        return None

    # ---------- results -------------------------------------------------
    def store_dispatch(self, index: pd.DatetimeIndex, values: Dict[str, np.ndarray]):
        """Stash full-year dispatch arrays (keyed by short var name)."""
        self.variables_df = pd.DataFrame(values, index=index)

    def timeseries_report(self) -> pd.DataFrame:
        idx = self.variables_df.index if self.variables_df is not None else None
        return pd.DataFrame(index=idx)

    def monthly_report(self) -> pd.DataFrame:
        return pd.DataFrame()

    def proforma_report(self, opt_years: List[int],
                        apply_inflation_rate_func=None,
                        fill_forward_func=None) -> Optional[pd.DataFrame]:
        """Per-year cost/benefit rows keyed by pd.Period years (reference:
        DER.proforma_report surface; CAPEX year handled by the CBA)."""
        return None

    def owns_asset(self) -> bool:
        """False when the host pays for output but does not own the asset
        (PV PPA): the CBA then skips MACRS / replacement / decommissioning
        / salvage for this DER."""
        return True

    def proforma_growth_rates(self) -> Dict[str, float]:
        """Escalation rates for this DER's proforma columns in
        fill-forward years (default: flat)."""
        return {}

    def get_capex(self) -> float:
        return 0.0

    def sizing_summary(self) -> Dict:
        return {}

    # ---------- lifecycle (DERExtension surface) -----------------------
    # (reference: dervet/MicrogridDER/DERExtension.py — construction /
    # operation years, failure years, replacement, escalation, ECC, MACRS)
    def _lifecycle_int(self, key: str, default: int = 0) -> int:
        try:
            return int(float(self.keys.get(key, default) or default))
        except (TypeError, ValueError):
            return default

    @property
    def construction_year(self) -> int:
        return self._lifecycle_int("construction_year")

    @property
    def operation_year(self) -> int:
        return self._lifecycle_int("operation_year")

    @property
    def expected_lifetime(self) -> int:
        return self._lifecycle_int("expected_lifetime")

    @property
    def replaceable(self) -> bool:
        return bool(self.keys.get("replaceable", False))

    @property
    def replacement_construction_time(self) -> int:
        return max(self._lifecycle_int("replacement_construction_time", 1), 1)

    @property
    def escalation_rate(self) -> float:
        return float(self.keys.get("ter", 0) or 0) / 100.0

    @property
    def ecc_perc(self) -> float:
        return float(self.keys.get("ecc%", 0) or 0) / 100.0

    def replacement_cost(self) -> float:
        """Cost of replacing this DER (reference: rcost/rcost_kW/rcost_kWh
        dot product, ESSSizing.py:438-444; subclasses refine)."""
        return float(self.keys.get("rcost", 0) or 0)

    def set_failure_years(self, end_year: int,
                          start_year: Optional[int] = None) -> List[int]:
        """Years this equipment fails, incl. periodic replacements
        (reference: DERExtension.set_failure_years, :86-114).  A missing
        operation_year means operation starts at the project start."""
        lifetime = self.expected_lifetime
        if not lifetime:
            self.failure_years: List[int] = []
            self.last_operation_year = end_year
            return self.failure_years
        op = self.operation_year or start_year or end_year
        last = op + lifetime - 1
        years = []
        if last <= end_year:
            years.append(last)
        if self.replaceable:
            # the final replacement's last operating year lands at or past
            # the analysis end (reference DERExtension.py:106-112) — salvage
            # value keys off how far it outlives the project
            nxt = last + lifetime
            while nxt < end_year:
                years.append(nxt)
                nxt += lifetime
            self.last_operation_year = nxt
        else:
            self.last_operation_year = last
        self.failure_years = sorted(set(years))
        return self.failure_years

    def equipment_lifetime_row(self, end_year: int,
                               start_year: Optional[int] = None) -> Dict[str, int]:
        """Rows for the equipment_lifetimes report (golden columns:
        Beginning of Life / Operation Begins / End of Life)."""
        self.set_failure_years(end_year, start_year)
        return {"Beginning of Life": self.construction_year or self.operation_year,
                "Operation Begins": self.operation_year,
                "End of Life": self.last_operation_year}

    def operational(self, year: int) -> bool:
        op_year = self.operation_year
        if op_year and year < op_year:
            return False
        last = getattr(self, "last_operation_year", None)
        if last is not None and not self.replaceable and \
                self.expected_lifetime and year > last:
            return False
        return True

    def being_sized(self) -> bool:
        return False
