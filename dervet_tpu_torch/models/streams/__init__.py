"""Value-stream registry (mirrors VS_CLASS_MAP, MicrogridScenario.py:83-98)."""
from __future__ import annotations


def registry():
    from .da import DAEnergyTimeShift
    from .markets import (FrequencyRegulation, LoadFollowing,
                          NonspinningReserve, SpinningReserve)
    from .programs import (Backup, Deferral, DemandResponse,
                           ResourceAdequacy, UserConstraints, VoltVar)
    from .reliability import Reliability
    from .retail import DemandChargeReduction, EnergyTimeShift
    return {"DA": DAEnergyTimeShift,
            "retailTimeShift": EnergyTimeShift, "DCM": DemandChargeReduction,
            "FR": FrequencyRegulation, "SR": SpinningReserve,
            "NSR": NonspinningReserve, "LF": LoadFollowing,
            "Backup": Backup, "Deferral": Deferral, "DR": DemandResponse,
            "RA": ResourceAdequacy, "User": UserConstraints, "Volt": VoltVar,
            "Reliability": Reliability}
