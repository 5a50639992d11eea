"""Value-stream registry (mirrors VS_CLASS_MAP, MicrogridScenario.py:83-98).

Only the streams this package carries are listed.  A tag the JAX package
knows but this one does not yet (retail, programs, reliability) raises
``ModelParameterError`` naming it, instead of being silently skipped."""
from __future__ import annotations

# value-stream tags the reference accepts that are not ported yet
UNPORTED_TAGS = ("retailTimeShift", "DCM", "Backup", "Deferral", "DR", "RA",
                 "User", "Volt", "Reliability")


def registry():
    from .da import DAEnergyTimeShift
    from .markets import (FrequencyRegulation, LoadFollowing,
                          NonspinningReserve, SpinningReserve)
    return {"DA": DAEnergyTimeShift, "FR": FrequencyRegulation,
            "SR": SpinningReserve, "NSR": NonspinningReserve,
            "LF": LoadFollowing}
