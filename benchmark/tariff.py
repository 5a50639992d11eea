"""A configuration's retail tariff, as DER-VET's ``tariff.csv`` holds it:
one row a billing period, indexed by ``Billing Period``, with ``Start
Month``/``End Month`` and ``Start Time``/``End Time`` (hour-ending,
inclusive), ``Excluding Start Time``/``Excluding End Time``, ``Weekday?``
(0 weekends, 1 weekdays, 2 both), ``Value`` and ``Charge`` (energy in
$/kWh, demand in $/kW).

The configuration file holds the table as data (its ``tariff`` rows);
:func:`case_dict` adds it to the case beside the series, and
:func:`case_params` hands it to the program as its ``Datasets.tariff``.
Like ``series.py``, this module imports nothing of the program.
"""
from __future__ import annotations

import pandas as pd

from . import series

NUMERIC = ("Start Month", "End Month", "Start Time", "End Time",
           "Excluding Start Time", "Excluding End Time", "Weekday?", "Value")


def frame(cfg: dict) -> pd.DataFrame:
    """The configuration's tariff rows as ``tariff.csv`` reads: blank
    cells NaN, numbers as floats."""
    df = pd.DataFrame(cfg["tariff"])
    for col in NUMERIC:
        df[col] = pd.to_numeric(df[col], errors="coerce").astype(float)
    return df.set_index("Billing Period")


def case_dict(cfg: dict, seed: int) -> dict:
    """``series.case_dict`` with the tariff beside the series."""
    return dict(series.case_dict(cfg, seed), tariff=frame(cfg))


def case_params(case: dict, case_id: int, CaseParams, Datasets):
    """``series.case_params`` with the case's tariff as the program's
    ``Datasets.tariff``."""
    params = series.case_params(case, case_id, CaseParams, Datasets)
    params.datasets.tariff = case["tariff"].copy()
    return params
