"""The billing periods of a retail tariff (DER-VET's ``tariff.csv``) as
hour masks, read from the table as DER-VET's documentation defines its
columns:

* a period applies in the months from ``Start Month`` to ``End Month``,
  both included;
* and in the hours from ``Start Time`` to ``End Time``, both included,
  in hour-ending labels (the step that begins at 00:00 is hour 1), less
  the hours from ``Excluding Start Time`` to ``Excluding End Time``
  where both are given;
* ``Weekday?`` 1 keeps Monday to Friday, 0 Saturday and Sunday, and any
  other value every day;
* ``Charge`` says whether ``Value`` prices energy ($/kWh) or demand
  ($/kW), in any case of letters.
"""
from __future__ import annotations

import numpy as np
import pandas as pd


def _given(v) -> bool:
    return v is not None and not (isinstance(v, float) and np.isnan(v))


def periods(tariff: pd.DataFrame, index: pd.DatetimeIndex, charge: str):
    """[(period id, value, mask over ``index``)] of the tariff's periods
    of kind ``charge`` ("energy" or "demand"), in the table's order."""
    ending = index.hour.to_numpy() + 1
    month = index.month.to_numpy()
    weekday = index.dayofweek.to_numpy() < 5
    out = []
    for pid, row in tariff.iterrows():
        if str(row["Charge"]).strip().lower() != charge:
            continue
        mask = ((month >= row["Start Month"]) & (month <= row["End Month"])
                & (ending >= row["Start Time"]) & (ending <= row["End Time"]))
        x0, x1 = row.get("Excluding Start Time"), row.get("Excluding End Time")
        if _given(x0) and _given(x1):
            mask &= ~((ending >= x0) & (ending <= x1))
        if row["Weekday?"] == 1:
            mask &= weekday
        elif row["Weekday?"] == 0:
            mask &= ~weekday
        out.append((pid, float(row["Value"]), mask))
    return out


def energy_price(tariff: pd.DataFrame, index: pd.DatetimeIndex) -> np.ndarray:
    """$/kWh at each step: the sum of the energy periods that apply."""
    price = np.zeros(len(index))
    for _, value, mask in periods(tariff, index, "energy"):
        price[mask] += value
    return price


def bill(tariff: pd.DataFrame, index: pd.DatetimeIndex, net: np.ndarray,
         dt: float) -> tuple:
    """(energy, demand) charges ($) of one calendar month's net load
    ``net`` (kW at each step of ``index``): energy, the price times each
    step's kWh, an export credited at the same price; demand, each demand
    period's value times the period's highest net load, at least zero."""
    if len(index.to_period("M").unique()) != 1:
        raise ValueError("a bill covers one calendar month")
    net = np.asarray(net, float)
    energy = float(np.sum(energy_price(tariff, index) * net) * dt)
    demand = 0.0
    for _, value, mask in periods(tariff, index, "demand"):
        if mask.any():
            demand += value * max(0.0, float(np.max(net[mask])))
    return energy, demand
