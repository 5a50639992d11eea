"""Retail energy time-shift (DER-VET's retailTimeShift tag): the site pays
the tariff's energy price (``billing.energy_price``) for every kWh of its
net load, and a kWh it exports is credited at the same price (DER-VET's
``price x net load`` bill, net metering); the site load's share is a
constant.

Net load, as the program and DER-VET count it: the site load less each
DER's output, a battery's charge counting as load: load - sum over
``lp.power`` of sign x power.  Not in the reference: growth of the
tariff over the years (one optimised year here)."""
import numpy as np

from .. import billing

LOAD = "Site Load (kW)"


def build(lp, keys: dict, ts, case: dict, _req, _start) -> None:
    if keys.get("growth"):
        raise ValueError("retailTimeShift growth is not in the reference")
    price = billing.energy_price(case["tariff"], ts.index)
    for name, sign in lp.power.items():
        lp.cost(name, -sign * price * lp.dt)
    if case["scenario"].get("incl_site_load"):
        lp.const += float(np.sum(price * ts[LOAD].to_numpy()) * lp.dt)
