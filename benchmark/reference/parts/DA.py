"""Day-ahead energy time-shift (DER-VET's DA tag): the site pays the DA
price for every kWh it draws from the grid and earns it for every kWh it
exports; the site load's share is a constant."""
import numpy as np

COL = "DA Price ($/kWh)"


def build(lp, keys: dict, ts, case: dict, _req, _start) -> None:
    if keys.get("growth"):
        raise ValueError("DA growth is not in the reference")
    price = ts[COL].to_numpy()
    for name, sign in lp.power.items():
        lp.cost(name, -sign * price * lp.dt)
    if case["scenario"].get("incl_site_load"):
        lp.const += float(np.sum(price * ts["Site Load (kW)"].to_numpy())
                          * lp.dt)
