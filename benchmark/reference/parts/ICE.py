"""Internal-combustion engines (DER-VET's ICE tag), n units of one
rating: output from 0 to n x rated; fuel (gal/kWh x $/gal) and variable
O&M per kWh; fixed O&M per kW-year, prorated to the window."""
KEYS = {"name", "rated_capacity", "n", "efficiency", "fuel_cost",
        "variable_om_cost", "fixed_om_cost", "ccost_kW"}
RESULTS = {"elec": "Electric Generation (kW)"}


def rating(keys: dict) -> float:
    return max(int(keys.get("n", 1) or 1), 1) * float(keys["rated_capacity"])


def build(lp, label: str, keys: dict, ts) -> None:
    extra = {k for k, v in keys.items() if k not in KEYS and v}
    if extra:
        raise ValueError(f"{label}: keys {sorted(extra)} are not in the "
                         "reference")
    elec = lp.var(f"{label}/elec", lp.T, 0.0, rating(keys))
    per_kwh = (float(keys.get("variable_om_cost", 0.0))
               + float(keys.get("efficiency", 0.0))
               * float(keys.get("fuel_cost", 0.0)))
    lp.cost(elec, per_kwh * lp.dt)
    lp.const += (float(keys.get("fixed_om_cost", 0.0)) * rating(keys)
                 * lp.T * lp.dt / 8760.0)
    lp.power[elec] = 1.0
