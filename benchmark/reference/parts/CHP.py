"""Combined heat and power (DER-VET's CHP tag): electric output from 0 to
n x rated, and recovered steam and hot water (BTU/hr) tied to it by the
electric-heat ratio, (steam + hot water) x ratio = electric output; fuel
by heat rate x the monthly gas price (neither is given here, so none)
and variable O&M per kWh."""
from ..lp import eye

KEYS = {"name", "rated_capacity", "n", "electric_heat_ratio", "fuel_cost",
        "variable_om_cost", "ccost_kW"}
RESULTS = {"elec": "Electric Generation (kW)",
           "steam": "Steam Heat Recovered (BTU/hr)",
           "hotwater": "Hot Water Heat Recovered (BTU/hr)"}


def rating(keys: dict) -> float:
    return max(int(keys.get("n", 1) or 1), 1) * float(keys["rated_capacity"])


def build(lp, label: str, keys: dict, ts) -> None:
    # "fuel_cost" is not a CHP input of DER-VET's (its fuel is priced by
    # heat rate and the gas price): listed, and unused
    extra = {k for k, v in keys.items() if k not in KEYS and v}
    if extra:
        raise ValueError(f"{label}: keys {sorted(extra)} are not in the "
                         "reference")
    T = lp.T
    elec = lp.var(f"{label}/elec", T, 0.0, rating(keys))
    steam = lp.var(f"{label}/steam", T, 0.0, float("inf"))
    hot = lp.var(f"{label}/hotwater", T, 0.0, float("inf"))
    lp.cost(elec, float(keys.get("variable_om_cost", 0.0)) * lp.dt)
    r = float(keys["electric_heat_ratio"])
    lp.rows("eq", [(steam, r * eye(T)), (hot, r * eye(T)), (elec, -eye(T))],
            0.0)
    lp.heat["steam"].append(steam)
    lp.heat["hotwater"].append(hot)
    lp.power[elec] = 1.0
