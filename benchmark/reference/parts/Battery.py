"""A battery at fixed ratings (DER-VET's Battery tag): state of energy at
the beginning of each step between llsoc and ulsoc of the rating, entered
and left at the target state of charge, charged at the round-trip
efficiency; variable O&M on discharge."""
import numpy as np
import scipy.sparse as sp

from ..lp import eye

KEYS = {"name", "ch_max_rated", "dis_max_rated", "ene_max_rated", "rte",
        "llsoc", "ulsoc", "soc_target", "OMexpenses", "ccost_kwh", "ccost_kw"}
RESULTS = {"ch": "Charge (kW)", "dis": "Discharge (kW)",
           "ene": "State of Energy (kWh)"}


def build(lp, label: str, keys: dict, ts) -> None:
    extra = {k for k, v in keys.items() if k not in KEYS and v}
    if extra:
        raise ValueError(f"{label}: keys {sorted(extra)} are not in the "
                         "reference")
    T, dt = lp.T, lp.dt
    E = float(keys["ene_max_rated"])
    rte = float(keys.get("rte", 100.0)) / 100.0
    target = float(keys.get("soc_target", 50.0)) / 100.0 * E
    ene = lp.var(f"{label}/ene", T, float(keys.get("llsoc", 0.0)) / 100 * E,
                 float(keys.get("ulsoc", 100.0)) / 100 * E)
    ch = lp.var(f"{label}/ch", T, 0.0, float(keys["ch_max_rated"]))
    dis = lp.var(f"{label}/dis", T, 0.0, float(keys["dis_max_rated"]))
    # ene[0] = target; ene[t] - ene[t-1] - rte dt ch[t-1] + dt dis[t-1] = 0
    shift = sp.eye(T, k=-1, format="csr")
    rhs = np.zeros(T)
    rhs[0] = target
    lp.rows("eq", [(ene, eye(T) - shift), (ch, -rte * dt * shift),
                   (dis, dt * shift)], rhs)
    # the state after the last step returns to the target
    last = sp.csr_matrix(([1.0], ([0], [T - 1])), shape=(1, T))
    lp.rows("eq", [(ene, last), (ch, rte * dt * last), (dis, -dt * last)],
            [target])
    om = float(keys.get("OMexpenses", 0.0)) / 1000.0
    if om:
        lp.cost(dis, om * dt)
    lp.power[ch], lp.power[dis] = -1.0, 1.0
    lp.soe.append(ene)


def mix(keys: dict) -> dict:
    """What an outage walk needs of this battery."""
    E = float(keys["ene_max_rated"])
    return {"ch_max": float(keys["ch_max_rated"]),
            "dis_max": float(keys["dis_max_rated"]),
            "e_min": float(keys.get("llsoc", 0.0)) / 100 * E,
            "e_max": float(keys.get("ulsoc", 100.0)) / 100 * E,
            "rating": E, "rte": float(keys.get("rte", 100.0)) / 100.0}
