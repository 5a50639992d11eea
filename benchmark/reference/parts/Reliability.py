"""The Reliability stream (DER-VET's Reliability tag, its default
iterative method): an outage of the target length is walked from every
hour with the battery full, and the state of energy the site must hold at
that hour is the swing of the walked state of energy.  The dispatch then
keeps the sum of the storage states of energy at or above it.

The walk is DER-VET's greedy one (Reliability.py simulate_outage): at
each outage hour the critical load, times the load-shed share of that
hour of the outage, less the generators' full rating, is either a surplus
(the battery charges what fits, at the round-trip efficiency) or a
deficit that PV less and then the battery must cover; the load data are
rounded to 5 decimals and the energy and power checks to 2, as DER-VET
rounds them.  The battery's round-trip efficiency is the lowest of the
site's batteries (DER-VET draws one at random)."""
import numpy as np

from .. import lp as reflp

KEYS = {"target", "max_outage_duration", "post_facto_only",
        "post_facto_initial_soc", "n-2", "load_shed_percentage"}
CRIT = "Critical Load (kW)"


def shed_share(case: dict, L: int) -> np.ndarray:
    shed = np.ones(L)
    curve = case.get("load_shed")
    if curve is not None:
        col = [c for c in curve.columns if "load shed" in c.lower()][0]
        data = curve[col].to_numpy(float)
        k = min(L, len(data))
        shed[:k] = data[:k] / 100.0
        shed[k:] = data[-1] / 100.0
    return shed


def horizon(keys: dict, case: dict) -> np.ndarray:
    """The minimum state of energy at every hour of the horizon."""
    extra = {k for k, v in keys.items() if k not in KEYS and v}
    if extra or keys.get("n-2") or keys.get("post_facto_only"):
        raise ValueError(f"Reliability: {sorted(extra)} / n-2 / post-facto "
                         "are not in the reference")
    ts = case["time_series"]
    dt = float(case["scenario"]["dt"])
    crit = ts[CRIT].to_numpy(float)
    T = len(crit)
    gen, pv = 0.0, np.zeros(T)
    ess = []
    for tag, _, k in case["ders"]:
        p = reflp.part(tag)
        if tag in ("ICE", "CHP"):
            gen += p.rating(k)
        elif tag == "PV":
            pv += p.mix(k, ts)
        elif tag == "Battery":
            ess.append(p.mix(k))
    if not ess:
        return None
    e_min = sum(e["e_min"] for e in ess)
    e_max = sum(e["e_max"] for e in ess)
    ch_max = sum(e["ch_max"] for e in ess)
    dis_max = sum(e["dis_max"] for e in ess)
    rte = min(e["rte"] for e in ess)
    init = float(keys.get("post_facto_initial_soc", 100.0)) / 100.0 * sum(
        e["rating"] for e in ess)
    L = int(np.round(float(keys["target"]) / dt)) or 1
    if keys.get("load_shed_percentage"):
        if case.get("load_shed") is None:
            raise ValueError("Reliability: load shedding without a curve")
        shed = shed_share(case, L)
    else:
        shed = np.ones(L)
    soe = np.full(T, init)
    alive = np.ones(T, bool)
    starts = np.arange(T)
    states = [soe.copy()]
    lives = [alive.copy()]
    for j in range(L):
        idx = starts + j
        in_range = idx < T
        idx = np.minimum(idx, T - 1)
        net = crit[idx] * shed[j] - gen
        rc = np.round(net, 5)            # PV counts nothing toward power
        dl = np.round(net - pv[idx], 5)
        charge = np.clip(np.minimum(np.minimum((e_max - soe) / (rte * dt),
                                               -dl), ch_max), 0.0, None)
        soe_surplus = np.where(e_max >= soe, soe + charge * rte * dt, soe)
        discharge = np.minimum(np.minimum((soe - e_min) / dt, dl), dis_max)
        met = np.round(dl - discharge, 2) <= 0.0
        enough = np.round(-soe, 2) <= 0.0   # PV counts nothing toward energy
        surplus = rc <= 0.0
        alive = alive & in_range & (surplus | (enough & met))
        soe = np.where(alive, np.where(surplus, soe_surplus,
                                       soe - discharge * dt), soe)
        states.append(soe.copy())
        lives.append(alive.copy())
    states, lives = np.stack(states, 1), np.stack(lives, 1)
    vals = np.where(lives, states, np.nan)
    return np.nanmax(vals, axis=1) - np.nanmin(vals, axis=1)


def build(lp, keys: dict, ts, case: dict, req, start: int) -> None:
    if req is None or not lp.soe:
        return
    lp.rows("ge", [(b, reflp.eye(lp.T)) for b in lp.soe],
            req[start:start + lp.T])
