"""Demand charge management (DER-VET's DCM tag): for every calendar month
and demand billing period of the tariff with hours in the window, the
site pays the period's $/kW value times the month's highest net load
over the period's hours (``billing.periods``).

One peak variable ``d`` a (month, period), ``d >= net load(t)`` at each
of the period's hours in the window and ``d >= 0``, the value times ``d``
in the objective.  Net load follows the program's sign convention: the
site load less each DER's output, a battery's charge counting as load
(load - sum over ``lp.power`` of sign x power).

Where this departs from DER-VET's CVXPY formulation, which bills
``value x cvx.max(net load over the period's hours)`` a month:

* the maximum is an epigraph variable and its rows, the same optimum;
* the peak is floored at zero (the program's ``d >= 0``, and the floor
  its bill takes), where CVXPY's maximum of an exporting month could go
  below it;
* a window bills only its own hours of a month (a month split across
  windows is billed once in each); with ``n = month`` each window is one
  calendar month;
* no growth of the charges over the years (one optimised year here)."""
import numpy as np
import scipy.sparse as sp

from .. import billing

LOAD = "Site Load (kW)"


def build(lp, keys: dict, ts, case: dict, _req, _start) -> None:
    if keys.get("growth"):
        raise ValueError("DCM growth is not in the reference")
    T = lp.T
    load = (ts[LOAD].to_numpy(float) if case["scenario"].get("incl_site_load")
            else np.zeros(T))
    months = ts.index.to_period("M")
    lp.peaks = getattr(lp, "peaks", {})
    for month in months.unique():
        in_month = np.asarray(months == month)
        for pid, value, mask in billing.periods(case["tariff"], ts.index,
                                                "demand"):
            hours = np.flatnonzero(in_month & mask)
            if not len(hours):
                continue
            k = len(hours)
            d = lp.var(f"DCM/{month}/{pid}", 1, 0.0, float("inf"))
            pick = sp.csr_matrix((np.ones(k), (np.arange(k), hours)),
                                 shape=(k, T))
            # d + sum(sign x power(t)) >= load(t) at each of the hours
            lp.rows("ge", [(d, np.ones((k, 1)))]
                    + [(name, sign * pick) for name, sign in lp.power.items()],
                    load[hours])
            lp.cost(d, value)
            lp.peaks[d] = (hours, load[hours])


def complete(lp, named: dict) -> None:
    """Add to an answer given by its DERs' variables (``named``) the peak
    its dispatch bills: each period's highest net load, at least zero."""
    for d, (hours, load) in getattr(lp, "peaks", {}).items():
        out = sum(sign * np.asarray(named[name], float)[hours]
                  for name, sign in lp.power.items())
        named[d] = np.array([max(0.0, float(np.max(load - out)))])
