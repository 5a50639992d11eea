"""Reliability (islanding/resilience) value stream.

Re-implements dervet/MicrogridValueStreams/Reliability.py (SURVEY.md §2.5)
on the run's device.  The reference simulates an outage starting at EVERY
timestep with a recursive per-step Python walk (`simulate_outage`,
Reliability.py:489-570, called in a while loop at :876-966 — its own log
says "This may take a while").  Here the same greedy SOE walk is a loop
over the L outage steps with all T starts as one float32 tensor on the
device the dispatch runs on (the GPU under ``backend="torch"``, the CPU
under ``backend="cpu"``): a few dozen element-wise launches a step.

Numeric semantics preserved from the reference:
* ``data_process`` rounding to 5 decimals (Reliability.py:466-470)
* the 2-decimal feasibility checks inside the walk (:548,:554)
* rolling-forward energy requirement (:120-122, :356-373)
* LCPC probability accounting incl. end-of-horizon truncation (:915-955)
* min-SOE schedule = per-start effective SOE swing of a target-length
  outage from the initial SOC (:685-732) -> 'energy'/'min' requirement

Documented divergence: the reference draws a RANDOM round-trip efficiency
per charge step from the ESS rte list (:532 ``random.choice``); we use the
worst (lowest) rte deterministically — reproducible and conservative.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
import scipy.sparse as sp
import torch

from ...device import resolve_device
from ...ops.lp import LPBuilder
from ...telemetry import trace as telemetry_trace
from ...scenario.window import WindowContext, grab_column
from ...utils.errors import TellUser, TimeseriesDataError
from .base import SystemRequirement, ValueStream

CRIT_COL = "Critical Load (kW)"


def rolling_forward_sum(arr: np.ndarray, window: int) -> np.ndarray:
    """Sum of the next ``window`` values at each index (fewer at the end) —
    reference ``rolling_sum`` on the reversed series (Reliability.py:356-373).
    """
    s = pd.Series(arr[::-1]).rolling(window, min_periods=1).sum()
    return s.to_numpy()[::-1]


# ---------------------------------------------------------------------------
# vectorized outage walk
# ---------------------------------------------------------------------------

# The JAX package's walks are the reference, and XLA compiles them with
# two rewrites that change float32 results: a division by a constant
# becomes a product with the constant's float32 reciprocal (so rounding
# to 5 and 2 decimals is ``round(x * 1e5) * 1e-5`` and ``round(x * 100) *
# 0.01``), and on the CPU a product feeding one sum is fused into one
# multiply-add, rounded once.  The port does the same, the fused ones as
# an exact float64 product and sum rounded once to float32, so the two
# walks give the same bits.
def _round5(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x * 1e5) * 1e-5


def _round2(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x * 100.0) * 0.01


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32 (the product of two float32
    values is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _f32(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _side_stream(device):
    """A CUDA stream of its own for one walk, so that the walk neither
    waits behind nor holds up the solves queued on the default stream
    (the post-processing pool runs walks while solves are in flight);
    a ``.cpu()`` of the result then waits for this stream alone."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device))


def simulate_all_outages(crit, gen, pv_max, pv_vari, gamma: float, shed,
                         init_soe, ch_max: float, dis_max: float,
                         e_min: float, e_max: float, rte: float, dt: float,
                         L: int, device=None):
    """Greedy SOE walk for an outage starting at every timestep.

    Inputs are full-horizon (T,) arrays plus a per-OUTAGE-STEP load-shed
    factor ``shed`` of length L (fraction of critical load that must be
    served at outage hour j — reference data_process applies the shed
    curve by outage step, Reliability.py:471-485).  Returns ``(coverage,
    profiles)`` as tensors on ``device`` where ``coverage[i]`` counts
    survived steps (capped by horizon end) and ``profiles[i, j]`` is the
    SOE after step j of the outage starting at i (0 once dead).  Mirrors
    Reliability.py:489-570 incl. the 5-decimal data rounding and 2-decimal
    feasibility checks.  Everything runs in float32, the scalars too, in
    the JAX package's order of operations (its walk takes them as traced
    float32 arguments), so both answer alike to the bit.
    """
    dev = resolve_device(device)
    crit, gen, pv_max, pv_vari, shed, soe = (
        _f32(a, dev) for a in (crit, gen, pv_max, pv_vari, shed, init_soe))
    gamma, ch_max, dis_max, e_min, e_max, rte, dt = (
        _f32(v, dev) for v in (gamma, ch_max, dis_max, e_min, e_max, rte,
                               dt))
    T = crit.shape[0]
    starts = torch.arange(T, device=dev)
    alive = torch.ones(T, dtype=torch.bool, device=dev)
    alive_steps, profiles = [], []
    for j in range(L):
        idx = starts + j
        in_range = idx < T
        idxc = torch.clamp(idx, max=T - 1)
        net = _fma(crit[idxc], shed[j], -gen[idxc])   # load - generation
        rc = _round5(net - pv_vari[idxc])
        dl = _round5(net - pv_max[idxc])
        ec = rc * gamma

        # surplus branch: generation covers the load; charge what fits
        can_store = e_max >= soe
        charge_possible = (e_max - soe) / (rte * dt)
        charge = torch.minimum(torch.minimum(charge_possible, -dl), ch_max)
        charge = torch.clamp(charge, min=0.0)
        soe_surplus = torch.where(can_store, _fma(charge * rte, dt, soe),
                                  soe)

        # deficit branch: need the ESS; check energy then discharge
        enough_energy = _round2(_fma(ec, dt, -soe)) <= 0.0
        discharge_possible = (soe - e_min) / dt
        discharge = torch.minimum(torch.minimum(discharge_possible, dl),
                                  dis_max)
        met = _round2(dl - discharge) <= 0.0
        soe_deficit = _fma(-discharge, dt, soe)
        deficit_ok = enough_energy & met

        surplus = rc <= 0.0
        alive = alive & in_range & (surplus | deficit_ok)
        new_soe = torch.where(surplus, soe_surplus, soe_deficit)
        soe = torch.where(alive, new_soe, soe)
        alive_steps.append(alive)
        profiles.append(soe)
    alive_steps = torch.stack(alive_steps)
    coverage = alive_steps.sum(dim=0)
    profiles = torch.where(alive_steps, torch.stack(profiles), 0.0)
    return coverage, profiles.T


def min_soe_required(crit, gen, pv_max, pv_vari, gamma: float, shed,
                     ch_max: float, dis_max: float, e_min: float,
                     e_max: float, rte: float, dt: float, L: int,
                     device=None) -> torch.Tensor:
    """EXACT minimal initial SOE per outage start (batched backward
    recursion), a float32 (T,) tensor on ``device``.

    Equivalent of the reference's exact ``min_soe_opt``
    (Reliability.py:572-683): that MILP is separable per outage start —
    each start's sub-problem shares no variables with the others — and for
    the aggregate single-state ESS model the per-start optimum has a
    closed-form backward recursion: walking outage steps last-to-first,
    ``m[j]`` is the least SOE at step j from which steps j..L-1 are
    survivable.  Deficit steps must discharge the full net load (so
    ``m[j] = max(e_min + dl*dt, ec*dt, m[j+1] + dl*dt)``, infeasible when
    ``dl`` exceeds the discharge rating); surplus steps may charge up to
    ``min(-dl, ch_max)`` (so ``m[j] = max(e_min, m[j+1] - charge)``,
    infeasible when ``m[j+1]`` exceeds the energy cap).  One loop over L
    steps evaluates every start at once.  Data rounding matches the
    forward walk (5 decimals); the walk's 2-decimal feasibility slack is
    granted on the discharge-rating check, and the remaining thresholds
    are exact — i.e. the schedule is conservative relative to the
    simulator by at most 0.005 kW/kWh per step, never optimistic.  The
    scalars stay Python floats, each sum of two of them taken in double
    before it meets a float32 tensor, as in the JAX package's recursion.
    That one is compiled with the scalars as constants and XLA folds
    their products: ``rte * dt`` here too, but where dt is not 1 also
    ``1e-5 * dt`` and ``1e-5 * gamma * dt`` into the rounded data, so
    there the two agree to float32 rounding rather than to the bit.
    """
    dev = resolve_device(device)
    crit, gen, pv_max, pv_vari, shed = (
        _f32(a, dev) for a in (crit, gen, pv_max, pv_vari, shed))
    rte_dt = _f32(rte, dev) * _f32(dt, dev)     # folded in float32
    T = crit.shape[0]
    starts = torch.arange(T, device=dev)
    m = torch.full((T,), float(e_min), dtype=torch.float32, device=dev)
    for j in range(L - 1, -1, -1):
        idx = starts + j
        in_range = idx < T
        idxc = torch.clamp(idx, max=T - 1)
        net = _fma(crit[idxc], shed[j], -gen[idxc])   # load - generation
        rc = _round5(net - pv_vari[idxc])
        dl = _round5(net - pv_max[idxc])
        ec = rc * gamma
        # deficit: the ESS must discharge the full net load dl.  The
        # forward walk accepts a shortfall that rounds to zero at two
        # decimals (met/enough_energy checks) — grant the same 0.005
        # slack here so borderline starts the simulation survives are not
        # declared uncoverable (the recursion stays conservative by at
        # most that slack per step elsewhere)
        feas = dl <= dis_max + 5e-3
        m_deficit = torch.maximum(torch.maximum(e_min + dl * dt, ec * dt),
                                  m + dl * dt)
        m_deficit = torch.where(feas, m_deficit, torch.inf)
        # surplus: optional charging helps reach the NEXT requirement
        chg = torch.clamp(torch.clamp(-dl, max=ch_max), min=0.0)
        m_surplus = torch.clamp(_fma(-chg, rte_dt, m), min=e_min)
        m_surplus = torch.where(m <= e_max + 1e-9, m_surplus, torch.inf)
        m = torch.where(rc <= 0.0, m_surplus, m_deficit)
        # outage truncated at the horizon end: no requirement beyond it
        m = torch.where(in_range, m, e_min)
    return m


class Reliability(ValueStream):
    """Microgrid islanding reliability (dervet Reliability tag)."""

    def __init__(self, keys, scenario, datasets, load_shed_data=None):
        super().__init__("Reliability", keys, scenario, datasets)
        g = lambda k, d=0.0: float(keys.get(k, d) or 0.0)
        self.outage_duration = g("target")            # hours to cover
        self.dt = float(scenario.get("dt", 1))
        self.post_facto_only = bool(keys.get("post_facto_only", False))
        self.soc_init = g("post_facto_initial_soc", 100.0) / 100.0
        self.max_outage_duration = g("max_outage_duration",
                                     self.outage_duration or 1)
        self.n_2 = bool(keys.get("n-2", False))
        # exact per-start minimal-SOE schedule (the reference's min_soe_opt
        # exact mode, Reliability.py:572-683 — commented out of its own
        # default path at :215-217); opt-in extension key, default keeps
        # the reference's default iterative method
        self.min_soe_exact = bool(keys.get("min_soe_exact", False))
        self.load_shed = bool(keys.get("load_shed_percentage", False))
        self.load_shed_data: Optional[np.ndarray] = None
        if self.load_shed:
            if load_shed_data is None:
                load_shed_data = getattr(datasets, "load_shed", None)
            if load_shed_data is None:
                raise TimeseriesDataError(
                    "load_shed_percentage requires load_shed_perc_filename")
            col = [c for c in load_shed_data.columns
                   if "load shed" in c.lower()]
            self.load_shed_data = load_shed_data[col[0]].to_numpy(np.float64)
        ts = datasets.time_series
        if ts is None or grab_column(ts, CRIT_COL) is None:
            raise TimeseriesDataError(
                f"Reliability requires a {CRIT_COL!r} column")
        self.critical_load: Optional[pd.Series] = None
        self.requirement: Optional[np.ndarray] = None
        self.min_soe_df: Optional[pd.DataFrame] = None
        self.soe_profiles: Optional[pd.DataFrame] = None
        self.outage_contribution_df: Optional[pd.DataFrame] = None
        self.outage_soe_profile: Optional[pd.DataFrame] = None
        self.dg_rating = 0.0                          # n-2 reserve margin
        self.use_sizing_module_results = False
        # where the outage walks run: the run's dispatch device, set by
        # the scenario before its first walk (None -> the first GPU)
        self.device = None

    # ------------------------------------------------------------------
    def _prepare(self, index: pd.DatetimeIndex) -> None:
        ts = self.datasets.time_series.loc[index]
        self.critical_load = pd.Series(grab_column(ts, CRIT_COL), index=index)
        cov = int(np.round(self.outage_duration / self.dt)) or 1
        self.coverage_steps = cov
        self.requirement = rolling_forward_sum(
            self.critical_load.to_numpy(), cov) * self.dt

    # ------------------------------------------------------------------
    def _der_mix(self, ders) -> Dict:
        """Aggregate DER properties for the outage walk (reference
        ``get_der_mix_properties``, Reliability.py:276-332)."""
        props = {"charge max": 0.0, "discharge max": 0.0, "soe min": 0.0,
                 "soe max": 0.0, "energy rating": 0.0, "rte": 1.0,
                 "rte list": []}
        T = len(self.critical_load)
        pv_max = np.zeros(T)
        pv_vari = np.zeros(T)
        largest_gamma = 0.0
        dg_max = 0.0
        for d in ders:
            ttype = d.technology_type
            if ttype == "Intermittent Resource":
                gen = d.maximum_generation_series(self.critical_load.index)
                pv_max += gen
                pv_vari += gen * getattr(d, "nu", 1.0)
                largest_gamma = max(largest_gamma, getattr(d, "gamma", 1.0))
            elif ttype == "Generator":
                rating = getattr(d, "max_power_out", 0.0)
                dg_max += rating
                # n-2: hold the LARGEST single unit out of the walk
                # (reference Reliability.py:328-330 dg_rating margin)
                self.dg_rating = max(self.dg_rating, rating)
            elif ttype == "Energy Storage System":
                props["rte list"].append(d.rte)
                props["soe min"] += d.operational_min_energy()
                props["soe max"] += d.operational_max_energy()
                props["charge max"] += d.charge_capacity()
                props["discharge max"] += d.discharge_capacity()
                props["energy rating"] += d.energy_capacity()
        if self.n_2:
            dg_max -= self.dg_rating
        if props["rte list"]:
            # deterministic worst-rte (divergence from random.choice, see
            # module docstring)
            props["rte"] = float(min(props["rte list"]))
        gen = np.full(T, dg_max)
        return {"props": props, "gen": gen, "pv_max": pv_max,
                "pv_vari": pv_vari, "gamma": largest_gamma}

    def _shed_curve(self, L: int) -> np.ndarray:
        """Per-outage-step fraction of critical load to serve (reference:
        load_shed_data applies by outage step, Reliability.py:471-485)."""
        shed = np.ones(L)
        if self.load_shed and self.load_shed_data is not None:
            k = min(L, len(self.load_shed_data))
            shed[:k] = self.load_shed_data[:k] / 100.0
            if k < L:
                shed[k:] = self.load_shed_data[-1] / 100.0
        return shed

    def _walk(self, mix, init_soe: np.ndarray, L: int, stage: str):
        """Every outage start's walk of ``L`` steps, as one
        ``outage_walk`` phase; ``stage`` names the caller (``sizing``,
        ``requirements`` or ``coverage``)."""
        p = mix["props"]
        dev = resolve_device(self.device)
        with telemetry_trace.phase("outage_walk", "outage_walk_s",
                                   stage=stage, L=int(L),
                                   starts=len(init_soe)), \
                _side_stream(dev):
            cov, prof = simulate_all_outages(
                self.critical_load.to_numpy(), mix["gen"], mix["pv_max"],
                mix["pv_vari"], mix["gamma"], self._shed_curve(L), init_soe,
                p["charge max"], p["discharge max"], p["soe min"],
                p["soe max"], p["rte"], self.dt, L, device=dev)
            return cov.cpu().numpy(), prof.cpu().numpy()

    # ------------------------------------------------------------------
    # reliability-driven sizing (reference Reliability.py:153-274):
    # iterate {min-capex LP covering candidate outages} -> {vectorized
    # walk to find the first uncovered start} until everything is covered.
    # The reference's GLPK_MI integer sizing relaxes to a continuous LP
    # (SURVEY §7); its recursive 500-at-a-time uncovered search becomes
    # one batched walk over every start.
    # ------------------------------------------------------------------
    def sizing_module(self, ders, index: pd.DatetimeIndex,
                      max_rounds: int = 40):
        self._prepare(index)
        from ...ops import cpu_ref
        T = len(index)
        L = self.coverage_steps
        candidates = [int(i) for i in np.argsort(-self.requirement)[:10]]
        sizes = {}
        for round_no in range(max_rounds):
            sizes = self._size_for_outages(ders, index, candidates)
            self._apply_sizes(ders, sizes, freeze=False)
            mix = self._der_mix(ders)
            p = mix["props"]
            init = np.full(T, self.soc_init * p["energy rating"])
            cov, _ = self._walk(mix, init, L, "sizing")
            cov = np.minimum(cov, T - np.arange(T))
            uncovered = np.nonzero((cov < L) & (cov < (T - np.arange(T))))[0]
            if not len(uncovered):
                TellUser.info(f"reliability sizing converged after "
                              f"{round_no + 1} round(s): "
                              f"{ {k: round(v, 1) for k, v in sizes.items()} }")
                break
            first = int(uncovered[0])
            if first in candidates:
                TellUser.warning("reliability sizing: first uncovered outage "
                                 f"at {first} already constrained; stopping")
                break
            candidates.append(first)
        self._apply_sizes(ders, sizes, freeze=True)
        self.use_sizing_module_results = True
        self.min_soe_schedule(ders, index)
        return ders

    @staticmethod
    def _apply_sizes(ders, sizes: Dict[str, float], freeze: bool) -> None:
        """Push solved sizes onto the DERs.  During the iteration the
        ratings update but the sizing FLAGS stay on (the next round's LP
        must keep them variable); only the final call freezes via
        set_size."""
        for d in ders:
            der_sizes = {k.split("/")[-1]: v for k, v in sizes.items()
                         if k.startswith(f"{d.tag}-{d.id or '1'}/")}
            if not der_sizes:
                continue
            if freeze:
                d.set_size(der_sizes)
                continue
            if "size_ene" in der_sizes:
                d.ene_max_rated = der_sizes["size_ene"]
            if "size_dis" in der_sizes:
                d.dis_max_rated = der_sizes["size_dis"]
                if getattr(d, "sizing_ch", False):
                    d.ch_max_rated = der_sizes["size_dis"]
            if "size" in der_sizes:
                if hasattr(d, "rated_power"):
                    d.rated_power = der_sizes["size"]
                else:
                    d.rated_capacity = der_sizes["size"]

    def _size_for_outages(self, ders, index: pd.DatetimeIndex,
                          starts: List[int]) -> Dict[str, float]:
        """Min-capex LP: chosen sizes must cover every candidate outage
        window (reference size_for_outages, Reliability.py:221-274)."""
        from ...ops.lp import LPBuilder
        from ...ops import cpu_ref
        b = LPBuilder()
        T = len(index)
        L = self.coverage_steps
        dt = self.dt
        crit_full = self.critical_load.to_numpy()

        ess = [d for d in ders
               if d.technology_type == "Energy Storage System"]
        pvs = [d for d in ders if d.technology_type == "Intermittent Resource"]
        gens = [d for d in ders if d.technology_type == "Generator"]

        # ---- size variables / numeric ratings -------------------------
        size_refs: Dict[str, object] = {}
        for e in ess:
            if getattr(e, "sizing_ene", False):
                ref = b.var(e.vname("size_ene"), 1, lb=0.0)
                size_refs[e.vname("size_ene")] = ref
                b.add_cost(ref, float(e.ccost_kwh))
            if getattr(e, "sizing_ch", False) or getattr(e, "sizing_dis", False):
                ref = b.var(e.vname("size_dis"), 1, lb=0.0)
                size_refs[e.vname("size_dis")] = ref
                b.add_cost(ref, float(e.ccost_kw))
        for g in gens:
            if g.being_sized():
                ref = b.var(g.vname("size"), 1, lb=0.0)
                size_refs[g.vname("size")] = ref
                b.add_cost(ref, float(g.ccost_kw) * g.n_units)
        for pv in pvs:
            if pv.being_sized():
                ref = b.var(pv.vname("size"), 1, lb=0.0)
                size_refs[pv.vname("size")] = ref
                b.add_cost(ref, float(pv.cost_per_kw))

        # ---- per-outage coverage blocks -------------------------------
        for k, s0 in enumerate(sorted(set(int(s) for s in starts))):
            Lk = int(min(L, T - s0))
            if Lk <= 0:
                continue
            crit = crit_full[s0:s0 + Lk] * self._shed_curve(Lk)
            balance = []          # terms summing to supply (kW)
            const_supply = np.zeros(Lk)
            for e in ess:
                ch = b.var(f"o{k}/{e.vname('ch')}", Lk, lb=0.0)
                dis = b.var(f"o{k}/{e.vname('dis')}", Lk, lb=0.0)
                ene = b.var(f"o{k}/{e.vname('ene')}", Lk, lb=0.0)
                diag = sp.diags([np.ones(Lk), -np.ones(Lk - 1)],
                                offsets=[0, -1], format="csr")
                soe_terms = [(ene, diag), (ch, -e.rte * dt), (dis, dt)]
                first_col = sp.csr_matrix(
                    (np.ones(1), (np.zeros(1, int), np.zeros(1, int))),
                    shape=(Lk, 1))
                if e.vname("size_ene") in size_refs:
                    se = size_refs[e.vname("size_ene")]
                    soe_terms.append((se, first_col * (-self.soc_init)))
                    b.add_rows(f"o{k}/{e.vname('soe')}", soe_terms, "eq", 0.0)
                    b.add_rows(f"o{k}/{e.vname('ene_ub')}",
                               [(ene, 1.0), (se, -e.ulsoc * np.ones((Lk, 1)))],
                               "le", 0.0)
                else:
                    rhs = np.zeros(Lk)
                    rhs[0] = self.soc_init * e.energy_capacity()
                    b.add_rows(f"o{k}/{e.vname('soe')}", soe_terms, "eq", rhs)
                    b.set_bounds(ene, lb=e.operational_min_energy(),
                                 ub=e.operational_max_energy())
                if e.vname("size_dis") in size_refs:
                    sd = size_refs[e.vname("size_dis")]
                    b.add_rows(f"o{k}/{e.vname('ch_ub')}",
                               [(ch, 1.0), (sd, -np.ones((Lk, 1)))], "le", 0.0)
                    b.add_rows(f"o{k}/{e.vname('dis_ub')}",
                               [(dis, 1.0), (sd, -np.ones((Lk, 1)))], "le", 0.0)
                else:
                    b.set_bounds(ch, ub=e.charge_capacity())
                    b.set_bounds(dis, ub=e.discharge_capacity())
                balance.extend([(dis, np.ones(Lk)), (ch, -np.ones(Lk))])
            for g in gens:
                elec = b.var(f"o{k}/{g.vname('elec')}", Lk, lb=0.0)
                if g.vname("size") in size_refs:
                    sg = size_refs[g.vname("size")]
                    b.add_rows(f"o{k}/{g.vname('cap')}",
                               [(elec, 1.0),
                                (sg, -float(g.n_units) * np.ones((Lk, 1)))],
                               "le", 0.0)
                else:
                    b.set_bounds(elec, ub=g.max_power_out)
                balance.append((elec, np.ones(Lk)))
            for pv in pvs:
                per_kw = np.asarray(grab_column(
                    self.datasets.time_series.loc[index],
                    "PV Gen (kW/rated kW)", pv.id))[s0:s0 + Lk]
                nu = getattr(pv, "nu", 1.0)
                if pv.vname("size") in size_refs:
                    sp_ref = size_refs[pv.vname("size")]
                    balance.append((sp_ref, (nu * per_kw)[:, None]))
                else:
                    const_supply += nu * per_kw * pv.rated_capacity
            if not balance:
                raise TimeseriesDataError(
                    "reliability sizing needs at least one dispatchable DER")
            b.add_rows(f"o{k}/balance", balance, "ge", crit - const_supply)

        lp = b.build()
        res = cpu_ref.solve_lp_cpu(lp)
        if res.status != 0:
            raise TimeseriesDataError(
                "reliability sizing LP failed: "
                f"{getattr(res, 'message', 'solver failure')}")
        return {name: float(res.x[ref.sl][0])
                for name, ref in lp.var_refs.items() if name in size_refs}

    # ------------------------------------------------------------------
    # pre-dispatch: min-SOE schedule -> system requirement
    # ------------------------------------------------------------------
    def min_soe_schedule(self, ders, index: pd.DatetimeIndex) -> Optional[pd.DataFrame]:
        """Per-timestep minimum SOE so a target-length outage starting there
        is covered (reference ``min_soe_iterative``, Reliability.py:685-732:
        effective swing of the simulated profile from the initial SOC)."""
        if self.critical_load is None:
            self._prepare(index)
        mix = self._der_mix(ders)
        p = mix["props"]
        if p["energy rating"] <= 0:
            return None
        L = self.coverage_steps
        if self.min_soe_exact:
            dev = resolve_device(self.device)
            with _side_stream(dev):
                req = min_soe_required(
                    self.critical_load.to_numpy(), mix["gen"],
                    mix["pv_max"], mix["pv_vari"], mix["gamma"],
                    self._shed_curve(L), p["charge max"],
                    p["discharge max"], p["soe min"], p["soe max"],
                    p["rte"], self.dt, L, device=dev).cpu().numpy()
            n_bad = int(np.sum(req > p["soe max"] + 1e-6))
            if n_bad:
                TellUser.warning(
                    f"min_soe_exact: {n_bad} outage start(s) are not "
                    "coverable at any state of energy — requirement capped "
                    "at the fleet energy limit")
            self.min_soe_df = pd.DataFrame(
                {"soe": np.minimum(req, p["soe max"])}, index=index)
            return self.min_soe_df
        init = np.full(len(index), self.soc_init * p["energy rating"])
        cov, prof = self._walk(mix, init, L, "requirements")
        # profile incl. the initial soe at the front
        full = np.concatenate([init[:, None], prof], axis=1)
        # dead steps are zero-filled; effective swing over surviving steps
        steps = np.arange(L + 1)[None, :]
        alive = steps <= np.minimum(cov, L)[:, None]
        vals = np.where(alive, full, np.nan)
        swing = np.nanmax(vals, axis=1) - np.nanmin(vals, axis=1)
        self.min_soe_df = pd.DataFrame({"soe": swing}, index=index)
        self.soe_profiles = pd.DataFrame(
            {f"Reliability min SOE profile {k}":
             (prof[:, k] if k < prof.shape[1] else np.zeros(len(index)))
             for k in range(min(L, 2))}, index=index)
        return self.min_soe_df

    def system_requirements(self, ders, years, index) -> List[SystemRequirement]:
        if self.post_facto_only:
            return []
        self._prepare(index)
        self.min_soe_schedule(ders, index)
        if self.min_soe_df is None:
            return []
        return [SystemRequirement("energy", "min", "Reliability",
                                  self.min_soe_df["soe"])]

    # ------------------------------------------------------------------
    # results
    # ------------------------------------------------------------------
    def timeseries_report(self, index) -> pd.DataFrame:
        if self.critical_load is None:
            self._prepare(index)
        out = pd.DataFrame(index=index)
        if not self.post_facto_only:
            out["Total Critical Load (kWh)"] = self.requirement
        out[CRIT_COL] = self.critical_load
        if self.min_soe_df is not None:
            out["Reliability min State of Energy (kWh)"] = self.min_soe_df["soe"]
            if self.soe_profiles is not None:
                for c in self.soe_profiles.columns:
                    out[c] = self.soe_profiles[c]
        return out

    def load_coverage_probability(self, ders, results: pd.DataFrame
                                  ) -> pd.DataFrame:
        """LCPC: simulate an outage at every timestep; P(cover len) =
        fraction of feasible starts that survive >= len (reference
        Reliability.py:876-966 incl. end-truncation accounting)."""
        index = results.index
        if self.critical_load is None:
            self._prepare(index)
        mix = self._der_mix(ders)
        p = mix["props"]
        T = len(index)
        L = int(np.round(self.max_outage_duration / self.dt))
        if p["energy rating"] > 0:
            if self.use_sizing_module_results and self.min_soe_df is not None \
                    and "Aggregated State of Energy (kWh)" not in results:
                # no dispatch ran: start each outage from the min-SOE
                # schedule (reference Reliability.py:905-911)
                init = self.min_soe_df["soe"].to_numpy()
            elif "Aggregated State of Energy (kWh)" in results and \
                    not self.post_facto_only:
                init = results["Aggregated State of Energy (kWh)"].to_numpy()
            else:
                init = np.full(T, self.soc_init * p["energy rating"])
        else:
            init = np.zeros(T)
        cov, prof = self._walk(mix, init, L, "coverage")
        # cap coverage at steps remaining in the horizon
        cov = np.minimum(cov, T - np.arange(T))
        freq = np.bincount(cov.astype(int), minlength=L + 1)
        probs = []
        lengths = np.arange(1, L + 1)
        for k in lengths:
            covered = freq[k:].sum()
            possible = T - k + 1
            probs.append(covered / possible)
        self.outage_soe_profile = pd.DataFrame(
            {h: prof[:, h - 1] for h in range(1, L + 1)}, index=index)
        return pd.DataFrame({
            "Outage Length (hrs)": lengths * self.dt,
            "Load Coverage Probability (%)": probs,
        }).set_index("Outage Length (hrs)")

    def contribution_summary(self, ders, results: pd.DataFrame
                             ) -> pd.DataFrame:
        """Split the outage energy requirement across PV -> storage -> fuel
        (reference Reliability.py:806-874 waterfall order)."""
        index = results.index
        outage_energy = pd.Series(self.requirement, index=index)
        cols = {}
        pv = [d for d in ders if d.technology_type == "Intermittent Resource"]
        if pv:
            agg = np.zeros(len(index))
            for d in pv:
                agg += d.maximum_generation_series(index)
            pv_e = pd.Series(rolling_forward_sum(agg, self.coverage_steps)
                             * self.dt, index=index)
            net = outage_energy - pv_e
            outage_energy = net.clip(lower=0)
            pv_e = pv_e + net.clip(upper=0)
            cols["PV Outage Contribution (kWh)"] = pv_e
        ess = [d for d in ders if d.technology_type == "Energy Storage System"]
        if ess:
            if "Aggregated State of Energy (kWh)" in results:
                soe = results["Aggregated State of Energy (kWh)"]
            else:
                soe = pd.Series(0.0, index=index)
            net = outage_energy - soe
            outage_energy = net.clip(lower=0)
            cols["Storage Outage Contribution (kWh)"] = soe + net.clip(upper=0)
        gens = [d for d in ders if d.technology_type == "Generator"]
        if gens:
            cols["ICE Outage Contribution (kWh)"] = outage_energy
        self.outage_contribution_df = pd.DataFrame(cols, index=index)
        return self.outage_contribution_df

    def drill_down_dfs(self, results: pd.DataFrame, dt: float
                       ) -> Dict[str, pd.DataFrame]:
        return {}  # populated via drill_down_reports (needs the DER list)

    def drill_down_reports(self, ders, results: pd.DataFrame
                           ) -> Dict[str, pd.DataFrame]:
        TellUser.info("Starting load coverage calculation...")
        out = {"load_coverage_prob": self.load_coverage_probability(ders, results)}
        out["lcp_outage_soe_profiles"] = self.outage_soe_profile
        if not self.post_facto_only:
            out["outage_energy_contributions"] = \
                self.contribution_summary(ders, results)
        TellUser.info("Finished load coverage calculation.")
        return out
