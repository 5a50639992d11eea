"""Energy-storage physics as LP blocks (EnergyStorage base + Battery).

Re-implements the behavior of the reference's storagevet
``Technology.EnergyStorage`` + ``BatteryTech.Battery`` + dervet
``MicrogridDER/ESSSizing.py`` + ``MicrogridDER/Battery.py`` (SURVEY.md
§2.4/§2.8) as structured constraint rows instead of CVXPY expressions:

* variables per window: ``ene`` (end-of-step state of energy, kWh),
  ``ch`` (charging power, kW), ``dis`` (discharging power, kW)
* SOE evolution with round-trip efficiency on charge and self-discharge,
  window boundary condition pinning first/last SOE to the target
  (windows start and end at ``soc_target`` — this is what makes windows
  independent and therefore batchable on the scenario axis)
* bounds from rated capacities and SOC limits
* optional daily cycle-count limit as per-day energy rows

Inputs are the reference's Battery tag keys (percent-valued keys are
converted to fractions here).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import scipy.sparse as sp

from ...ops.lp import LPBuilder, VarRef
from ...scenario.window import WindowContext
from ...utils.errors import ParameterError, TellUser
from .base import DER


class EnergyStorage(DER):
    """Generic electric energy-storage system (reference: storagevet
    EnergyStorage surface, SURVEY.md §2.8)."""

    technology_type = "Energy Storage System"

    def __init__(self, tag: str, der_id: str, keys: Dict, scenario: Dict):
        super().__init__(tag, der_id, keys, scenario)
        g = lambda k, d=0.0: float(keys.get(k, d) or 0.0)
        self.rte = g("rte", 100.0) / 100.0
        self.sdr = g("sdr") / 100.0            # self-discharge, fraction/step
        self.llsoc = g("llsoc") / 100.0
        self.ulsoc = g("ulsoc", 100.0) / 100.0
        self.soc_target = g("soc_target", 50.0) / 100.0
        self.ch_max_rated = g("ch_max_rated")
        self.dis_max_rated = g("dis_max_rated")
        self.ch_min_rated = g("ch_min_rated")
        self.dis_min_rated = g("dis_min_rated")
        self.ene_max_rated = g("ene_max_rated")
        self.duration_max = g("duration_max")
        self.daily_cycle_limit = g("daily_cycle_limit")
        self.hp = g("hp")                       # house power (kW, constant)
        self.variable_om = g("OMexpenses") / 1000.0   # $/MWh -> $/kWh
        self.fixed_om_per_kw = g("fixedOM")           # $/kW-yr on discharge
        self.ccost = g("ccost")
        self.ccost_kw = g("ccost_kw")
        self.ccost_kwh = g("ccost_kwh")
        self.incl_binary = bool(scenario.get("binary", False))
        if (self.ch_min_rated or self.dis_min_rated) and not self.incl_binary:
            TellUser.warning(f"{self.name}: nonzero ch/dis minimums require the "
                             "binary formulation; ignored in the LP relaxation")
        # startup costs ride the binary on/off indicators (reference:
        # EnergyStorage incl_startup + p_start_ch/p_start_dis surface,
        # wired through ESSSizing.py:389-396)
        self.incl_startup = bool(keys.get("startup", False))
        self.p_start_ch = g("p_start_ch")
        self.p_start_dis = g("p_start_dis")
        if self.incl_startup and not self.incl_binary:
            TellUser.warning(
                f"{self.name}: startup=1 requires the binary formulation "
                "(scenario binary=1); startup costs are NOT applied")
        # fraction of rated energy usable (degradation hooks update this)
        self.soh = 1.0
        # sizing: a zero rating is a size decision variable (reference:
        # ESSSizing.py:82-138 swaps zeros for CVXPY integer Variables with
        # user min/max bounds; here a continuous scalar LP variable)
        self.sizing_ene = self.ene_max_rated == 0
        self.sizing_ch = self.ch_max_rated == 0
        self.sizing_dis = self.dis_max_rated == 0
        self.user_bounds = {
            "ene": (g("user_ene_rated_min"), g("user_ene_rated_max")),
            "ch": (g("user_ch_rated_min"), g("user_ch_rated_max")),
            "dis": (g("user_dis_rated_min"), g("user_dis_rated_max")),
        }
        # per-window user TS limits actually applied, echoed into the
        # output timeseries: column stem -> {window label: Series}
        self._ts_user_limits: Dict[str, Dict[int, pd.Series]] = {}

    # ---------------- capacity accessors (sizing overrides later) ------
    def energy_capacity(self) -> float:
        return self.ene_max_rated

    def charge_capacity(self) -> float:
        return self.ch_max_rated

    def discharge_capacity(self) -> float:
        return self.dis_max_rated

    def operational_max_energy(self) -> float:
        return self.ulsoc * self.soh * self.energy_capacity()

    def operational_min_energy(self) -> float:
        return self.llsoc * self.soh * self.energy_capacity()

    @property
    def ene_target(self) -> float:
        return self.soc_target * self.soh * self.energy_capacity()

    # ---------------- LP assembly --------------------------------------
    def being_sized(self) -> bool:
        return self.sizing_ene or self.sizing_ch or self.sizing_dis

    def _size_var(self, b: LPBuilder, which: str):
        lo, hi = self.user_bounds[which]
        return b.var(self.vname(f"size_{which}"), 1, lb=max(lo, 0.0),
                     ub=hi if hi > 0 else np.inf)

    def build(self, b: LPBuilder, ctx: WindowContext) -> None:
        T, dt = ctx.T, ctx.dt
        if self.being_sized():
            self._build_sizing(b, ctx)
            return
        e_max = self.operational_max_energy()
        e_min = self.operational_min_energy()
        e0 = ctx.carry.get(self.vname("soe0"), self.ene_target)

        ene = b.var(self.vname("ene"), T, lb=e_min, ub=e_max)
        ch = b.var(self.vname("ch"), T, lb=0.0, ub=self.charge_capacity())
        dis = b.var(self.vname("dis"), T, lb=0.0, ub=self.discharge_capacity())
        self._ts_limit_bounds(b, ctx, ene, ch, dis, e_min, e_max)
        if self.incl_binary:
            self._binary_onoff_rows(b, ctx, ch, dis)

        # BEGIN-of-step SOE convention (verified against the Usecase2 step2
        # golden to 1e-10): ene[t+1] = ene[t]*(1-sdr) + rte*dt*ch[t] -
        # dt*dis[t]; ene[0] pinned to the window-entry target and the
        # POST-last-step state pinned back to the target (the golden's
        # implied post-window SOE is exactly soc_target*rating every
        # month).  An end-of-step convention makes the min-SOE floor bind
        # AT the peak hour instead of after it and loses ~20% of
        # demand-charge savings vs the reference.
        soe_terms, final_terms = self._soe_rows(ene, ch, dis, T, dt)
        rhs = np.zeros(T)
        rhs[0] = e0
        b.add_rows(self.vname("soe"), soe_terms, "eq", rhs)
        b.add_rows(self.vname("soe_final"), final_terms, "eq",
                   np.array([self.ene_target]))

        if self.daily_cycle_limit > 0:
            self._daily_cycle_rows(b, ctx, dis)

        # operating costs
        if self.variable_om:
            b.add_cost(dis, self.variable_om * dt * ctx.annuity_scalar,
                       label=f"{self.name} var_om")
        if self.fixed_om_per_kw:
            b.add_const_cost(self.fixed_om_per_kw * self.discharge_capacity()
                             * ctx.annuity_scalar * (T * dt) / 8760.0,
                             label=f"{self.name} fixed_om")

    def _build_sizing(self, b: LPBuilder, ctx: WindowContext) -> None:
        """Sizing formulation: zero ratings become scalar size variables;
        capacity bounds/SOE targets become rows against them (reference:
        ESSSizing.py:82-138 effective-SOE expressions + bound constraints;
        continuous relaxation of the integer sizes per SURVEY §7)."""
        T, dt = ctx.T, ctx.dt
        one = np.ones((T, 1))
        ene = b.var(self.vname("ene"), T, lb=0.0)
        ch = b.var(self.vname("ch"), T, lb=0.0,
                   ub=np.inf if self.sizing_ch else self.charge_capacity())
        dis = b.var(self.vname("dis"), T, lb=0.0,
                    ub=np.inf if self.sizing_dis else self.discharge_capacity())
        if self.sizing_ene:
            size_e = self._size_var(b, "ene")
            b.add_rows(self.vname("ene_ub"),
                       [(ene, 1.0), (size_e, -self.ulsoc * self.soh * one)],
                       "le", 0.0)
            if self.llsoc > 0:
                b.add_rows(self.vname("ene_lb"),
                           [(ene, 1.0), (size_e, -self.llsoc * self.soh * one)],
                           "ge", 0.0)
            target_term = [(size_e, np.full((1, 1), -self.soc_target * self.soh))]
            b.add_cost(size_e, self.ccost_kwh, label=f"{self.name}capex")
        else:
            b.set_bounds(ene, lb=self.operational_min_energy(),
                         ub=self.operational_max_energy())
            target_term = []
        if self.sizing_ch and self.sizing_dis:
            # both ratings zero: size ONE power cap shared by charge and
            # discharge (reference: ESSSizing.py:97-106 sets
            # dis_max_rated = ch_max_rated)
            size_p = self._size_var(b, "dis")
            b.add_rows(self.vname("ch_ub"), [(ch, 1.0), (size_p, -one)],
                       "le", 0.0)
            b.add_rows(self.vname("dis_ub"), [(dis, 1.0), (size_p, -one)],
                       "le", 0.0)
            b.add_cost(size_p, self.ccost_kw, label=f"{self.name}capex")
            # NOTE: no fixed-O&M on the sized rating — the reference
            # evaluates fixedOM * dis_max_rated before ESSSizing swaps the
            # zero rating for a variable, so sized DERs carry zero fixed
            # O&M in the sizing objective (verified against the Usecase1
            # size golden: including it undershoots the size by 7%)
        elif self.sizing_ch:
            size_c = self._size_var(b, "ch")
            b.add_rows(self.vname("ch_ub"), [(ch, 1.0), (size_c, -one)],
                       "le", 0.0)
        elif self.sizing_dis:
            size_d = self._size_var(b, "dis")
            b.add_rows(self.vname("dis_ub"), [(dis, 1.0), (size_d, -one)],
                       "le", 0.0)
            b.add_cost(size_d, self.ccost_kw, label=f"{self.name}capex")
        # ts limits still apply to non-sized ratings; the sized rating's
        # limits log an error and are dropped (reference ESSSizing.py:88-116).
        # Applied AFTER the static bound assignments above so per-timestep
        # limits are not overwritten.
        self._ts_limit_bounds(b, ctx, ene, ch, dis,
                              self.operational_min_energy(),
                              self.operational_max_energy())
        if self.ccost:
            b.add_const_cost(self.ccost, label=f"{self.name}capex")
        if self.duration_max and self.sizing_ene and self.sizing_dis:
            b.add_rows(self.vname("duration_max"),
                       [(b[self.vname("size_ene")], np.ones((1, 1))),
                        (b[self.vname("size_dis")],
                         np.full((1, 1), -self.duration_max))], "le", 0.0)

        # BEGIN-of-step SOE with both the window ENTRY and the
        # post-last-step state pinned to soc_target * size (same convention
        # as the fixed-size build, with the size variable supplying the
        # target)
        first = sp.csr_matrix((np.ones(1), (np.zeros(1, int), np.zeros(1, int))),
                              shape=(T, 1))
        soe_terms, final_terms = self._soe_rows(ene, ch, dis, T, dt)
        if target_term:
            ref, coef = target_term[0]
            soe_terms.append((ref, first * float(coef[0, 0])))
            b.add_rows(self.vname("soe"), soe_terms, "eq", np.zeros(T))
            b.add_rows(self.vname("soe_final"), final_terms + [(ref, coef)],
                       "eq", 0.0)
        else:
            rhs = np.zeros(T)
            rhs[0] = self.ene_target
            b.add_rows(self.vname("soe"), soe_terms, "eq", rhs)
            b.add_rows(self.vname("soe_final"), final_terms, "eq",
                       np.array([self.ene_target]))

        if self.daily_cycle_limit > 0:
            if self.sizing_ene:
                # sum_day(dis)*dt <= limit * usable * size_e — linear in the
                # size variable, carried into the sizing LP
                mat = self._daily_sum_matrix(ctx)
                usable = self.daily_cycle_limit * (self.ulsoc - self.llsoc) \
                    * self.soh
                b.add_rows(self.vname("daily_cycle"),
                           [(dis, mat),
                            (b[self.vname("size_ene")],
                             np.full((mat.shape[0], 1), -usable))],
                           "le", 0.0)
            else:
                self._daily_cycle_rows(b, ctx, dis)

        if self.variable_om:
            b.add_cost(dis, self.variable_om * dt * ctx.annuity_scalar,
                       label=f"{self.name} var_om")
        if self.fixed_om_per_kw and not self.sizing_dis:
            b.add_const_cost(self.fixed_om_per_kw * self.discharge_capacity()
                             * ctx.annuity_scalar * (T * dt) / 8760.0,
                             label=f"{self.name} fixed_om")

    def set_size(self, sizes: Dict[str, float]) -> None:
        """Freeze solved size variables into ratings, snapped to the
        reference's integer grid (reference: ESSSizing.set_size with
        ``integer=True`` size vars, applied after the first window —
        MicrogridScenario.py:361-363, ESSSizing.py:83-138)."""
        from .base import integer_size

        self.size_continuous = {k: float(v) for k, v in sizes.items()}
        if "size_ene" in sizes:
            self.ene_max_rated = integer_size(float(sizes["size_ene"]),
                                              self.user_bounds["ene"][1])
            self.sizing_ene = False
        if "size_ch" in sizes:
            self.ch_max_rated = integer_size(float(sizes["size_ch"]),
                                             self.user_bounds["ch"][1])
            self.sizing_ch = False
        if "size_dis" in sizes:
            self.dis_max_rated = integer_size(float(sizes["size_dis"]),
                                              self.user_bounds["dis"][1])
            if self.sizing_ch:      # shared power cap (both were zero)
                self.ch_max_rated = self.dis_max_rated
                self.sizing_ch = False
            self.sizing_dis = False
        cont = ", ".join(f"{k[5:]} {v:.2f}"
                         for k, v in self.size_continuous.items())
        TellUser.info(f"{self.name} sized: {self.ene_max_rated:.1f} kWh, "
                      f"ch {self.ch_max_rated:.1f} kW / "
                      f"dis {self.dis_max_rated:.1f} kW "
                      f"(continuous relaxation: {cont})")

    def _soe_rows(self, ene, ch, dis, T: int, dt: float):
        """Begin-of-step SOE constraint blocks shared by the fixed-size and
        sizing builds: ``(soe_terms, final_terms)`` where soe_terms encode
        ene[t+1] = ene[t]*(1-sdr) + rte*dt*ch[t] - dt*dis[t] (row 0 is the
        entry pin) and final_terms the post-last-step state."""
        diag = sp.diags([np.full(T, 1.0), np.full(T - 1, -(1.0 - self.sdr))],
                        offsets=[0, -1], format="csr")
        sub = sp.diags([np.full(T - 1, 1.0)], offsets=[-1], format="csr")
        soe_terms = [(ene, diag), (ch, sub * (-self.rte * dt)),
                     (dis, sub * dt)]
        last = np.zeros(T)
        last[T - 1] = 1.0
        final_terms = [(ene, sp.csr_matrix(last * (1.0 - self.sdr))),
                       (ch, sp.csr_matrix(last * self.rte * dt)),
                       (dis, sp.csr_matrix(last * -dt))]
        return soe_terms, final_terms

    def _ts_limit_bounds(self, b: LPBuilder, ctx: WindowContext, ene, ch,
                         dis, e_min: float, e_max: float) -> None:
        """Optional per-DER time-series limit columns tighten the variable
        bounds (reference ESSSizing.py:236-262: 'Battery: Charge Max
        (kW)/<id>' etc., gated by incl_ts_*_limits keys; ignored with an
        error log when the corresponding rating is being sized)."""
        tag = self.tag
        spec = [
            ("incl_ts_charge_limits", ch,
             f"{tag}: Charge Min (kW)", f"{tag}: Charge Max (kW)",
             0.0, self.charge_capacity(), self.sizing_ch),
            ("incl_ts_discharge_limits", dis,
             f"{tag}: Discharge Min (kW)", f"{tag}: Discharge Max (kW)",
             0.0, self.discharge_capacity(), self.sizing_dis),
            ("incl_ts_energy_limits", ene,
             f"{tag}: Energy Min (kWh)", f"{tag}: Energy Max (kWh)",
             e_min, e_max, self.sizing_ene),
        ]
        for key, ref, lo_col, hi_col, lo_def, hi_def, sizing in spec:
            if not self.keys.get(key, False):
                continue
            if sizing:
                TellUser.error(f"{self.name}: ignoring {key} time series "
                               "because the rating is being sized "
                               "(reference behavior)")
                continue
            lo = ctx.col(lo_col, self.id)
            hi = ctx.col(hi_col, self.id)
            if lo is None and hi is None:
                # the reference records a fatal input error here
                # (DERVETParams.load_ts_limits, :655-659)
                raise ParameterError(
                    f"{self.name}: {key} is set but neither {lo_col!r} nor "
                    f"{hi_col!r} is in the time series")
            lo_arr = np.clip(np.nan_to_num(lo, nan=lo_def), lo_def, None) \
                if lo is not None else lo_def
            hi_arr = np.clip(np.nan_to_num(hi, nan=hi_def), None, hi_def) \
                if hi is not None else hi_def
            b.set_bounds(ref, lb=lo_arr, ub=hi_arr)
            # echo the applied limits into the output timeseries
            # (reference ESSSizing.timeseries_report, :299-308:
            # '<TAG>: <name> User Charge Max (kW)' etc.)
            qty, unit = lo_col.split(": ")[1].rsplit(" ", 2)[0], \
                ("(kWh)" if "Energy" in lo_col else "(kW)")
            for stem, arr in ((f"User {qty} Max {unit}", hi_arr),
                              (f"User {qty} Min {unit}", lo_arr)):
                full = np.broadcast_to(np.asarray(arr, float), (ctx.T,))
                self._ts_user_limits.setdefault(stem, {})[ctx.label] = \
                    pd.Series(full, index=ctx.index)

    def _binary_onoff_rows(self, b: LPBuilder, ctx: WindowContext,
                           ch, dis) -> None:
        """Binary on/off formulation (scenario ``binary=1``): per-step
        charge/discharge indicator variables enforce mutual exclusion and
        the ch/dis minimum ratings (reference: storagevet EnergyStorage
        ``on_c``/``on_d`` boolean variables behind CVXPY+GLPK_MI; the LP
        IR marks the blocks integral and the scenario routes the window
        to the exact CPU MILP backend)."""
        T = ctx.T
        on_c = b.var(self.vname("on_c"), T, binary=True)
        on_d = b.var(self.vname("on_d"), T, binary=True)
        # ch <= ch_max*on_c  ->  ch_max*on_c - ch >= 0
        b.add_rows(self.vname("bin_ch_cap"),
                   [(on_c, self.charge_capacity()), (ch, -1.0)], "ge", 0.0)
        b.add_rows(self.vname("bin_dis_cap"),
                   [(on_d, self.discharge_capacity()), (dis, -1.0)], "ge", 0.0)
        if self.ch_min_rated:
            b.add_rows(self.vname("bin_ch_min"),
                       [(ch, 1.0), (on_c, -self.ch_min_rated)], "ge", 0.0)
        if self.dis_min_rated:
            b.add_rows(self.vname("bin_dis_min"),
                       [(dis, 1.0), (on_d, -self.dis_min_rated)], "ge", 0.0)
        # no simultaneous charge and discharge: on_c + on_d <= 1
        b.add_rows(self.vname("bin_excl"),
                   [(on_c, -1.0), (on_d, -1.0)], "ge", -1.0)
        if self.incl_startup:
            self._startup_rows(b, ctx, on_c, on_d)

    def _startup_rows(self, b: LPBuilder, ctx: WindowContext,
                      on_c, on_d) -> None:
        """Startup-cost formulation: ``start[t] >= on[t] - on[t-1]`` with
        cost ``p_start * sum(start)`` — positive cost drives each start
        indicator to exactly max(0, rising edge), so the continuous start
        block stays exact without extra integrality (reference: the
        EnergyStorage startup surface, incl_startup/p_start_ch/p_start_dis,
        ESSSizing.py:389-396).  The first step of a window is not charged
        (no prior on-state to compare against, matching the per-window
        reference objective)."""
        T = ctx.T
        if T < 2:
            return
        # row t (t=1..T-1):  start[t] - on[t] + on[t-1] >= 0
        pick = sp.eye(T, format="csr")[1:]               # selects x[1:]
        diff = pick - sp.eye(T, format="csr")[:-1]       # x[t] - x[t-1]
        for which, on, p_start in (("ch", on_c, self.p_start_ch),
                                   ("dis", on_d, self.p_start_dis)):
            if not p_start:
                continue
            start = b.var(self.vname(f"start_{which}"), T, lb=0.0, ub=1.0)
            b.add_rows(self.vname(f"startup_{which}"),
                       [(start, pick), (on, -diff)], "ge", 0.0)
            b.add_cost(start, p_start * ctx.annuity_scalar,
                       label=f"{self.name} startup")

    def _daily_sum_matrix(self, ctx: WindowContext) -> sp.csr_matrix:
        """(n_days, T) matrix summing dis*dt per calendar day.

        ``pd.factorize`` labels each step with its day-of-appearance in one
        vectorized pass — the per-day ``days == d`` mask loop it replaces
        cost ~60 pandas comparisons per window, the single hottest line of
        the 128-case sensitivity fan-out's host assembly (VERDICT r5 #1)."""
        codes, uniq = pd.factorize(ctx.index.normalize())
        return sp.coo_matrix(
            (np.full(ctx.T, ctx.dt), (codes, np.arange(ctx.T))),
            shape=(len(uniq), ctx.T)).tocsr()

    def _daily_cycle_rows(self, b: LPBuilder, ctx: WindowContext, dis: VarRef):
        """sum_day(dis)*dt <= daily_cycle_limit * usable energy, per day.

        Kept as per-day aggregation rows ON PURPOSE: these ride BandedOp's
        low-rank wide-row pair (two small MXU matmuls inside the fused
        kernel).  A banded-recurrence reformulation (cumulative variable
        with the cap as its bound) was measured r5 and LOST ~1.8x — it
        adds T variables + T rows of state to every HBM-bound restart
        check and costs ~15% more PDHG iterations (the daily cap signal
        propagates one chain step per iteration)."""
        mat = self._daily_sum_matrix(ctx)
        cap = self.daily_cycle_limit * (self.operational_max_energy()
                                        - self.operational_min_energy())
        b.add_rows(self.vname("daily_cycle"), [(dis, mat)], "le",
                   np.full(mat.shape[0], cap))

    # ---------------- POI interface -------------------------------------
    def power_terms(self, b: LPBuilder) -> List[Tuple[VarRef, float]]:
        return [(b[self.vname("dis")], +1.0), (b[self.vname("ch")], -1.0)]

    def fixed_load(self, ctx: WindowContext) -> Optional[np.ndarray]:
        if self.hp:
            return np.full(ctx.T, self.hp)
        return None

    def soe_term(self, b: LPBuilder) -> Optional[VarRef]:
        return b[self.vname("ene")]

    def market_headroom(self, b: LPBuilder, direction: str):
        """Up: raise discharge to rated + cut charge to zero; down: raise
        charge to rated + cut discharge (reference: storagevet EnergyStorage
        get_discharge/charge_up/down_schedule surface).  While a rating is
        being sized, its size variable supplies the nameplate term."""
        ch, dis = b[self.vname("ch")], b[self.vname("dis")]
        if direction == "up":
            terms, const = [(dis, -1.0), (ch, 1.0)], self.discharge_capacity()
            if self.sizing_dis and b.has(self.vname("size_dis")):
                terms.append((b[self.vname("size_dis")], 1.0))
                const = 0.0
            return terms, const
        terms, const = [(ch, -1.0), (dis, 1.0)], self.charge_capacity()
        if self.sizing_ch:
            # shared power sizing registers a single 'size_dis' variable
            # (reference ties ch==dis when both are zero)
            for cand in ("size_ch", "size_dis"):
                if b.has(self.vname(cand)):
                    terms.append((b[self.vname(cand)], 1.0))
                    const = 0.0
                    break
        return terms, const

    def load_series(self):
        if self.hp and self.variables_df is not None:
            return np.full(len(self.variables_df), self.hp)
        return None

    # ---------------- results -------------------------------------------
    def store_dispatch(self, index, values):
        super().store_dispatch(index, values)
        # SOE hand-off: next run starts from final energy (within a run the
        # windows pin to ene_target; carry is for degradation-coupled reruns)

    def timeseries_report(self) -> pd.DataFrame:
        v = self.variables_df
        out = pd.DataFrame(index=v.index)
        e_max = self.operational_max_energy()
        out[self.col("Charge (kW)")] = v["ch"]
        out[self.col("Discharge (kW)")] = v["dis"]
        out[self.col("Power (kW)")] = v["dis"] - v["ch"]
        out[self.col("State of Energy (kWh)")] = v["ene"]
        out[self.col("SOC (%)")] = v["ene"] / (e_max if e_max else 1.0)
        for stem, per_window in self._ts_user_limits.items():
            ser = pd.concat(per_window.values()).sort_index()
            out[self.col(stem)] = ser.reindex(out.index)
        return out

    def get_capex(self) -> float:
        return (self.ccost + self.ccost_kw * self.discharge_capacity()
                + self.ccost_kwh * self.energy_capacity())

    def replacement_cost(self) -> float:
        """rcost + rcost_kW*dis + rcost_kWh*ene (reference:
        ESSSizing.py:438-444)."""
        g = lambda k: float(self.keys.get(k, 0) or 0)
        return (g("rcost") + g("rcost_kW") * self.discharge_capacity()
                + g("rcost_kWh") * self.energy_capacity())

    def proforma_report(self, opt_years, apply_inflation_rate_func=None,
                        fill_forward_func=None):
        """Fixed + variable O&M rows per optimized year (reference:
        storagevet EnergyStorage proforma surface, SURVEY.md §2.8)."""
        uid = self.unique_tech_id
        rows = {}
        v = self.variables_df
        for yr in opt_years:
            per = pd.Period(yr, freq="Y")
            fixed = -self.fixed_om_per_kw * self.discharge_capacity()
            var = 0.0
            if v is not None and "dis" in v:
                mask = v.index.year == yr
                var = -self.variable_om * self.dt * float(v.loc[mask, "dis"].sum())
            rows[per] = {f"{uid} Fixed O&M Cost": fixed,
                         f"{uid} Variable O&M Cost": var}
        return pd.DataFrame(rows).T

    def sizing_summary(self) -> Dict:
        dis = self.discharge_capacity()
        return {
            "DER": self.name,
            "Energy Rating (kWh)": self.energy_capacity(),
            "Charge Rating (kW)": self.charge_capacity(),
            "Discharge Rating (kW)": dis,
            "Round Trip Efficiency (%)": self.rte,
            "Lower Limit on SOC (%)": self.llsoc,
            "Upper Limit on SOC (%)": self.ulsoc,
            "Duration (hours)": (self.energy_capacity() / dis) if dis else 0,
            "Capital Cost ($)": self.ccost,
            "Capital Cost ($/kW)": self.ccost_kw,
            "Capital Cost ($/kWh)": self.ccost_kwh,
        }


class Battery(EnergyStorage):
    """Battery ESS (reference: dervet/MicrogridDER/Battery.py:66-110 adds a
    duration_max sizing constraint + cycle-degradation module on top of the
    storagevet battery)."""

    def __init__(self, keys: Dict, scenario: Dict, der_id: str = "",
                 cycle_life: Optional[pd.DataFrame] = None):
        super().__init__("Battery", der_id, keys, scenario)
        self.incl_cycle_degrade = bool(keys.get("incl_cycle_degrade", False))
        self.cycle_life = cycle_life
        g = lambda k, d=0.0: float(keys.get(k, d) or 0.0)
        self.yearly_degrade = g("yearly_degrade") / 100.0
        self.state_of_health = g("state_of_health") / 100.0
        # replaceable comes from the base lifecycle property (keys)
        self.degrade_perc = 0.0
        self.years_system_degraded: set = set()
        self.degradation_log: List[Dict] = []
        self._damage_model = None
        if self.incl_cycle_degrade:
            if cycle_life is None:
                raise ParameterError(
                    f"{self.name}: incl_cycle_degrade requires a "
                    "cycle_life_filename")
            from .degradation import CycleDegradation
            self._damage_model = CycleDegradation(cycle_life)
        if self.duration_max and self.dis_max_rated:
            if self.ene_max_rated > self.duration_max * self.dis_max_rated:
                raise ParameterError(
                    f"{self.name}: energy rating {self.ene_max_rated} exceeds "
                    f"duration_max*discharge rating "
                    f"{self.duration_max * self.dis_max_rated}")

    # ---------------- degradation lifecycle ----------------------------
    # (reference: Battery.py:69-110 calc_degradation + replacement reset;
    # the rainflow damage model itself lives in degradation.py)
    def degraded_energy_capacity(self) -> float:
        return (1.0 - self.degrade_perc) * self.energy_capacity()

    def calc_degradation(self, window_index: pd.DatetimeIndex,
                         soe: np.ndarray) -> None:
        """Update SOH after one solved window from its SOE profile."""
        if not self.incl_cycle_degrade:
            return
        cap = self.energy_capacity()
        if cap <= 0:
            return
        cycle = self._damage_model.damage(np.asarray(soe) / cap)
        hours = len(window_index) * self.dt
        calendar = self.yearly_degrade * hours / 8760.0
        self.degrade_perc += cycle + calendar
        year = int(window_index[0].year)
        replaced = False
        if self.degraded_energy_capacity() <= cap * self.state_of_health:
            self.years_system_degraded.add(year)
            if self.replaceable:
                self.degrade_perc = 0.0
                replaced = True
                TellUser.info(f"{self.name}: replaced in {year} (SOH hit "
                              f"{self.state_of_health:.0%})")
            else:
                TellUser.warning(f"{self.name}: reached end of life in "
                                 f"{year} and is not replaceable")
        self.soh = 1.0 - self.degrade_perc
        self.degradation_log.append({
            "Window Start": window_index[0], "Cycle Degradation": cycle,
            "Calendar Degradation": calendar,
            "State of Health (%)": self.soh * 100.0, "Replaced": replaced})

    def degradation_report(self) -> Optional[pd.DataFrame]:
        if not self.degradation_log:
            return None
        return pd.DataFrame(self.degradation_log).set_index("Window Start")

    def estimated_lifetime_years(self) -> Optional[float]:
        """Years until SOH hits the replacement threshold at the observed
        average degradation rate (reference:
        set_end_of_life_based_on_degradation_cycle, Battery.py:112-179)."""
        if not self.degradation_log:
            return None
        df = pd.DataFrame(self.degradation_log)
        total = df["Cycle Degradation"].sum() + df["Calendar Degradation"].sum()
        spans = df["Window Start"]
        span_years = 1.0
        if len(spans) >= 2:
            span_years = max((spans.iloc[-1] - spans.iloc[0]).days / 365.25,
                             1.0 / 12.0)
        rate = total / span_years
        if rate <= 0:
            return None
        return (1.0 - self.state_of_health) / rate
