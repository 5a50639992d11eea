"""The port's portfolio co-optimization (``dervet_tpu_torch.portfolio``)
on the CPU.

* The JAX package's cases (``tests/test_portfolio.py``: decomposition
  against the monolithic HiGHS LP, coupling feasibility, determinism,
  dual-iterate warm seeding, typed infeasibility, the diverging-duals
  drill, the service and spool; ``tests/test_portfolio_scale.py``: the
  stabilized master, the shard planner, local- and fleet-sharded parity,
  the shard case cache, the hint handoff) run here against the port,
  the jax backend's cases on ``backend="torch", device="cpu"`` (the
  kernels' plain versions); their own files run them against the JAX
  package.
* The port against the JAX package on the same inputs: on
  ``backend="cpu"`` (HiGHS inner solves, the same numpy) duals,
  aggregate and objective byte-identical; the port's ``torch`` backend
  against the JAX package's ``jax`` backend at the same outer rounds
  (+-1), objectives within ``gap_tol``, every window certified.
* The warm-start memory: the port raises it to hold a whole dual round
  (twice the windows + 64), so a small memory that evicts the JAX
  package's dual-iterate hints mid-round still seeds every window of
  every later round in the port.
* ``device=None`` means ``cuda:0`` and raises without a GPU.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from dervet_tpu_torch.ops import warmstart
from dervet_tpu_torch.ops.certify import validate_portfolio_certification
from dervet_tpu_torch.ops.warmstart import SolutionMemory
from dervet_tpu_torch.portfolio import (PortfolioInfeasibleError,
                                        PortfolioSpec, monolithic_reference,
                                        solve_portfolio,
                                        validate_portfolio_section)
from dervet_tpu_torch.portfolio.service import (PortfolioRound,
                                                parse_portfolio_request,
                                                synthetic_portfolio_members)
from dervet_tpu_torch.portfolio.shard import merge_summaries, plan_shards
from dervet_tpu_torch.utils import faultinject
from dervet_tpu_torch.utils.errors import ParameterError

torch.set_num_threads(2)


def _members(n=2, hours=48, window=24, seed=0, pv_kw=9000.0):
    return synthetic_portfolio_members(n, hours=hours, window=window,
                                       seed=seed, pv_kw=pv_kw)


def _binding_cap(n=2, hours=48, window=24, margin=800.0):
    """A shared export cap strictly below the fleet's unconstrained
    aggregate peak — guaranteed binding."""
    probe = solve_portfolio(
        PortfolioSpec(members=_members(n, hours, window),
                      export_cap_kw=1e9, max_outer=1), backend="cpu")
    return float(probe.aggregate["net_export"].max()) - margin


# ---------------------------------------------------------------------------
# Spec validation
# ---------------------------------------------------------------------------

class TestSpec:
    def test_requires_coupling(self):
        with pytest.raises(ParameterError, match="no coupling"):
            PortfolioSpec(members=_members(2)).validate()

    def test_requires_two_sites(self):
        m = _members(2)
        one = {k: v for k, v in list(m.items())[:1]}
        with pytest.raises(ParameterError, match=">= 2 sites"):
            PortfolioSpec(members=one, export_cap_kw=1.0).validate()

    def test_mismatched_horizons_rejected(self):
        m = _members(2, hours=48)
        m2 = _members(2, hours=72)
        mixed = {"a": m["site000"], "b": m2["site001"]}
        spec = PortfolioSpec(members=mixed, export_cap_kw=1e9)
        with pytest.raises(ParameterError, match="horizon"):
            solve_portfolio(spec, backend="cpu")

    def test_profile_length_validated(self):
        spec = PortfolioSpec(members=_members(2, hours=48),
                             export_cap_kw=[1.0] * 7)
        with pytest.raises(ParameterError, match="profile has length"):
            solve_portfolio(spec, backend="cpu")


# ---------------------------------------------------------------------------
# Decomposition correctness vs the monolithic coupled LP
# ---------------------------------------------------------------------------

class TestDecomposition:
    def test_two_site_matches_monolithic_to_1e6(self):
        cap = _binding_cap()
        spec = PortfolioSpec(members=_members(), export_cap_kw=cap,
                             gap_tol=1e-9, feas_tol=1e-7, max_outer=60)
        res = solve_portfolio(spec, backend="cpu")
        mono = monolithic_reference(
            PortfolioSpec(members=_members(), export_cap_kw=cap))
        assert mono["status"] == 0
        assert res.converged
        rel = abs(res.primal_objective - mono["objective_cx"]) \
            / (1.0 + abs(mono["objective_cx"]))
        assert rel < 1e-6, (res.primal_objective, mono["objective_cx"])
        # the cap genuinely binds (otherwise this test proves nothing)
        assert res.certification["coupling_rows"]["export_cap"][
            "binding"] > 0
        # and the coupled optimum is strictly worse than uncoupled
        probe = solve_portfolio(
            PortfolioSpec(members=_members(), export_cap_kw=1e9,
                          max_outer=1), backend="cpu")
        assert res.primal_objective > probe.primal_objective + 1.0

    def test_coupling_feasible_at_termination_float64(self):
        cap = _binding_cap()
        res = solve_portfolio(
            PortfolioSpec(members=_members(), export_cap_kw=cap,
                          gap_tol=1e-9, feas_tol=1e-7, max_outer=60),
            backend="cpu")
        # float64 re-check of the blended aggregate, independent of the
        # engine's own bookkeeping
        viol = np.maximum(res.aggregate["net_export"] - cap, 0.0)
        assert float(viol.max()) <= 1e-6 * (1.0 + abs(cap))
        cert = res.certification
        validate_portfolio_certification(cert)
        assert cert["verdict"] in ("certified", "certified_loose")
        assert cert["inner_exact"] is True
        assert cert["gap_rel"] <= 1e-9 * 10

    def test_demand_charge_epigraph(self):
        # a portfolio demand charge prices the PEAK aggregate import;
        # the monolithic reference carries the same epigraph variable
        spec = PortfolioSpec(members=_members(), export_cap_kw=1e9,
                             demand_charge_per_kw=2.0,
                             gap_tol=1e-6, max_outer=60)
        res = solve_portfolio(spec, backend="cpu")
        assert res.converged
        peak_import = float(np.maximum(
            -res.aggregate["net_export"], 0.0).max())
        assert res.demand_charge_cost == pytest.approx(
            2.0 * peak_import, rel=1e-4)
        mono = monolithic_reference(
            PortfolioSpec(members=_members(), export_cap_kw=1e9,
                          demand_charge_per_kw=2.0))
        rel = abs(res.primal_objective - mono["objective_cx"]) \
            / (1.0 + abs(mono["objective_cx"]))
        assert rel < 1e-5

    def test_repeat_solve_byte_deterministic(self):
        cap = _binding_cap()

        def run():
            return solve_portfolio(
                PortfolioSpec(members=_members(), export_cap_kw=cap,
                              gap_tol=1e-9, feas_tol=1e-7,
                              max_outer=60), backend="cpu")

        a, b = run(), run()
        assert repr(a.primal_objective) == repr(b.primal_objective)
        assert a.outer_rounds == b.outer_rounds
        assert a.aggregate["net_export"].tobytes() == \
            b.aggregate["net_export"].tobytes()
        for kind in a.duals:
            assert a.duals[kind].tobytes() == b.duals[kind].tobytes()
        for key in a.site_solutions:
            for name, arr in a.site_solutions[key].items():
                assert arr.tobytes() == \
                    b.site_solutions[key][name].tobytes(), (key, name)


# ---------------------------------------------------------------------------
# Dual-iterate warm seeding (torch backend on the CPU device)
# ---------------------------------------------------------------------------

class TestDualWarmSeeding:
    @pytest.fixture(scope="class")
    def coupled(self):
        probe = solve_portfolio(
            PortfolioSpec(members=_members(4, hours=336, window=168),
                          export_cap_kw=1e9, max_outer=1),
            backend="torch", device="cpu")
        cap = float(probe.aggregate["net_export"].max()) - 2000.0
        res = solve_portfolio(
            PortfolioSpec(members=_members(4, hours=336, window=168),
                          export_cap_kw=cap, max_outer=10),
            backend="torch", device="cpu")
        return probe, res

    def test_rounds_after_first_are_dual_seeded(self, coupled):
        _, res = coupled
        assert res.converged
        assert len(res.rounds) >= 2
        for r in res.rounds[1:]:
            assert r["seeded"] == r["windows"]
            assert r["dual_iterate"] + r["substituted"] == r["windows"]

    def test_seeded_rounds_cut_iterations(self, coupled):
        probe, res = coupled
        cold = probe.rounds[0]["iters_p50"]
        late = [r["iters_p50"] for r in res.rounds[1:]]
        assert min(late) < cold / 1.5
        assert res.rounds[-1]["iters_p50"] < cold

    def test_zero_compiles_after_round_one(self, coupled):
        _, res = coupled
        assert sum(r["compile_events"] for r in res.rounds[1:]) == 0

    def test_all_site_windows_certified(self, coupled):
        _, res = coupled
        ps = res.certification["per_site"]
        assert ps["all_certified"] and ps["windows_total"] > 0
        validate_portfolio_section(res.run_health["portfolio"])
        assert res.solve_ledger["portfolio"]["converged"]


class TestDualIterateGrade:
    """The dual loop's warm-start fix: a dual update's uniform price shift
    moves every float16-quantized digest feature, so the near grade
    degrades — the dedicated ``dual_iterate`` hint grade must carry the
    reseeding instead."""

    def _lp(self, shift=0.0):
        from dervet_tpu_torch.benchlib import synthetic_case
        from dervet_tpu_torch.scenario.scenario import MicrogridScenario
        c = synthetic_case()
        ts = c.datasets.time_series
        c.datasets.time_series = ts.iloc[:48]
        c.scenario["allow_partial_year"] = True
        c.scenario["n"] = 24
        s = MicrogridScenario(c)
        ctx = s.windows[0]
        lp = s.build_window_lp(ctx)
        if shift:
            # the dual update's signature: every power-term cost entry
            # shifts by the (per-timestep) price — far past the float16
            # digest's ~3-significant-digit resolution
            lp.c = lp.c + shift
        return s, lp

    def test_price_shift_defeats_quant_digest_but_not_hint(self):
        from dervet_tpu_torch.ops.pdhg import PDHGOptions
        s, lp0 = self._lp()
        mem = warmstart.SolutionMemory(max_entries=16)
        opts = PDHGOptions()
        skey = ("struct",)
        tag = warmstart.opts_tag(opts)
        x = np.linspace(0.0, 1.0, lp0.n)
        y = np.linspace(0.0, 0.5, lp0.m)
        mem.store(skey, lp0, tag, x, y, 1.0)
        mem.store_hint(("portfolio", "rid", "siteA", 0), x, y, 1.0)

        _, lp1 = self._lp(shift=0.02)
        # WITHOUT the hint: the quantized digest moved — no near hit
        entry, kind, _, _ = mem.probe(skey, lp1, tag)
        assert kind != "near"   # feature-fallback or miss, never near
        # WITH the hint: the dedicated grade carries the reseed
        lp1.seed_hint = ("portfolio", "rid", "siteA", 0)
        plans = warmstart.plan_group(mem, skey, [lp1], opts, [0])
        assert plans[0].kind == "dual_iterate"
        assert plans[0].entry is not None
        assert np.array_equal(plans[0].entry.x, x)
        assert mem.stats["hits_dual"] >= 1

    def test_exact_hit_outranks_hint(self):
        from dervet_tpu_torch.ops.pdhg import PDHGOptions
        s, lp0 = self._lp()
        mem = warmstart.SolutionMemory(max_entries=16)
        opts = PDHGOptions()
        tag = warmstart.opts_tag(opts)
        x = np.zeros(lp0.n)
        y = np.zeros(lp0.m)
        mem.store(("k",), lp0, tag, x, y, 0.0)
        mem.store_hint(("h",), x + 1.0, y, 0.0)
        lp0.seed_hint = ("h",)
        plans = warmstart.plan_group(mem, ("k",), [lp0], opts, [0])
        assert plans[0].kind == "exact"

    def test_kill_switch_restores_cold(self, monkeypatch):
        monkeypatch.setenv("DERVET_TPU_WARMSTART", "0")
        assert not warmstart.enabled()

    def test_hint_table_bounded(self):
        mem = warmstart.SolutionMemory(max_entries=4)
        for i in range(12):
            mem.store_hint(("h", i), np.zeros(3), np.zeros(2), 0.0)
        assert mem.snapshot()["hint_entries"] <= 4
        assert mem.lookup_hint(("h", 11)) is not None
        assert mem.lookup_hint(("h", 0)) is None


# ---------------------------------------------------------------------------
# Fault matrix: coupling_infeasible + diverging_duals
# ---------------------------------------------------------------------------

class TestFaults:
    def test_coupling_infeasible_typed_error(self):
        # an aggregate import cap far below the fleet's must-serve load
        spec = PortfolioSpec(members=_members(), import_cap_kw=500.0,
                             max_outer=8)
        with pytest.raises(PortfolioInfeasibleError) as ei:
            solve_portfolio(spec, backend="cpu")
        err = ei.value
        assert err.kind == "portfolio_infeasible"
        assert err.violations
        worst = err.violations[0]
        assert worst["kind"] == "import_cap"
        assert worst["shortfall_kw"] > 0
        assert "import_cap" in str(err)
        # the typed record serializes for spool .error.json files
        assert json.dumps(err.as_dict())

    def test_infeasible_terminates_before_dual_loop(self):
        spec = PortfolioSpec(members=_members(), import_cap_kw=500.0,
                             max_outer=8)
        calls = []
        import dervet_tpu_torch.portfolio.solve as psolve
        orig = psolve.run_dispatch

        def counting(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        psolve.run_dispatch = counting
        try:
            with pytest.raises(PortfolioInfeasibleError):
                solve_portfolio(spec, backend="cpu")
        finally:
            psolve.run_dispatch = orig
        assert not calls    # pre-flight fired before any dispatch

    def test_diverging_duals_detected_rescaled_certified(self):
        probe = solve_portfolio(
            PortfolioSpec(members=_members(4, hours=336, window=168),
                          export_cap_kw=1e9, max_outer=1),
            backend="torch", device="cpu")
        cap = float(probe.aggregate["net_export"].max()) - 2000.0
        with faultinject.inject(diverge_duals_round=1,
                                diverge_duals_scale=25.0) as plan:
            res = solve_portfolio(
                PortfolioSpec(members=_members(4, hours=336,
                                               window=168),
                              export_cap_kw=cap, max_outer=14),
                backend="torch", device="cpu")
        assert ("diverging_duals", "1") in plan.fired
        assert res.dual_rescales >= 1
        assert any(r["regressed"] for r in res.rounds)
        assert res.converged
        assert res.certification["verdict"] in ("certified",
                                                "certified_loose")


# ---------------------------------------------------------------------------
# Service integration
# ---------------------------------------------------------------------------

class TestService:
    def test_submit_portfolio_round_trip_and_metrics(self):
        from dervet_tpu_torch.service import ScenarioService
        svc = ScenarioService(backend="torch", device="cpu", max_wait_s=0.0)
        try:
            probe = svc.submit_portfolio(
                PortfolioSpec(members=_members(4, hours=336,
                                               window=168),
                              export_cap_kw=1e9, max_outer=1),
                request_id="pf-probe")
            svc.run_once()
            cap = float(probe.result(0).aggregate["net_export"].max()) \
                - 2000.0
            fut = svc.submit_portfolio(
                PortfolioSpec(members=_members(4, hours=336,
                                               window=168),
                              export_cap_kw=cap, max_outer=10),
                request_id="pf-bind")
            served = svc.run_once()
            res = fut.result(0)
            assert served == 1 and res.converged
            assert res.fidelity == "certified"
            m = svc.metrics()["portfolio"]
            assert m["requests"] == 2
            assert m["dual_iterate_seeds"] > 0
            validate_portfolio_section(m["last"])
        finally:
            svc.close()

    def test_infeasible_request_answers_typed(self):
        from dervet_tpu_torch.service import ScenarioService
        svc = ScenarioService(backend="cpu", max_wait_s=0.0)
        try:
            fut = svc.submit_portfolio(
                PortfolioSpec(members=_members(), import_cap_kw=500.0,
                              max_outer=5),
                request_id="pf-bad")
            svc.run_once()
            with pytest.raises(PortfolioInfeasibleError):
                fut.result(0)
            assert svc.metrics()["portfolio"]["infeasible"] == 1
        finally:
            svc.close()

    def test_shed_degraded_portfolio_never_cert_stamped(self):
        from dervet_tpu_torch.service.queue import QueuedRequest
        spec = PortfolioSpec(members=_members(4, hours=336, window=168),
                             export_cap_kw=-800.0 * 4, max_outer=4)
        req = QueuedRequest("pf-shed", {}, kind="portfolio")
        req.portfolio_spec = spec
        rnd = PortfolioRound([req], backend="torch", device="cpu",
                             degraded_ids={"pf-shed"})
        rnd.run()
        res = req.future.result(0)
        assert res.fidelity == "degraded"
        assert res.resubmit_hint
        cert = res.certification
        assert cert["enabled"] is False
        assert cert["verdict"] == "not_certified"
        assert res.run_health["fidelity"] == "degraded"
        assert rnd.stats["degraded"] == 1

    def test_spool_round_trip(self, tmp_path):
        from dervet_tpu_torch.service.server import serve_main
        spool = tmp_path / "spool"
        (spool / "incoming").mkdir(parents=True)
        payload = {"portfolio": {
            "synthetic_members": {"sites": 2, "hours": 48,
                                  "window": 24},
            "export_cap_kw": _binding_cap(),
            "gap_tol": 5e-3,
            "max_outer": 40,
        }}
        (spool / "incoming" / "pfreq.json").write_text(
            json.dumps(payload))
        rc = serve_main([str(spool), "--backend", "cpu", "--once",
                         "--heartbeat-s", "0",
                         "--memory-export-s", "0"])
        assert rc == 0
        out = spool / "results" / "pfreq" / "portfolio.json"
        assert out.exists()
        rec = json.loads(out.read_text())
        assert rec["converged"]
        assert rec["certification"]["verdict"] in ("certified",
                                                   "certified_loose")
        assert (spool / "results" / "pfreq"
                / "portfolio_aggregate.csv").exists()
        assert (spool / "done" / "pfreq.json").exists()

    def test_parse_portfolio_request_validation(self):
        with pytest.raises(ParameterError, match="members"):
            parse_portfolio_request({"portfolio": {}})
        spec = parse_portfolio_request({"portfolio": {
            "synthetic_members": {"sites": 2, "hours": 48,
                                  "window": 24},
            "export_cap_kw": 100.0}})
        assert len(spec.members) == 2
        assert spec.export_cap_kw == 100.0


# ---------------------------------------------------------------------------
# Objective-component integrity under the price shift
# ---------------------------------------------------------------------------

class TestCouplingComponent:
    def test_breakdown_carries_coupling_label_and_reconciles(self):
        cap = _binding_cap()
        res = solve_portfolio(
            PortfolioSpec(members=_members(), export_cap_kw=cap,
                          gap_tol=1e-9, feas_tol=1e-7, max_outer=60),
            backend="cpu")
        assert any(res.duals["export_cap"] > 0)
        # true cost excludes the coupling-price component: the blend's
        # true cost must match the master objective exactly
        assert res.objective_cx == pytest.approx(
            res.primal_objective, abs=1e-9)

# ===========================================================================
# The JAX package's tests/test_portfolio_scale.py cases
# ===========================================================================

def _members_scale(n=8, hours=48, window=24, seed=0):
    return synthetic_portfolio_members(n, hours=hours, window=window,
                                       seed=seed, pv_kw=9000.0)


def _binding_cap_scale(n=8, hours=48, window=24, margin=1500.0):
    probe = solve_portfolio(
        PortfolioSpec(members=_members_scale(n, hours, window),
                      export_cap_kw=1e9, max_outer=1), backend="cpu")
    return float(probe.aggregate["net_export"].max()) - margin


def _assert_same_bytes(a, b):
    """Byte-level equality of two portfolio results (the fixed-plan
    parity contract: duals, aggregate, every site solution array)."""
    assert a.aggregate["net_export"].tobytes() == \
        b.aggregate["net_export"].tobytes()
    for kind in a.duals:
        assert a.duals[kind].tobytes() == b.duals[kind].tobytes(), kind
    for key, arrs in a.site_solutions.items():
        for name, arr in arrs.items():
            assert arr.tobytes() == \
                b.site_solutions[key][name].tobytes(), (key, name)


# ---------------------------------------------------------------------------
# Stabilized Dantzig-Wolfe master
# ---------------------------------------------------------------------------

class TestStabilization:
    def test_cuts_rounds_vs_control_16_sites(self, monkeypatch):
        """The smoke-shape acceptance gate: stabilization reaches the
        gap in STRICTLY fewer outer rounds than the three-regime control."""
        # margin 4000 kW: the cap binds hard enough that the control's
        # harmonic-decay tail is long (15 rounds vs 5 measured) — a
        # soft cap converges in 2 rounds both ways and gates nothing
        cap = _binding_cap_scale(16, margin=4000.0)
        spec = PortfolioSpec(members=_members_scale(16), export_cap_kw=cap,
                             gap_tol=1e-6, feas_tol=1e-7, max_outer=60)
        stab = solve_portfolio(spec, backend="cpu")
        monkeypatch.setenv("DERVET_TPU_PORTFOLIO_STABILIZE", "0")
        control = solve_portfolio(spec, backend="cpu")
        assert stab.converged and control.converged
        assert stab.stabilized and not control.stabilized
        assert stab.outer_rounds < control.outer_rounds, \
            (stab.outer_rounds, control.outer_rounds)
        # the round records say which regime each step ran
        regimes = {r["regime"] for r in stab.rounds}
        assert regimes & {"in_out_serious", "in_out_null",
                          "in_out_exact"}, regimes
        assert not any(str(r["regime"]).startswith("in_out")
                       for r in control.rounds)

    def test_monolithic_parity_preserved(self):
        """Stabilization must not move the answer: 2-site toy matches
        the monolithic HiGHS coupled LP to 1e-6 (the unstabilized loop's
        gate)."""
        cap = _binding_cap_scale(2, margin=800.0)
        spec = PortfolioSpec(members=_members_scale(2), export_cap_kw=cap,
                             gap_tol=1e-9, feas_tol=1e-7, max_outer=60)
        res = solve_portfolio(spec, backend="cpu")
        assert res.converged and res.stabilized
        mono = monolithic_reference(
            PortfolioSpec(members=_members_scale(2), export_cap_kw=cap))
        assert mono["status"] == 0
        rel = abs(res.primal_objective - mono["objective_cx"]) \
            / (1.0 + abs(mono["objective_cx"]))
        assert rel < 1e-6, (res.primal_objective, mono["objective_cx"])

    def test_kill_switch_matches_spec_off_bitwise(self, monkeypatch):
        """DERVET_TPU_PORTFOLIO_STABILIZE=0 and
        ``master_stabilization=False`` run the SAME legacy loop — the
        kill switch restores it bit for bit."""
        cap = _binding_cap_scale()
        spec_env = PortfolioSpec(members=_members_scale(), export_cap_kw=cap,
                                 gap_tol=1e-4, feas_tol=1e-6,
                                 max_outer=40)
        monkeypatch.setenv("DERVET_TPU_PORTFOLIO_STABILIZE", "0")
        a = solve_portfolio(spec_env, backend="cpu")
        monkeypatch.delenv("DERVET_TPU_PORTFOLIO_STABILIZE")
        spec_off = PortfolioSpec(members=_members_scale(), export_cap_kw=cap,
                                 gap_tol=1e-4, feas_tol=1e-6,
                                 max_outer=40,
                                 master_stabilization=False)
        b = solve_portfolio(spec_off, backend="cpu")
        assert not a.stabilized and not b.stabilized
        assert a.outer_rounds == b.outer_rounds
        _assert_same_bytes(a, b)

    def test_diverging_duals_converges_certified_stabilized(self):
        """The dual-corruption drill under the stabilized master: the
        non-monotone bound is detected, the step contracts toward the
        stability center, and the loop still converges + certifies."""
        probe = solve_portfolio(
            PortfolioSpec(members=_members_scale(4, hours=336, window=168),
                          export_cap_kw=1e9, max_outer=1),
            backend="torch", device="cpu")
        cap = float(probe.aggregate["net_export"].max()) - 2000.0
        with faultinject.inject(diverge_duals_round=1,
                                diverge_duals_scale=25.0) as plan:
            res = solve_portfolio(
                PortfolioSpec(members=_members_scale(4, hours=336,
                                               window=168),
                              export_cap_kw=cap, max_outer=14),
                backend="torch", device="cpu")
        assert ("diverging_duals", "1") in plan.fired
        assert res.stabilized
        assert res.dual_rescales >= 1
        assert res.converged
        assert res.certification["verdict"] in ("certified",
                                                "certified_loose")

    def test_section_schema_carries_new_fields(self):
        cap = _binding_cap_scale(2, margin=800.0)
        res = solve_portfolio(
            PortfolioSpec(members=_members_scale(2), export_cap_kw=cap,
                          gap_tol=1e-4, max_outer=20), backend="cpu")
        section = validate_portfolio_section(res.portfolio_section())
        assert section["stabilized"] is True
        assert section["shards"] == 1
        assert all("regime" in r and "shards" in r
                   for r in section["rounds"])


# ---------------------------------------------------------------------------
# The shard planner
# ---------------------------------------------------------------------------

class _FakeScen:
    def __init__(self, n_windows):
        self.windows = list(range(n_windows))


class TestShardPlanner:
    def test_deterministic_and_partitioning(self):
        scens = {f"s{i:02d}": _FakeScen(2) for i in range(10)}
        fps = {k: f"fp{i % 3}" for i, k in enumerate(sorted(scens))}
        a = plan_shards(scens, 3, fingerprints=fps)
        b = plan_shards(scens, 3, fingerprints=fps)
        assert a == b
        flat = sorted(k for shard in a for k in shard)
        assert flat == sorted(scens)
        assert len(a) == 3

    def test_structure_groups_stay_together(self):
        """Sites sharing a fingerprint co-batch — the planner keeps a
        group on one shard when it fits the per-shard target."""
        scens = {f"s{i}": _FakeScen(2) for i in range(6)}
        fps = {"s0": "A", "s1": "A", "s2": "A",
               "s3": "B", "s4": "B", "s5": "B"}
        plan = plan_shards(scens, 2, fingerprints=fps)
        assert len(plan) == 2
        shard_fps = [{fps[k] for k in shard} for shard in plan]
        assert all(len(s) == 1 for s in shard_fps), plan

    def test_clamps_to_site_count_and_drops_empty(self):
        scens = {f"s{i}": _FakeScen(1) for i in range(3)}
        fps = {k: "same" for k in scens}
        plan = plan_shards(scens, 8, fingerprints=fps)
        assert len(plan) <= 3
        assert sorted(k for s in plan for k in s) == sorted(scens)

    def test_one_shard_is_identity(self):
        scens = {f"s{i}": _FakeScen(1) for i in range(4)}
        assert plan_shards(scens, 1) == [sorted(scens)]

    def test_lpt_balances_window_cost(self):
        scens = {"big0": _FakeScen(8), "big1": _FakeScen(8),
                 "a": _FakeScen(1), "b": _FakeScen(1),
                 "c": _FakeScen(1), "d": _FakeScen(1)}
        fps = {k: k for k in scens}          # all distinct structures
        plan = plan_shards(scens, 2, fingerprints=fps)
        loads = [sum(len(scens[k].windows) for k in shard)
                 for shard in plan]
        assert max(loads) - min(loads) <= 2, (plan, loads)

    def test_spec_knobs(self, monkeypatch):
        spec = PortfolioSpec(members=_members_scale(4), export_cap_kw=1.0,
                             shards=3)
        assert spec.effective_shards(4) == 3
        assert spec.effective_shards(2) == 2     # clamped
        with pytest.raises(ParameterError, match="shards"):
            PortfolioSpec(members=_members_scale(2), export_cap_kw=1.0,
                          shards=0).validate()
        monkeypatch.setenv("DERVET_TPU_PORTFOLIO_SHARDS", "2")
        spec2 = PortfolioSpec(members=_members_scale(4), export_cap_kw=1.0)
        assert spec2.effective_shards(4) == 2    # env fills a None
        assert PortfolioSpec(members=_members_scale(4), export_cap_kw=1.0,
                             shards=1).effective_shards(4) == 1

    def test_merge_summaries_counters_and_weighted_p50(self):
        parts = [{"iters_p50": 100.0, "seeded": 2, "dual_iterate": 2,
                  "substituted": 0, "compile_events": 1, "windows": 6,
                  "iters_p50_seeded": 90.0, "iters_p50_cold": None},
                 {"iters_p50": 300.0, "seeded": 1, "dual_iterate": 1,
                  "substituted": 1, "compile_events": 0, "windows": 2,
                  "iters_p50_seeded": None, "iters_p50_cold": 320.0}]
        m = merge_summaries(parts)
        assert m["windows"] == 8 and m["seeded"] == 3
        assert m["compile_events"] == 1
        assert m["iters_p50"] == 100.0       # windows-weighted median


# ---------------------------------------------------------------------------
# Sharded-round parity (local executor)
# ---------------------------------------------------------------------------

class TestLocalShardParity:
    def test_sharded_byte_identical_to_monolithic(self):
        """For a fixed shard plan the per-site columns and costs are
        identical to the single-host path — cpu backend, so identical
        means BYTES."""
        cap = _binding_cap_scale()
        kw = dict(export_cap_kw=cap, gap_tol=1e-6, feas_tol=1e-7,
                  max_outer=40)
        mono = solve_portfolio(
            PortfolioSpec(members=_members_scale(), **kw), backend="cpu")
        shard = solve_portfolio(
            PortfolioSpec(members=_members_scale(), shards=3, **kw),
            backend="cpu")
        assert mono.converged and shard.converged
        assert shard.outer_rounds == mono.outer_rounds
        assert len(shard.shard_plan) == 3
        _assert_same_bytes(mono, shard)
        # per-round shard records carry the observability surface
        for r in shard.rounds:
            assert r["shards"] == 3
            assert len(r["shard_detail"]) == 3
            assert sum(d["sites"] for d in r["shard_detail"]) == 8

    def test_env_shards_override(self, monkeypatch):
        cap = _binding_cap_scale(4, margin=800.0)
        monkeypatch.setenv("DERVET_TPU_PORTFOLIO_SHARDS", "2")
        res = solve_portfolio(
            PortfolioSpec(members=_members_scale(4), export_cap_kw=cap,
                          gap_tol=1e-4, max_outer=30), backend="cpu")
        assert res.converged
        assert len(res.shard_plan) == 2


# ---------------------------------------------------------------------------
# Fleet-sharded rounds (real router over LocalReplica services)
# ---------------------------------------------------------------------------

class TestFleetShardedRounds:
    def _fleet(self, n=2):
        from dervet_tpu_torch.service.fleet import LocalReplica
        from dervet_tpu_torch.service.router import FleetRouter
        from dervet_tpu_torch.service.server import ScenarioService
        services = [ScenarioService(backend="cpu", max_wait_s=0.0)
                    for _ in range(n)]
        for s in services:
            s.start()
        reps = [LocalReplica(f"n{i}", s)
                for i, s in enumerate(services)]
        router = FleetRouter(reps, heartbeat_timeout_s=5.0,
                             hedging=False).start()
        return router, services

    def test_fleet_round_matches_monolithic_and_sticky(self):
        cap = _binding_cap_scale()
        kw = dict(export_cap_kw=cap, gap_tol=1e-6, feas_tol=1e-7,
                  max_outer=40)
        mono = solve_portfolio(
            PortfolioSpec(members=_members_scale(), **kw), backend="cpu")
        router, services = self._fleet()
        try:
            res = solve_portfolio(
                PortfolioSpec(members=_members_scale(), shards=2, **kw),
                backend="cpu", fleet=router, request_id="pfx")
        finally:
            router.close(terminate_replicas=False)
            for s in services:
                s.close()
        assert res.converged
        assert res.outer_rounds == mono.outer_rounds
        _assert_same_bytes(mono, res)
        # sticky shard->replica assignment: each shard index stays on
        # the replica that served it in round 0 (hint warmth +
        # compiled-program affinity live there)
        detail = [r["shard_detail"] for r in res.rounds]
        homes = {d["shard"]: d["replica"] for d in detail[0]}
        assert set(homes.values()) == {"n0", "n1"}   # shards spread
        for rnd in detail[1:]:
            for d in rnd:
                assert d["replica"] == homes[d["shard"]], detail
        # the replicas counted the shard rounds they served
        shard_reqs = sum(s.metrics()["portfolio"]["shard_requests"]
                        for s in services)
        assert shard_reqs == res.outer_rounds * 2

    def test_two_anonymous_solves_share_one_router(self):
        """Anonymous solves mint unique portfolio ids — shard rids must
        not collide with the router's exactly-once memo on a second
        solve (regression: both used to be 'pf.s00.r000')."""
        cap = _binding_cap_scale(4, margin=800.0)
        spec = PortfolioSpec(members=_members_scale(4), export_cap_kw=cap,
                             gap_tol=1e-4, max_outer=20, shards=2)
        router, services = self._fleet()
        try:
            a = solve_portfolio(spec, backend="cpu", fleet=router)
            b = solve_portfolio(spec, backend="cpu", fleet=router)
        finally:
            router.close(terminate_replicas=False)
            for s in services:
                s.close()
        assert a.converged and b.converged
        assert a.primal_objective == b.primal_objective

    def test_replica_honors_payload_backend(self):
        """The shard payload's backend wins on the replica — the owner
        stamped inner_exact from the backend it requested."""
        from dervet_tpu_torch.portfolio.shard import solve_portfolio_shard
        m = _members_scale(2)
        payload = {"sites": m, "price": np.zeros(48),
                   "seed_tag": "t", "shard": 0, "round": 0,
                   "backend": "cpu", "solver_opts": None}
        res = solve_portfolio_shard(payload)   # no explicit backend
        assert set(res.outcomes) == set(str(k) for k in m)

    def test_local_shards_share_caller_memory(self):
        from dervet_tpu_torch.portfolio.shard import LocalShardExecutor
        m = SolutionMemory(max_entries=4)
        ex = LocalShardExecutor({}, [[], []], backend="cpu", memory=m)
        assert all(c.memory is m for c in ex.caches)

    def test_shard_request_admission_validates(self):
        from dervet_tpu_torch.service.server import ScenarioService
        svc = ScenarioService(backend="cpu", max_wait_s=0.0)
        svc.start()
        try:
            with pytest.raises(ValueError, match="sites"):
                svc.submit_portfolio_shard({"sites": {}})
        finally:
            svc.close()


class TestShardCaseCache:
    """The shard case cache: the full site payload ships once; later dual
    rounds ship a reference (price + plan fingerprint) resolved against
    the replica's bounded case cache, and a cold replica's typed miss
    triggers exactly one full-payload reseed."""

    def _service(self):
        from dervet_tpu_torch.service.server import ScenarioService
        svc = ScenarioService(backend="cpu", max_wait_s=0.0)
        svc.start()
        return svc

    def test_reference_resolves_after_seed(self):
        svc = self._service()
        try:
            m = _members_scale(2)
            full = {"sites": m, "price": np.zeros(48), "seed_tag": "t",
                    "plan_fp": "fp1", "shard": 0, "round": 0,
                    "backend": "cpu", "solver_opts": None}
            res = svc.submit_portfolio_shard(full).result(timeout=300)
            ref = {k: v for k, v in full.items() if k != "sites"}
            ref["round"] = 1
            res2 = svc.submit_portfolio_shard(ref).result(timeout=300)
            assert set(res2.outcomes) == set(res.outcomes)
        finally:
            svc.close()

    def test_cold_reference_raises_typed_miss(self):
        from dervet_tpu_torch.utils.errors import ShardCacheMissError
        svc = self._service()
        try:
            with pytest.raises(ShardCacheMissError):
                svc.submit_portfolio_shard(
                    {"price": np.zeros(48), "seed_tag": "t",
                     "plan_fp": "never-seeded", "shard": 0,
                     "round": 1, "backend": "cpu",
                     "solver_opts": None})
        finally:
            svc.close()

    def test_plan_fp_mismatch_misses(self):
        # same seed_tag, DIFFERENT content fingerprint: the cache must
        # never resolve a stale site set for an edited portfolio
        from dervet_tpu_torch.utils.errors import ShardCacheMissError
        svc = self._service()
        try:
            m = _members_scale(2)
            svc.submit_portfolio_shard(
                {"sites": m, "price": np.zeros(48), "seed_tag": "t",
                 "plan_fp": "fp1", "shard": 0, "round": 0,
                 "backend": "cpu",
                 "solver_opts": None}).result(timeout=300)
            with pytest.raises(ShardCacheMissError):
                svc.submit_portfolio_shard(
                    {"price": np.zeros(48), "seed_tag": "t",
                     "plan_fp": "fp2-edited", "shard": 0, "round": 1,
                     "backend": "cpu", "solver_opts": None})
        finally:
            svc.close()

    def test_cache_is_bounded_lru(self):
        from dervet_tpu_torch.utils.errors import ShardCacheMissError
        svc = self._service()
        svc._shard_cases_cap = 1
        try:
            m = _members_scale(2)
            base = {"price": np.zeros(48), "shard": 0, "round": 0,
                    "backend": "cpu", "solver_opts": None}
            svc.submit_portfolio_shard(
                {**base, "sites": m, "seed_tag": "a",
                 "plan_fp": "fa"}).result(timeout=300)
            svc.submit_portfolio_shard(
                {**base, "sites": m, "seed_tag": "b",
                 "plan_fp": "fb"}).result(timeout=300)
            # "a" evicted by the 1-entry cap: its reference must miss
            with pytest.raises(ShardCacheMissError):
                svc.submit_portfolio_shard(
                    {**base, "seed_tag": "a", "plan_fp": "fa",
                     "round": 1})
        finally:
            svc.close()

    def test_executor_ref_rounds_and_miss_reseed(self):
        """End-to-end executor protocol: round 0 ships full payloads,
        round 1 ships references at a fraction of the bytes, and an
        evicted replica cache (cold after failover/restart) triggers a
        one-shot full reseed that restores the round."""
        from dervet_tpu_torch.portfolio.shard import FleetShardExecutor
        from dervet_tpu_torch.service.fleet import LocalReplica
        from dervet_tpu_torch.service.router import FleetRouter
        from dervet_tpu_torch.service.server import ScenarioService
        services = [ScenarioService(backend="cpu", max_wait_s=0.0)
                    for _ in range(2)]
        for s in services:
            s.start()
        reps = [LocalReplica(f"n{i}", s)
                for i, s in enumerate(services)]
        router = FleetRouter(reps, heartbeat_timeout_s=5.0,
                             hedging=False).start()
        try:
            m = _members_scale(4)
            keys = sorted(m, key=str)
            ex = FleetShardExecutor(
                m, [keys[:2], keys[2:]], router, backend="cpu",
                portfolio_id="pfc", deadline_s=300.0)
            assert all(fp is not None for fp in ex.plan_fps)
            price = np.zeros(48)
            r0 = ex.dispatch_round(price, 0)
            r1 = ex.dispatch_round(price, 1)
            assert all(not rec["ref_mode"] for rec in r0.shard_records)
            assert all(rec["ref_mode"] for rec in r1.shard_records)
            # the remainder's point: a reference round ships a small
            # fraction of the full payload's bytes
            assert ex.wire_bytes_rounds[1] < 0.2 * ex.wire_bytes_rounds[0]
            assert set(r1.outcomes) == set(r0.outcomes) == set(map(str,
                                                                   keys))
            # evict every replica's case cache (what a restart or a
            # failover-moved shard looks like), then round 2 reseeds
            for svc in services:
                with svc._shard_cases_lock:
                    svc._shard_cases.clear()
            r2 = ex.dispatch_round(price, 2)
            assert set(r2.outcomes) == set(r0.outcomes)
            assert ex.wire_bytes_rounds[2] > ex.wire_bytes_rounds[1]
            # and the NEXT round is back to cheap references
            r3 = ex.dispatch_round(price, 3)
            assert all(rec["ref_mode"] for rec in r3.shard_records)
            assert ex.wire_bytes_rounds[3] < 0.2 * ex.wire_bytes_rounds[2]
        finally:
            router.close(terminate_replicas=False)
            for s in services:
                s.close()


# ---------------------------------------------------------------------------
# dual_iterate hints ride the fleet memory handoff
# ---------------------------------------------------------------------------

class TestHintHandoff:
    def test_hints_round_trip_through_payload(self):
        m = SolutionMemory(max_entries=8)
        m.store_hint(("pf", "siteA", 0), np.arange(4.0),
                     np.arange(3.0), -1.5)
        m.store_hint(("pf", "siteB", 1), np.ones(4), np.zeros(3), -2.5)
        payload = pickle.loads(pickle.dumps(m.export_payload()))
        assert payload["hints"]
        m2 = SolutionMemory(max_entries=8)
        assert m2.import_payload(payload) == 0   # no primary entries
        assert m2.stats["imported_hints"] == 2
        e = m2.lookup_hint(("pf", "siteA", 0))
        assert e is not None
        assert np.array_equal(e.x, np.arange(4.0))
        assert np.array_equal(e.y, np.arange(3.0))
        assert m2.snapshot()["hint_entries"] == 2

    def test_local_hint_wins_over_import(self):
        m = SolutionMemory(max_entries=8)
        m.store_hint(("pf", "s", 0), np.zeros(2), np.zeros(1), 0.0)
        payload = m.export_payload()
        m2 = SolutionMemory(max_entries=8)
        m2.store_hint(("pf", "s", 0), np.ones(2), np.ones(1), 9.0)
        m2.import_payload(payload)
        assert np.array_equal(m2.lookup_hint(("pf", "s", 0)).x,
                              np.ones(2))

    def test_legacy_payloads_still_import(self):
        m = SolutionMemory(max_entries=8)
        m2 = SolutionMemory(max_entries=8)
        # bare entries list (replicas older than the seed models)
        assert m2.import_payload(m.export_entries()) == 0
        # dict without "hints" (replicas older than the hint table)
        assert m2.import_payload({"entries": [], "models": None}) == 0
        # malformed hint rows are skipped, good ones land — including
        # an UNHASHABLE key (nested list), which must not abort the
        # rest of the payload
        n = m2.import_hints([("bad", {"x": "nope"}),
                             (("t", ["site", 3]), {"x": np.zeros(1),
                                                   "y": np.zeros(1),
                                                   "obj": 0.0}),
                             (("ok",), {"x": np.zeros(1),
                                        "y": np.zeros(1),
                                        "obj": 1.0})])
        assert n == 1
        assert m2.lookup_hint(("ok",)) is not None

    def test_hint_table_stays_bounded_on_import(self):
        m = SolutionMemory(max_entries=4)
        for i in range(8):
            m.store_hint(("pf", i), np.zeros(1), np.zeros(1), 0.0)
        payload = m.export_payload()
        assert len(payload["hints"]) <= 4
        m2 = SolutionMemory(max_entries=4)
        m2.import_hints(payload["hints"])
        assert m2.snapshot()["hint_entries"] <= 4


# ===========================================================================
# The port against the JAX package, on the same inputs
# ===========================================================================

def _jax_pkg():
    from dervet_tpu.portfolio import PortfolioSpec as JaxSpec
    from dervet_tpu.portfolio import solve_portfolio as jax_solve
    from dervet_tpu.portfolio.service import \
        synthetic_portfolio_members as jax_members
    return JaxSpec, jax_solve, jax_members


def _spec_pair(n=4, hours=48, window=24, margin=800.0, **kw):
    JaxSpec, _, jax_members = _jax_pkg()
    cap = _binding_cap(n, hours, window, margin=margin)
    port = PortfolioSpec(members=_members(n, hours, window),
                         export_cap_kw=cap, **kw)
    ref = JaxSpec(members=jax_members(n, hours=hours, window=window,
                                      seed=0, pv_kw=9000.0),
                  export_cap_kw=cap, **kw)
    return port, ref


def test_cpu_backend_byte_identical_to_jax_package():
    """HiGHS inner solves and the same numpy master on both sides: the
    duals, the aggregate and the objective are the same bytes."""
    _, jax_solve, _ = _jax_pkg()
    port_spec, ref_spec = _spec_pair(max_outer=30, gap_tol=1e-4)
    a = solve_portfolio(port_spec, backend="cpu")
    b = jax_solve(ref_spec, backend="cpu")
    assert a.outer_rounds == b.outer_rounds and a.converged
    assert sorted(a.duals) == sorted(b.duals)
    for kind in a.duals:
        assert np.asarray(a.duals[kind]).tobytes() == \
            np.asarray(b.duals[kind]).tobytes(), kind
    for key in a.aggregate:
        assert np.asarray(a.aggregate[key]).tobytes() == \
            np.asarray(b.aggregate[key]).tobytes(), key
    assert float(a.objective_total) == float(b.objective_total)


def test_torch_backend_against_jax_backend():
    """The port's plain PDHG path against the JAX package's jax backend
    on 4 sites x 48 h of 24-hour windows: the same outer rounds (+-1),
    objectives within the portfolio's gap tolerance, every window
    certified on both sides."""
    _, jax_solve, _ = _jax_pkg()
    port_spec, ref_spec = _spec_pair(max_outer=20, gap_tol=1e-3)
    a = solve_portfolio(port_spec, backend="torch", device="cpu")
    b = jax_solve(ref_spec, backend="jax")
    assert a.converged and b.converged
    assert abs(a.outer_rounds - b.outer_rounds) <= 1, \
        (a.outer_rounds, b.outer_rounds)
    gap = abs(a.objective_total - b.objective_total) \
        / max(abs(b.objective_total), 1.0)
    assert gap <= port_spec.gap_tol, gap
    for res in (a, b):
        ps = res.certification["per_site"]
        assert ps["all_certified"] and ps["windows_total"] == 8


def test_dual_round_keeps_its_seeds_with_a_small_memory(monkeypatch):
    """A 2-entry warm-start memory (``DERVET_TPU_WARMSTART_CAP``): the JAX
    package's dual loop evicts its own dual-iterate hints mid-round, and
    later rounds seed those windows from a poorer grade; the port raises
    the memory to hold the whole round (2 x 8 windows + 64) and seeds
    every window of every round after the first from its own previous
    iterate (or substitutes it)."""
    _, jax_solve, _ = _jax_pkg()
    monkeypatch.setenv("DERVET_TPU_WARMSTART_CAP", "2")
    port_spec, ref_spec = _spec_pair(max_outer=20, gap_tol=1e-3)
    a = solve_portfolio(port_spec, backend="torch", device="cpu")
    b = jax_solve(ref_spec, backend="jax")
    assert len(a.rounds) >= 2 and len(b.rounds) >= 2
    for r in a.rounds[1:]:
        assert r["dual_iterate"] + r["substituted"] == r["windows"] == 8, r
    # the JAX package's later rounds fall back to a poorer grade (the
    # nearest stored entry) for the windows whose hints were evicted
    assert any(r["dual_iterate"] + r["substituted"] < r["windows"]
               for r in b.rounds[1:]), \
        [(r["dual_iterate"], r["substituted"], r["windows"])
         for r in b.rounds]


def test_device_none_is_the_gpu():
    """``device=None`` resolves to ``cuda:0``: without a GPU the solve
    raises before any dispatch (the exact backend takes no device)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: device=None would run on it")
    spec = PortfolioSpec(members=_members(), export_cap_kw=1e9,
                         max_outer=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_portfolio(spec)
    assert solve_portfolio(spec, backend="cpu").outer_rounds == 1
