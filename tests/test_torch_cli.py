"""``python -m dervet_tpu_torch`` against ``python -m dervet_tpu``.

A reference-format model-parameters CSV with its time series, tariff
and load-shed files (Battery + PV + ICE; DA, retail energy and demand
charges, Reliability; two months) goes through both CLIs' ``main`` on
exact HiGHS: every output CSV is byte-identical, and so are the
``design`` and ``montecarlo`` subcommands' deterministic artifacts.  The
port's CLI exits 75 when a run is preempted; every subcommand of the JAX
package is ported (each exits from its own parser's usage error without
arguments), ``portfolio`` prints the same summary and writes the same
CSVs as the JAX package's on exact HiGHS; ``serve --once`` on the CPU
device serves a spool and exits 0, and ``status`` and ``trace`` read
what it published.
"""
import filecmp
import subprocess
import sys

import pandas as pd
import pytest
import torch

import dervet_tpu.__main__ as jax_cli
import dervet_tpu_torch.__main__ as cli
from dervet_tpu_torch import benchlib
from dervet_tpu_torch.utils.errors import PreemptedError

torch.set_num_threads(2)


def _write_case(d):
    """The case's files under ``d``; returns the parameters CSV path."""
    ts = benchlib.synthetic_case(multi_der=True,
                                 reliability=True).datasets.time_series
    ts = ts.loc[ts.index.month <= 2]
    # the loader takes hour-ENDING stamps (it shifts back by dt)
    ts.set_axis(ts.index + pd.Timedelta(hours=1)).rename_axis(
        "Datetime (he)").to_csv(d / "ts.csv")
    benchlib.synthetic_tariff().to_csv(d / "tariff.csv")
    benchlib.load_shed_curve().to_csv(d / "shed.csv", index=False)
    rows = [
        ("Scenario", "", "dt", "1", "float"),
        ("Scenario", "", "opt_years", "[2017]", "list/int"),
        ("Scenario", "", "n", "month", "string/int"),
        ("Scenario", "", "start_year", "2017", "period"),
        ("Scenario", "", "end_year", "2017", "period"),
        ("Scenario", "", "allow_partial_year", "1", "bool"),
        ("Scenario", "", "incl_site_load", "1", "bool"),
        ("Scenario", "", "time_series_filename", "ts.csv", "string"),
        ("Finance", "", "npv_discount_rate", "7", "float"),
        ("Finance", "", "inflation_rate", "3", "float"),
        ("Finance", "", "customer_tariff_filename", "tariff.csv", "string"),
        ("Battery", "1", "ch_max_rated", "2000", "float"),
        ("Battery", "1", "dis_max_rated", "2000", "float"),
        ("Battery", "1", "ene_max_rated", "8000", "float"),
        ("Battery", "1", "rte", "85", "float"),
        ("Battery", "1", "llsoc", "5", "float"),
        ("Battery", "1", "ulsoc", "100", "float"),
        ("Battery", "1", "soc_target", "50", "float"),
        ("PV", "1", "rated_capacity", "3000", "float"),
        ("PV", "1", "curtail", "1", "bool"),
        ("ICE", "1", "rated_capacity", "1000", "float"),
        ("ICE", "1", "n", "2", "int"),
        ("ICE", "1", "efficiency", "11", "float"),
        ("ICE", "1", "fuel_cost", "2.5", "float"),
        ("ICE", "1", "variable_om_cost", "0.004", "float"),
        ("ICE", "1", "ccost_kW", "600", "float"),
        ("DA", "", "growth", "0", "float"),
        ("retailTimeShift", "", "growth", "0", "float"),
        ("DCM", "", "growth", "0", "float"),
        ("Reliability", "", "target", "4", "float"),
        ("Reliability", "", "max_outage_duration", "12", "int"),
        ("Reliability", "", "post_facto_only", "0", "bool"),
        ("Reliability", "", "post_facto_initial_soc", "100", "float"),
        ("Reliability", "", "load_shed_percentage", "1", "bool"),
        ("Reliability", "", "load_shed_perc_filename", "shed.csv",
         "string"),
    ]
    df = pd.DataFrame(rows, columns=["Tag", "ID", "Key", "Value", "Type"])
    df["Active"] = "yes"
    path = d / "params.csv"
    df.to_csv(path, index=False)
    return path


def test_cli_csvs_byte_identical(tmp_path):
    params = _write_case(tmp_path)
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    jax_cli.main([str(params), "--backend", "cpu", "--out", str(out_j)])
    res = cli.main([str(params), "--backend", "cpu", "--device", "cpu",
                    "--out", str(out_t), "--gitlab-ci"])
    assert res.run_health["windows"]["clean"] == 2
    names = sorted(p.name for p in out_t.iterdir()
                   if not p.name.startswith("run_health"))
    ref = sorted(p.name for p in out_j.iterdir()
                 if not p.name.startswith("run_health"))
    assert names == ref
    for want in ("timeseries_results", "load_coverage_prob",
                 "adv_monthly_bill", "demand_charges", "pro_forma", "npv"):
        assert any(n.startswith(want) for n in names), want
    match, mismatch, errors = filecmp.cmpfiles(out_j, out_t, names,
                                               shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_cli_exits_75_when_preempted(tmp_path, monkeypatch):
    params = _write_case(tmp_path)

    def preempted(self, **kw):
        raise PreemptedError("stop requested (signal 15)")

    monkeypatch.setattr("dervet_tpu_torch.api.DERVET.solve", preempted)
    with pytest.raises(SystemExit) as exc:
        cli.main([str(params), "--backend", "cpu", "--device", "cpu"])
    assert exc.value.code == 75


# the JAX package's subcommands beside solve, design and montecarlo
JAX_SUBCOMMANDS = ("serve", "portfolio", "fleet", "status", "trace")


@pytest.mark.parametrize("sub", JAX_SUBCOMMANDS)
def test_unported_subcommands_exit_nonzero(sub, capsys):
    """Called without arguments, each of the JAX package's subcommands
    exits non-zero from its own parser's usage error: every one is
    ported now (``portfolio`` and ``fleet`` were the last)."""
    with pytest.raises(SystemExit) as exc:
        cli.main([sub])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not ported" not in err
    assert f"usage: dervet_tpu_torch {sub}" in err


def test_unported_subcommands_are_the_fleet_and_portfolio(tmp_path, capsys):
    """No subcommand is left unported, and ``portfolio`` on a 2-site
    request with ``--backend cpu --device cpu`` prints the same summary
    JSON and writes byte-identical CSVs as ``python -m dervet_tpu
    portfolio --backend cpu``."""
    import json

    from dervet_tpu_torch.portfolio import PortfolioSpec, solve_portfolio
    from dervet_tpu_torch.portfolio.service import \
        synthetic_portfolio_members
    assert cli.UNPORTED_SUBCOMMANDS == ()
    shape = {"sites": 2, "hours": 48, "window": 24}
    probe = solve_portfolio(PortfolioSpec(
        members=synthetic_portfolio_members(2, hours=48, window=24),
        export_cap_kw=1e9, max_outer=1), backend="cpu")
    cap = float(probe.aggregate["net_export"].max()) - 800.0
    req = tmp_path / "folio.json"
    req.write_text(json.dumps({"portfolio": {
        "synthetic_members": shape, "export_cap_kw": cap,
        "max_outer": 20, "gap_tol": 1e-4}}))
    out_t, out_j = tmp_path / "torch", tmp_path / "jax"
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        cli.main(["portfolio", str(req), "--backend", "cpu", "--device",
                  "cpu", "--out", str(out_t)])
    assert exc.value.code == 0
    summary_t = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with pytest.raises(SystemExit) as exc:
        jax_cli.main(["portfolio", str(req), "--backend", "cpu", "--out",
                      str(out_j)])
    assert exc.value.code == 0
    summary_j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary_t.pop("out") == str(out_t)
    assert summary_j.pop("out") == str(out_j)
    assert summary_t == summary_j and summary_t["converged"]
    csvs = sorted(p.name for p in out_j.glob("*.csv"))
    assert csvs and csvs == sorted(p.name for p in out_t.glob("*.csv"))
    match, mismatch, errors = filecmp.cmpfiles(out_t, out_j, csvs,
                                               shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_serve_status_trace_subcommands(tmp_path, capsys):
    """``serve SPOOL --once`` on the CPU device serves a pickled request
    and exits 0; ``status`` reads its heartbeat and telemetry, ``trace``
    stitches the request's exported span tree; both exit 0."""
    import pickle
    spool = tmp_path / "spool"
    (spool / "incoming").mkdir(parents=True)
    cases = dict(enumerate(benchlib.synthetic_sensitivity_cases(
        2, months=1)))
    (spool / "incoming" / "req1.pkl").write_bytes(
        pickle.dumps({"cases": cases, "priority": 0}))
    with pytest.raises(SystemExit) as exc:
        cli.main(["serve", str(spool), "--once", "--backend", "torch",
                  "--device", "cpu", "--heartbeat-s", "0.05"])
    assert exc.value.code == 0
    out = spool / "results" / "req1"
    assert (out / "run_health.req1.json").exists()
    assert (out / "trace.req1.json").exists()
    assert (spool / "done" / "req1.pkl").exists()
    assert (spool / "heartbeat.json").exists()
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        cli.main(["status", str(spool)])
    assert exc.value.code == 0
    table = capsys.readouterr().out
    assert "completed 1" in table
    with pytest.raises(SystemExit) as exc:
        cli.main(["trace", "req1", str(spool)])
    assert exc.value.code == 0
    tree = capsys.readouterr().out
    assert "request" in tree and "batch_round" in tree
    with pytest.raises(SystemExit) as exc:
        cli.main(["trace", "nobody", str(spool)])
    assert exc.value.code == 3


def test_module_entry_point_leaves_jax_unloaded():
    code = ("import sys, runpy; sys.argv = ['x', 'serve']\n"
            "try:\n"
            "    runpy.run_module('dervet_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    print(e.code, sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'dervet_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.split() == ["2", "[]"], (out.stdout, out.stderr)


# the design and Monte-Carlo artifacts without wall-clock content
# (design_frontier.json's ``screen`` block and run_health*.json carry
# seconds and rates)
DETERMINISTIC = {"design": ["design_population.csv", "design_frontier.csv"],
                 "montecarlo": ["mc_samples.csv", "mc_distribution.json"]}
SUB_ARGS = {"design": ["--bounds", "kw=500:2500,kwh=1000:9000",
                       "--population", "4", "--top-k", "2"],
            "montecarlo": ["--samples", "4", "--seed", "7", "--alpha",
                           "0.75", "--quantiles", "0.5"]}


@pytest.mark.parametrize("sub", sorted(DETERMINISTIC))
def test_subcommand_artifacts_byte_identical(sub, tmp_path):
    params = _write_case(tmp_path)
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    with pytest.raises(SystemExit) as exc:
        jax_cli.main([sub, str(params), *SUB_ARGS[sub], "--backend", "cpu",
                      "--out", str(out_j)])
    assert exc.value.code == 0
    with pytest.raises(SystemExit) as exc:
        cli.main([sub, str(params), *SUB_ARGS[sub], "--backend", "cpu",
                  "--device", "cpu", "--out", str(out_t)])
    assert exc.value.code == 0
    names = DETERMINISTIC[sub]
    match, mismatch, errors = filecmp.cmpfiles(out_j, out_t, names,
                                               shallow=False)
    assert match == names, (mismatch, errors)
    assert sorted(p.name for p in out_t.iterdir()) == \
        sorted(p.name for p in out_j.iterdir())


@pytest.mark.parametrize("sub,entry", [
    ("design", "dervet_tpu_torch.design.frontier.run_design"),
    ("montecarlo", "dervet_tpu_torch.stochastic.engine.run_montecarlo")])
def test_subcommand_exits_75_when_preempted(sub, entry, tmp_path,
                                            monkeypatch):
    params = _write_case(tmp_path)

    def preempted(*a, **kw):
        raise PreemptedError("stop requested (signal 15)")

    monkeypatch.setattr(entry, preempted)
    with pytest.raises(SystemExit) as exc:
        cli.main([sub, str(params), *SUB_ARGS[sub], "--backend", "cpu",
                  "--device", "cpu"])
    assert exc.value.code == 75
