"""BENCHMARK.json keeps to its contract, and every name in it resolves to
the files of its own that hold it; a cell added from files and one entry
alone is found."""
import json
import re
import shutil

from benchmark import core
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    return core.load_spec(ROOT)


def test_shape():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"] and 1 <= s["run_seconds"] <= 51
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        for key in ("source", "why"):
            assert 1 <= len(c[key]) <= 200
            assert "\n" not in c[key] and "\t" not in c[key]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    names = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        names.add(w["name"])
    pairs = {(w["config"], w["traffic"]) for w in s["workloads"]}
    assert len(pairs) == len(s["workloads"])
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", names)) <= names
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in s["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    assert len(json.dumps(s)) <= 64 * 1024


def test_every_cell_resolves_and_reports_enough():
    s = spec()
    for w in s["workloads"]:
        cell = core.resolve(s, w["name"], ROOT)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        assert core.driver(cell.traffic["kind"]).run
        assert set(cell.limits) <= {"obj_gap", "prim_viol"}
        for m in cell.end_to_end + cell.per_layer:
            assert callable(core.reader(m["name"], ROOT).read)
        for m in cell.per_layer:
            assert m["moves"] in e2e


def test_a_cell_added_from_files_is_found(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    s = spec()
    s["workloads"].append({"name": "sweep-bess_pv_da-250", "chips": 1,
                           "config": "bess_pv_da", "traffic": "sweep-250",
                           "why": "a quarter of the north star's scenarios"})
    for m in s["end_to_end"] + s["per_layer"]:
        if "sweep-bess_pv_da-1000" in m.get("workloads", ()):
            m["workloads"].append("sweep-bess_pv_da-250")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    t = json.loads((ROOT / "benchmark/traffic/sweep-1000.json").read_text())
    t["scenarios"] = 250
    (tmp_path / "benchmark/traffic/sweep-250.json").write_text(json.dumps(t))
    shutil.copy(tmp_path / "benchmark/limits/sweep-bess_pv_da-1000.json",
                tmp_path / "benchmark/limits/sweep-bess_pv_da-250.json")
    cell = core.resolve(core.load_spec(tmp_path), "sweep-bess_pv_da-250",
                        tmp_path)
    assert cell.traffic["scenarios"] == 250
    assert cell.config["name"] == "bess_pv_da"
    assert {m["name"] for m in cell.end_to_end} == {
        "sweep_windows_per_s", "sweep_pass_p90_s", "setup_s"}
    assert "pdhg_roofline.sweep" in {m["name"] for m in cell.per_layer}


def test_result_line_shape():
    checks = core.judge_limits({"obj_gap": 1e-6, "prim_viol": 2e-5},
                               {"prim_viol": 1e-4})
    line = core.result_line(True, 12000, 0, {"setup_s": {"value": 20.5,
                                                         "unit": "s"}},
                            {"platform": "gpu", "kind": "NVIDIA H100",
                             "count": 1, "memory_peak_bytes": 1},
                            checks, {"device_ops": [], "idle_gaps": []})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["checks"] == {"prim_viol": {"value": 2e-5, "limit": 1e-4}}
    assert core.within(checks)
    assert not core.within(core.judge_limits({"prim_viol": 2e-4},
                                             {"prim_viol": 1e-4}))
