"""The benchmark as data: ``BENCHMARK.json`` at the root of the checkout
names each cell's configuration, traffic mix and metrics, and every one of
them is a file of its own that this module finds by its name:

* a configuration: the ``file`` its ``configs`` entry names
  (``benchmark/configs/<name>.json``);
* a traffic mix: ``benchmark/traffic/<traffic>.json``, whose ``kind``
  names the loop that drives it, ``benchmark/drivers/<kind>.py``;
* a metric: its reader, ``benchmark/metrics/<name>.py``;
* a cell's correctness limits: ``benchmark/limits/<cell>.json``.

A cell, a configuration, a mix or a metric is added by adding files and
entries, without editing a file that is there.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
# top-level module names that no process of the benchmark may hold: JAX
# and the JAX package (the port, dervet_tpu_torch, is another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "dervet_tpu", "bench")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` with everything its files hold."""
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"({sorted(by_name)})")
    w = by_name[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic"
                          / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in reported)]
    limits = json.loads((root / "benchmark" / "limits"
                         / f"{workload}.json").read_text())
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer,
                limits)


def driver(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def reader(name: str, root: Path = ROOT):
    """The reader module of metric ``name`` (a file name may hold dots)."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(metrics: list, data: dict, root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of every metric whose reader finds
    something to read; a reader that finds nothing leaves its metric out."""
    out = {}
    for m in metrics:
        v = reader(m["name"], root).read(data)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def judge_limits(numbers: dict, limits: dict) -> dict:
    """{number: {"value", "limit"}} for each number a cell compares."""
    return {k: {"value": float(numbers[k]), "limit": float(limits[k])}
            for k in limits}


def within(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
