"""Shared fixtures of the benchmark's own tests (``python -m pytest
benchmark/tests``; the card's tests are marked ``cuda``)."""
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def small_root(tmp: Path, months: int, scenarios: int, cases: int) -> Path:
    """A checkout root whose cells are the committed ones cut to a test's
    size: ``months`` months of each configuration, ``scenarios`` price
    scenarios a sweep pass, ``cases`` cases a fan-out, few checks."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["months"] = months
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        t = json.loads((ROOT / "benchmark" / "traffic"
                        / f"{w['traffic']}.json").read_text())
        if t["kind"] == "sweep":
            t.update(scenarios=scenarios, warmup_passes=1,
                     check_instances=4)
        else:
            t.update(cases=cases, check_windows=8)
        (bench / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return small_root(tmp_path, months=1, scenarios=2, cases=2)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible")
    return torch.device("cuda", 0)
