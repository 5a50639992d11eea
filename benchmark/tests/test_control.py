"""The cells' control on the card: the program at its screening
tolerances with certification off, the nearest lower precision it has
(its kernels are float32 only).  It has to come out not correct, where
the program as configured comes out correct.  A test's size: the full
year, 50 price scenarios a pass, 4 cases a fan-out.

    python -m pytest -p no:cacheprovider benchmark/tests/test_control.py
"""
import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT, small_root

CELLS = ["sweep-bess_pv_da-1000", "fanout-microgrid_ice_chp_rel-32",
         "fanout-bess_pv_da-64"]


def drive(root, cell, seed, *extra):
    out = subprocess.run(
        [sys.executable, str(root / "benchmark/run.py"), "--workload", cell,
         "--seed", str(seed), "--seconds", "2", *extra],
        cwd=root, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, cuda, tmp_path):
    root = small_root(tmp_path, months=12, scenarios=50, cases=4)
    assert drive(root, cell, 2 ** 31 + 5)["correct"]
    assert not drive(root, cell, 2 ** 31 + 5, "--control",
                     "screening")["correct"]
