"""No process of the benchmark holds JAX or the JAX package, compared by
whole top-level names; the reference holds nothing of the program
either."""
import json
import subprocess
import sys

from benchmark import core
from benchmark.tests.conftest import ROOT

REFERENCE = ["benchmark.reference.lp", "benchmark.series"] + [
    f"benchmark.reference.parts.{p.stem}"
    for p in (ROOT / "benchmark/reference/parts").glob("[A-Z]*.py")]
HARNESS = ["benchmark.run", "benchmark.core", "benchmark.trace",
           "benchmark.roofline", "benchmark.drivers.sweep",
           "benchmark.drivers.fanout", "dervet_tpu_torch",
           "dervet_tpu_torch.api", "dervet_tpu_torch.benchlib",
           "dervet_tpu_torch.ops.pdhg", "dervet_tpu_torch.scenario.scenario"]


def loaded(modules):
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_names_are_compared_whole():
    mods = {"dervet_tpu_torch": 1, "dervet_tpu_torch.ops": 1,
            "jaxtyping": 1, "benchmark": 1, "bench_x": 1}
    assert core.forbidden_modules(mods) == []
    assert core.forbidden_modules({"jax.numpy": 1, "bench": 1,
                                   "dervet_tpu.ops": 1}) == [
        "bench", "dervet_tpu.ops", "jax.numpy"]


def test_reference_loads_nothing_of_the_program_or_jax():
    top = loaded(REFERENCE)
    assert not top & (set(core.FORBIDDEN) | {"dervet_tpu_torch", "torch"})


def test_harness_and_port_load_no_jax():
    top = loaded(HARNESS)
    assert "dervet_tpu_torch" in top
    assert not top & set(core.FORBIDDEN)
