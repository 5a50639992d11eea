"""Sample order on fresh caches, in both packages on the CPU.

``chip_smoke.py`` phase 9 runs 256 Monte-Carlo samples in order and in
reversed order on fresh caches; on the H100 the two differ by up to
5.0e-10 relative.  On the CPU, at the JAX package's test size (a 72-hour
``synthetic_case``), both packages give bit-equal per-sample objectives
and the same tiers for the two orders, so that difference is not a port
fault: it is the card's floating-point reduction order by batch position
(a row's sum or norm over a (B, m) tensor), which moves with the row's
position in the batch.
"""
import numpy as np
import pytest
import torch

from dervet_tpu import benchlib as jax_benchlib
from dervet_tpu import design as jax_design
from dervet_tpu import stochastic as jax_mc
from dervet_tpu.scenario.scenario import SolverCache as JaxSolverCache
from dervet_tpu_torch import benchlib, design, stochastic as mc
from dervet_tpu_torch.ops.pdhg import PDHGOptions
from dervet_tpu_torch.scenario.scenario import SolverCache

torch.set_num_threads(2)

SAMPLES = 256


def _case(pkg, hours=72):
    c = pkg.synthetic_case(seed=0)
    c.scenario["allow_partial_year"] = True
    c.datasets.time_series = c.datasets.time_series.iloc[:hours]
    return c


def _run(name, order):
    """One run on fresh caches configured as the smoke's: a screening
    cache set and a padded final cache sharing its warm-start memory."""
    if name == "jax":
        caches = jax_design.ScreeningCaches()
        final = JaxSolverCache(pad_grid=True, memory=caches.memory)
        return jax_mc.run_montecarlo(
            _case(jax_benchlib), jax_mc.MCSpec(n_samples=SAMPLES, seed=0),
            backend="jax", caches=caches, final_cache=final,
            sample_order=order)
    caches = design.ScreeningCaches(device="cpu")
    final = SolverCache(pad_grid=True, memory=caches.memory, device="cpu")
    return mc.run_montecarlo(
        _case(benchlib), mc.MCSpec(n_samples=SAMPLES, seed=0),
        backend="torch", device="cpu",
        solver_opts=PDHGOptions(cpu_rescue_after=None), caches=caches,
        final_cache=final, sample_order=order)


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_sample_order_on_fresh_caches_is_bit_equal(name):
    a = _run(name, None).samples
    b = _run(name, list(range(SAMPLES))[::-1]).samples
    assert len(a) == SAMPLES
    assert list(a["tier"]) == list(b["tier"])
    assert "certified" in set(a["tier"])
    np.testing.assert_array_equal(a["objective"].to_numpy(),
                                  b["objective"].to_numpy())
