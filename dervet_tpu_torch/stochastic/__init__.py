"""Monte-Carlo valuation under uncertainty.

One scenario request becomes 10^3-10^4 sampled variants — deterministic
seeded perturbations of the price/load/solar trajectories — solved as a
single batch through the dispatch pipeline, with distributional outputs
(NPV/objective quantiles, mean, CVaR-alpha) and a risk-aware CVaR axis on
the BOOST design frontier."""
from .distribution import MCDistribution, cvar, distribution_stats
from .engine import run_montecarlo
from .sampler import MCSpec, sample_case, sample_seed

__all__ = ["MCSpec", "MCDistribution", "run_montecarlo", "sample_case",
           "sample_seed", "cvar", "distribution_stats"]
