"""Design: BOOST ordinal-optimization sizing.

Screen a large candidate population with cheap loose-tolerance batched
solves (certification off, thread-local), exactly solve + certify only
the top-k, and return a ranked certified :class:`DesignFrontier` —
population generation in ``population.py``, the ordinal screen in
``screen.py``, certified finalists + the result object in
``frontier.py``, and the one-shot CLI in ``cli.py``.
"""
from .frontier import (DesignFrontier, build_frontier, certify_finalists,
                       dominated_mask, run_design, spearman_rank)
from .population import (Candidate, DERBounds, DesignSpec, candidate_case,
                         generate_population, halton)
from .screen import (SCREEN_TIERS, ScreeningCaches, ScreenReport,
                     screen_candidates, screening_options)

__all__ = [
    "Candidate", "DERBounds", "DesignFrontier", "DesignSpec",
    "SCREEN_TIERS", "ScreenReport", "ScreeningCaches", "build_frontier",
    "candidate_case", "certify_finalists", "dominated_mask",
    "generate_population", "halton", "run_design", "screen_candidates",
    "screening_options", "spearman_rank",
]
