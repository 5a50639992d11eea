"""Portfolio co-optimization: dual-decomposed coupled-site LPs on the
batch axis (see solve.py for the architecture notes).  Public surface:
:class:`PortfolioSpec` (members + coupling constraints),
:func:`solve_portfolio` (the one-shot engine),
:class:`PortfolioResult`, and the spool/service helpers in
``portfolio.service``."""
from ..utils.errors import PortfolioInfeasibleError
from .solve import (PortfolioResult, monolithic_reference,
                    solve_portfolio, validate_portfolio_section)
from .spec import COUPLING_KINDS, COUPLING_LABEL, CouplingRows, \
    PortfolioSpec

__all__ = [
    "COUPLING_KINDS", "COUPLING_LABEL", "CouplingRows",
    "PortfolioInfeasibleError", "PortfolioResult", "PortfolioSpec",
    "monolithic_reference", "solve_portfolio",
    "validate_portfolio_section",
]
