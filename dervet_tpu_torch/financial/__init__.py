"""Financial post-processing (CBA/proforma/NPV)."""
from .cba import CostBenefitAnalysis
