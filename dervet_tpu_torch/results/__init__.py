"""Results registry and CSV reporting."""
from .result import Result, CaseResult
