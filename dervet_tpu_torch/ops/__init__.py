from .lp import LP, LPBuilder, VarRef
from .pdhg import CompiledLPSolver, PDHGOptions, PDHGResult, solve_lp
from .cpu_ref import solve_lp_cpu

__all__ = [
    "LP", "LPBuilder", "VarRef",
    "CompiledLPSolver", "PDHGOptions", "PDHGResult", "solve_lp",
    "solve_lp_cpu",
]
