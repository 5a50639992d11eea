from .lp import LP, LPBuilder, VarRef
from .pdhg import CompiledLPSolver, PDHGOptions, PDHGResult
from .cpu_ref import solve_lp_cpu
