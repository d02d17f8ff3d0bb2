from sypha.ipm.dense import IpmState, initial_point, mehrotra_solve
from sypha.ipm.driver import solve_lp, solve_lp_batch, IpmResult

__all__ = [
    "IpmState",
    "initial_point",
    "mehrotra_solve",
    "solve_lp",
    "solve_lp_batch",
    "IpmResult",
]
