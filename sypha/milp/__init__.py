from sypha.milp.base_model import BaseModel
from sypha.milp.presolve import (
    greedy_set_cover,
    apply_presolve_rules,
    incumbent_budget_pruning,
)
from sypha.milp.heuristics import (
    nearest_integer_fixing,
    dual_guided_cover_repair,
    select_branch_variable,
)
from sypha.milp.cuts import separate_cuts
from sypha.milp.bnb import branch_and_bound, MilpResult

__all__ = [
    "BaseModel",
    "greedy_set_cover",
    "apply_presolve_rules",
    "incumbent_budget_pruning",
    "nearest_integer_fixing",
    "dual_guided_cover_repair",
    "select_branch_variable",
    "separate_cuts",
    "branch_and_bound",
    "MilpResult",
]
