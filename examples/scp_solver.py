#!/usr/bin/env python3
"""Acceptance demo for the modeling API — the Python counterpart of the
reference's examples/scp_solver.cpp:10-137: parse an SCP file, build the
model via MakeBoolVar / MakeRowConstraint / SetMinimization, Solve(), and
print status / objective / dual bound / gap / selected columns.

Usage:  python examples/scp_solver.py <scp-file> [--lp-only]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from sypha import read_scp_file
from sypha.api import ResultStatus, Solver


def main(argv):
    if len(argv) < 2:
        print(f"usage: {argv[0]} <scp-file> [--lp-only]", file=sys.stderr)
        return 2
    path = argv[1]
    lp_only = "--lp-only" in argv[2:]

    model = read_scp_file(path)
    print(f"Parsed {path}: {model.nrows} rows x {model.ncols} columns")

    solver = Solver("scp_solver_example")
    solver.parameters().verbosity = 1
    solver.parameters().disable_bnb = lp_only

    xs = [solver.MakeBoolVar(f"x{j}") for j in range(model.ncols)]
    objective = solver.MutableObjective()
    for x, cost in zip(xs, model.costs):
        objective.SetCoefficient(x, float(cost))
    objective.SetMinimization()
    for row in model.rows:
        ct = solver.MakeRowConstraint(1.0, Solver.infinity())
        for j in row:
            ct.SetCoefficient(xs[int(j)], 1.0)

    status = solver.Solve()

    print(f"Status:       {status.value}")
    print(f"Objective:    {solver.objective_value():.10g}")
    print(f"Dual bound:   {solver.dual_objective_value():.10g}")
    print(f"MIP gap:      {solver.mip_gap():.6g}")
    print(f"Iterations:   {solver.iterations()}")
    print(f"Nodes:        {solver.nodes()}")
    print(f"Wall time:    {solver.wall_time():.2f}s")
    if status in (ResultStatus.OPTIMAL, ResultStatus.FEASIBLE) and not lp_only:
        chosen = [j for j, x in enumerate(xs) if x.solution_value() > 0.5]
        print(f"Selected columns ({len(chosen)}): {chosen}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
