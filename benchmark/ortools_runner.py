#!/usr/bin/env python3
"""Live OR-Tools parity runner (VERDICT r3 item 9).

Counterpart of the reference's ``benchmark/ortools_solver.py`` +
``benchmark.py`` pipeline (reference: benchmark/ortools_solver.py:1-174):
solves SCP instances fresh with GLOP (LP relaxation) and SCIP (integer
program) and writes a CSV in the reference's
``benchmark_results_with_ip.csv`` schema, so the parity tables in the
README can be regenerated from a live baseline instead of the committed
reference CSVs.

ortools is NOT installed in the build environment — every entry point
degrades gracefully: ``have_ortools()`` is False, solves return
``SOLVER_UNAVAILABLE`` rows, and the CLI exits with a clear message.
``tests/test_ortools_runner.py`` importorskips accordingly, so the
harness is self-contained on machines that do have ortools.

Usage:
  python benchmark/ortools_runner.py --instances scp41,scp42 \
      [--data-dir /root/reference/data] [--time-limit 300] [--out results]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time
from typing import Dict, Optional

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from sypha.io.scp_reader import read_scp_file  # noqa: E402

CSV_COLUMNS = [
    "instance",
    "num_sets",
    "num_elements",
    "lp_status",
    "lp_objective",
    "lp_solve_time",
    "ip_status",
    "ip_objective",
    "ip_solve_time",
    "ip_gap",
    "error",
]


def have_ortools() -> bool:
    try:
        import ortools.linear_solver.pywraplp  # noqa: F401

        return True
    except ImportError:
        return False


def _status_name(pywraplp, status: int) -> str:
    return {
        pywraplp.Solver.OPTIMAL: "OPTIMAL",
        pywraplp.Solver.FEASIBLE: "FEASIBLE",
        pywraplp.Solver.INFEASIBLE: "INFEASIBLE",
        pywraplp.Solver.UNBOUNDED: "UNBOUNDED",
        pywraplp.Solver.ABNORMAL: "ABNORMAL",
        pywraplp.Solver.NOT_SOLVED: "NOT_SOLVED",
    }.get(status, "UNKNOWN")


def solve_scp_ortools(
    model,
    integer: bool,
    time_limit_sec: Optional[float] = None,
) -> Dict:
    """Solve one ScpModel with OR-Tools: GLOP relaxation or SCIP IP.

    One builder covers both modes (the model differs only in variable
    integrality and backend); constraints come straight from the
    row-wise ``model.rows`` adjacency — no per-element set scan.
    Returns {'status', 'objective', 'solve_time', 'gap', 'solution'}.
    """
    if not have_ortools():
        return {
            "status": "SOLVER_UNAVAILABLE",
            "objective": None,
            "solve_time": 0.0,
            "gap": None,
            "solution": None,
        }
    from ortools.linear_solver import pywraplp

    solver = pywraplp.Solver.CreateSolver("SCIP" if integer else "GLOP")
    if solver is None:
        return {
            "status": "SOLVER_UNAVAILABLE",
            "objective": None,
            "solve_time": 0.0,
            "gap": None,
            "solution": None,
        }
    if time_limit_sec is not None:
        solver.SetTimeLimit(int(time_limit_sec * 1000))

    mk = solver.BoolVar if integer else (
        lambda name: solver.NumVar(0.0, 1.0, name)
    )
    x = [mk(f"x{j}") for j in range(model.ncols)]

    obj = solver.Objective()
    for j, cj in enumerate(model.costs):
        obj.SetCoefficient(x[j], float(cj))
    obj.SetMinimization()

    for i, cols in enumerate(model.rows):
        ct = solver.Constraint(1.0, solver.infinity(), f"row{i}")
        for j in cols:
            ct.SetCoefficient(x[int(j)], 1.0)

    t0 = time.time()
    status = solver.Solve()
    solve_time = time.time() - t0

    name = _status_name(pywraplp, status)
    solved = status in (pywraplp.Solver.OPTIMAL, pywraplp.Solver.FEASIBLE)
    objective = obj.Value() if solved else None
    gap = None
    if integer and solved:
        try:
            bound = obj.BestBound()
            if objective:
                gap = abs(objective - bound) / abs(objective)
        except AttributeError:
            pass
    solution = [x[j].solution_value() for j in range(model.ncols)] if solved else None
    return {
        "status": name,
        "objective": objective,
        "solve_time": solve_time,
        "gap": gap,
        "solution": solution,
    }


def run_instance(path: str, time_limit_sec: float) -> Dict:
    """LP + IP on one instance file -> one reference-schema CSV row."""
    name = os.path.basename(path)
    row: Dict = {c: "" for c in CSV_COLUMNS}
    row["instance"] = name
    try:
        model = read_scp_file(path)
    except Exception as exc:  # unparseable file -> error column
        row["error"] = f"parse: {exc}"
        return row
    row["num_sets"] = model.ncols
    row["num_elements"] = model.nrows
    lp = solve_scp_ortools(model, integer=False, time_limit_sec=time_limit_sec)
    row["lp_status"] = lp["status"]
    row["lp_objective"] = "" if lp["objective"] is None else lp["objective"]
    row["lp_solve_time"] = lp["solve_time"]
    ip = solve_scp_ortools(model, integer=True, time_limit_sec=time_limit_sec)
    row["ip_status"] = ip["status"]
    row["ip_objective"] = "" if ip["objective"] is None else ip["objective"]
    row["ip_solve_time"] = ip["solve_time"]
    row["ip_gap"] = "" if ip["gap"] is None else ip["gap"]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--instances",
        required=True,
        help="comma-separated instance stems (scp41) or file paths",
    )
    ap.add_argument("--data-dir", default="/root/reference/data")
    ap.add_argument("--time-limit", type=float, default=300.0)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "results"))
    args = ap.parse_args(argv)

    if not have_ortools():
        print(
            "ortools is not installed; this runner needs it for a live "
            "GLOP/SCIP baseline. Parity against the reference's committed "
            "CSVs is covered by tests/test_ortools_parity.py instead.",
            file=sys.stderr,
        )
        return 2

    paths = []
    for stem in args.instances.split(","):
        stem = stem.strip()
        if os.path.exists(stem):
            paths.append(stem)
        else:
            paths.append(os.path.join(args.data_dir, f"{stem}.txt"))

    os.makedirs(args.out, exist_ok=True)
    out_path = os.path.join(args.out, "ortools_live_results.csv")
    with open(out_path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=CSV_COLUMNS)
        writer.writeheader()
        for p in paths:
            row = run_instance(p, args.time_limit)
            writer.writerow(row)
            fh.flush()
            print(
                f"{row['instance']}: LP {row['lp_status']} "
                f"{row['lp_objective']} | IP {row['ip_status']} "
                f"{row['ip_objective']}"
            )
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
