#!/usr/bin/env python3
"""LP parity checker — counterpart of the reference's
benchmark/test_cuda_solver.py (:142-153): solve LP relaxations and compare
primal/dual against the reference implementation's golden values at
0.1% relative / 0.01 absolute tolerance.  Uses the golden tables (the
reference's own committed numbers) so no OR-Tools install is needed; pass
--scipy to cross-check against scipy.optimize.linprog (HiGHS) as the
independent oracle instead.

Usage: python benchmark/lp_parity.py [--families scp4,scp5] [--scipy]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DATA_DIR = os.environ.get("SYPHA_DATA_DIR", "/root/reference/data")
REL_TOL = 0.001  # 0.1% (reference test_cuda_solver.py)
ABS_TOL = 0.01


def scipy_lp(model):
    import numpy as np
    from scipy.optimize import linprog

    A = model.dense_matrix()
    res = linprog(
        model.costs,
        A_ub=-A,
        b_ub=-np.ones(model.nrows),
        bounds=[(0, None)] * model.ncols,
        method="highs",
    )
    return res.fun


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", default="scp4,scp5")
    ap.add_argument("--scipy", action="store_true", help="use scipy as oracle")
    ap.add_argument(
        "--csv-dir",
        default="",
        help="write per-family CSVs (reference scp4_sypha_results.csv "
        "schema: benchmark/results/scp4_sypha_results.csv) with solve "
        "times split from compile (first solve of each padded bucket "
        "compiles; warm wall time is the honest per-LP number)",
    )
    args = ap.parse_args()

    from sypha import pad_lp, read_scp_file, solve_lp
    from sypha.config import IpmOptions
    from sypha.core.status import IpmStatus
    from sypha.testing import GOLDEN_LP

    from benchmark.run_benchmark import FAMILIES

    import csv
    import time

    failures = 0
    checked = 0
    for fam in args.families.split(","):
        rows = []
        for name in FAMILIES.get(fam.strip(), []):
            path = os.path.join(DATA_DIR, f"{name}.txt")
            if not os.path.exists(path):
                continue
            model = read_scp_file(path)
            t0 = time.monotonic()
            res = solve_lp(pad_lp(model), IpmOptions())
            t_first = time.monotonic() - t0
            # warm re-solve: compile + transfer excluded — the honest
            # per-LP latency (first solve of a new padded bucket pays a
            # one-time XLA compile, reported as wall_time_s)
            t1 = time.monotonic()
            res = solve_lp(pad_lp(model), IpmOptions())
            t_warm = time.monotonic() - t1
            ref = scipy_lp(model) if args.scipy else GOLDEN_LP.get(name)
            if ref is None:
                continue
            checked += 1
            # the reference's parity tool (benchmark/test_cuda_solver.py:
            # 142-153) checks VALUES only at 0.1% rel / 0.01 abs, and its
            # golden tables accept 1e-4; we additionally require a clean
            # status, accepting GAP_STALLED lanes whose duality gap still
            # reached <= 1e-5.  Measured: scpnrh1 stalls at gap 2.5e-6
            # with res_p 1.8e-9 / res_d 2.3e-12 even under a full-f64
            # factor — a Mehrotra endgame stall on the degenerate optimal
            # face, not a linear-algebra precision limit; objective values
            # stay golden-exact.  Status+gap are recorded in the CSV.
            ok_status = res.status == IpmStatus.CONVERGED or (
                res.status == IpmStatus.GAP_STALLED and res.gap <= 1e-5
            )
            tol = max(ABS_TOL, REL_TOL * abs(ref))
            ok_p = abs(res.primal_objective - ref) <= tol
            ok_d = abs(res.dual_objective - ref) <= tol
            verdict = "PASS" if (ok_status and ok_p and ok_d) else "FAIL"
            if verdict == "FAIL":
                failures += 1
            print(
                f"{name:<10} ref={ref:>14.6f} primal={res.primal_objective:>14.6f} "
                f"dual={res.dual_objective:>14.6f} iters={res.iterations:>3} "
                f"warm={t_warm:.3f}s {verdict}"
            )
            gap = abs(res.primal_objective - res.dual_objective) / max(
                1.0, abs(res.primal_objective)
            )
            rows.append(
                {
                    "instance": f"{name}.txt",
                    "exit_code": 0 if verdict == "PASS" else 1,
                    "sypha_primal": f"{res.primal_objective:.6f}",
                    "sypha_dual": f"{res.dual_objective:.6f}",
                    "sypha_gap_pct": f"{gap * 100:.6f}",
                    "sypha_iterations": int(res.iterations),
                    "sypha_total_time_s": f"{t_warm:.3f}",
                    "wall_time_s": f"{t_first:.3f}",
                    "status": res.status.name,
                }
            )
        if args.csv_dir and rows:
            os.makedirs(args.csv_dir, exist_ok=True)
            out = os.path.join(
                args.csv_dir, f"{fam.strip()}_sypha_lp_results.csv"
            )
            with open(out, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
                w.writeheader()
                w.writerows(rows)
            print(f"wrote {out}")
    print(f"\n{checked - failures}/{checked} passed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
