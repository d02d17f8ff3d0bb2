#!/usr/bin/env python3
"""Benchmark runner — counterpart of the reference's benchmark harness
(benchmark/benchmark.py + run_sypha_benchmark.sh): solves instance families
LP + MILP and writes CSVs with the reference's schemas
(benchmark/results/sypha_results.csv columns).

Usage:
  python benchmark/run_benchmark.py [--families scp4,scp5] [--lp-only]
      [--time-limit 120] [--out results]
"""

import argparse
import csv
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

FAMILIES = {
    "scp4": [f"scp4{i}" for i in range(1, 10)] + ["scp410"],
    "scp5": [f"scp5{i}" for i in range(1, 10)] + ["scp510"],
    "scpa": [f"scpa{i}" for i in range(1, 6)],
    "scpb": [f"scpb{i}" for i in range(1, 6)],
    "scpnre": [f"scpnre{i}" for i in range(1, 6)],
    "scpnrf": [f"scpnrf{i}" for i in range(1, 6)],
    "scpnrg": [f"scpnrg{i}" for i in range(1, 6)],
    "scpnrh": [f"scpnrh{i}" for i in range(1, 6)],
    # unicost families (the reference commits no MILP results for these)
    "scpclr": [f"scpclr{i}" for i in range(10, 14)],
    "scpcyc": ["scpcyc06", "scpcyc07"],
}

DATA_DIR = os.environ.get("SYPHA_DATA_DIR", "/root/reference/data")

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", default="scp4,scp5")
    ap.add_argument(
        "--instances",
        default="",
        help="comma-separated instance names (e.g. scp48,scp49) to restrict "
        "the sweep to; rows for other instances are untouched if --merge",
    )
    ap.add_argument(
        "--merge",
        action="store_true",
        help="merge the new rows into an existing output CSV instead of "
        "overwriting it (keyed by instance name)",
    )
    ap.add_argument("--lp-only", action="store_true")
    ap.add_argument("--time-limit", type=float, default=120.0)
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "results"))
    ap.add_argument(
        "--no-warmup",
        action="store_true",
        help="skip the per-family warmup run (first instance, untimed) that "
        "compiles every executable shape before the timed sweeps; without "
        "it, the one-time XLA compiles land inside the first instance's "
        "timings",
    )
    args = ap.parse_args()

    from sypha import pad_lp, read_scp_file, solve_lp
    from sypha.config import BnbOptions, IpmOptions, SolverConfig
    from sypha.core.status import IpmStatus, MilpStatus
    from sypha.milp.bnb import branch_and_bound

    os.makedirs(args.out, exist_ok=True)
    mode = "lp" if args.lp_only else "milp"
    fam_tag = args.families.replace(",", "_")
    out_csv = os.path.join(args.out, f"sypha_{mode}_{fam_tag}_results.csv")

    rows = []
    for fam in args.families.split(","):
        fam_names = [
            n
            for n in FAMILIES.get(fam.strip(), [])
            if os.path.exists(os.path.join(DATA_DIR, f"{n}.txt"))
        ]
        keep = {s.strip() for s in args.instances.split(",") if s.strip()}
        if keep:
            fam_names = [n for n in fam_names if n in keep]
        if fam_names and not args.no_warmup:
            # warmup: run the family's first instance once, untimed, so
            # every executable shape (node-window rungs, chunked/resume
            # variants) is compiled before the timed sweep
            wname = fam_names[0]
            t_w = time.monotonic()
            wm = read_scp_file(os.path.join(DATA_DIR, f"{wname}.txt"))
            if args.lp_only:
                solve_lp(pad_lp(wm), IpmOptions())
            else:
                wcfg = SolverConfig(
                    verbosity=1,
                    bnb=BnbOptions(
                        hard_time_limit_sec=min(30.0, args.time_limit),
                    ),
                )
                branch_and_bound(wm, wcfg)
            print(
                f"[{fam}] warmup on {wname}: {time.monotonic() - t_w:.1f}s "
                "(compiles; excluded from timed rows)"
            )
        for name in fam_names:
            path = os.path.join(DATA_DIR, f"{name}.txt")
            t0 = time.monotonic()
            model = read_scp_file(path)
            t_pre = time.monotonic() - t0

            t1 = time.monotonic()
            t_compile = 0.0
            if args.lp_only:
                res = solve_lp(pad_lp(model), IpmOptions())
                t_solver = time.monotonic() - t1
                status = (
                    "OPTIMAL" if res.status == IpmStatus.CONVERGED else res.status.name
                )
                row = dict(
                    instance=f"{name}.txt",
                    num_sets=model.ncols,
                    num_elements=model.nrows,
                    primal=f"{res.primal_objective:.10g}",
                    dual=f"{res.dual_objective:.10g}",
                    mip_gap_pct="",
                    iterations=res.iterations,
                    incumbent="",
                    status=status,
                )
            else:
                cfg = SolverConfig(
                    verbosity=1,
                    bnb=BnbOptions(
                        hard_time_limit_sec=args.time_limit,
                    ),
                )
                r = branch_and_bound(model, cfg)
                t_solver = time.monotonic() - t1
                t_compile = r.compile_time_sec
                status = {
                    MilpStatus.OPTIMAL: "OPTIMAL",
                    MilpStatus.FEASIBLE: "FEASIBLE",
                    MilpStatus.NOT_SOLVED: "NO_INCUMBENT",
                }.get(r.status, "ERROR")
                row = dict(
                    instance=f"{name}.txt",
                    num_sets=model.ncols,
                    num_elements=model.nrows,
                    primal=f"{r.objective:.10g}",
                    dual=f"{r.dual_bound:.10g}",
                    mip_gap_pct=f"{r.mip_gap * 100.0:.6f}",
                    iterations=r.total_lp_iterations,
                    incumbent=f"{r.objective:.10g}",
                    status=status,
                )
            row["time_pre_s"] = f"{t_pre:.2f}"
            # time_solver_s is NET of one-time XLA compiles: the solver
            # extends its hard deadline by exactly its precompile seconds
            # (reference C++ is AOT-compiled; its budget never pays
            # compilation), reported separately in time_compile_s
            row["time_solver_s"] = f"{t_solver - t_compile:.2f}"
            row["time_compile_s"] = f"{t_compile:.2f}"
            row["time_total_s"] = f"{time.monotonic() - t0:.2f}"
            rows.append(row)
            print(
                f"{name}: {row['status']} primal={row['primal']} "
                f"dual={row['dual']} solver={row['time_solver_s']}s "
                f"compile={row['time_compile_s']}s total={row['time_total_s']}s"
            )
            # incremental: a crash mid-sweep must not lose completed rows
            _write_csv(out_csv, rows, args.merge)

    _write_csv(out_csv, rows, args.merge)
    print(f"wrote {out_csv} ({len(rows)} rows)")


FIELDS = [
    "instance", "num_sets", "num_elements", "primal", "dual",
    "mip_gap_pct", "iterations", "time_pre_s", "time_solver_s",
    "time_compile_s", "time_total_s", "incumbent", "status",
]
_MERGE_BASE = {}


def _write_csv(out_csv, rows, merge):
    """(Re)write the CSV from the completed rows so far.  With --merge the
    pre-existing file's rows are the base and completed rows replace them
    by instance; the base is snapshotted on first write so incremental
    rewrites do not merge against themselves."""
    if merge and out_csv not in _MERGE_BASE:
        _MERGE_BASE[out_csv] = (
            list(csv.DictReader(open(out_csv, newline="")))
            if os.path.exists(out_csv)
            else []
        )
    out_rows = list(rows)
    if merge:
        new_by_name = {r["instance"]: r for r in out_rows}
        merged = [
            new_by_name.pop(r["instance"], r) for r in _MERGE_BASE[out_csv]
        ]
        out_rows = merged + list(new_by_name.values())
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=FIELDS)
        w.writeheader()
        w.writerows(out_rows)


if __name__ == "__main__":
    main()
