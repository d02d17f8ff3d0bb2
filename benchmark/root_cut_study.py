"""Root cut-round study: dual-bound progression per separation round.

Measures what the root cut rounds are worth on the LP-bound-limited
families (nrg/nrh/clr root gaps 15-42%): solve the root LP, separate,
append, re-solve, and report the dual bound + wall per round.  Bypasses
the driver's cut_skip_gap policy so the new zerohalf separator can be
graded on the instances the policy currently skips.

Usage:
    python benchmark/root_cut_study.py data/scpnrh1.txt --rounds 6
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from sypha import read_scp_file
from sypha.config import SolverConfig
from sypha.milp.base_model import BaseModel, BranchNode
from sypha.milp.bnb import _NodeLpSolver
from sypha.milp.cuts import separate_cuts
from sypha.utils.logging import Logger


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("instance")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--max-cuts", type=int, default=24)
    ap.add_argument("--deadline", type=float, default=600.0)
    ap.add_argument("--iters", type=int, default=0, help="total IPM iteration budget per solve (0 = opts.max_iter)")
    ap.add_argument(
        "--separators",
        default="all",
        help="all | zerohalf (zerohalf-only isolates the new family)",
    )
    ap.add_argument(
        "--dump-points",
        default="",
        help="npz path prefix: save the LP point (x, y) of every round "
        "for offline separator grading on CPU",
    )
    args = ap.parse_args()

    model = read_scp_file(args.instance)
    base = BaseModel(model)
    cfg = SolverConfig(verbosity=0)
    log = Logger(verbosity=0)
    solver = _NodeLpSolver(base, cfg, log)
    ipm_opts = cfg.ipm.replace(newton_max_steps=max(cfg.ipm.newton_max_steps, 48))

    deadline = time.monotonic() + args.deadline
    rows = []
    total_cuts = 0
    for rnd in range(args.rounds + 1):
        t0 = time.monotonic()
        res = solver.solve_nodes(
            [BranchNode()], ipm_opts, deadline,
            total_iters=args.iters or None,
        )[0]
        solve_s = time.monotonic() - t0
        dual = float(res["dobj"])
        rows.append(
            {
                "round": rnd,
                "dual": dual,
                "pobj": float(res["pobj"]),
                "status": str(res["status"]),
                "cuts_total": total_cuts,
                "solve_s": round(solve_s, 2),
            }
        )
        print(json.dumps(rows[-1]), flush=True)
        if args.dump_points:
            np.savez_compressed(
                f"{args.dump_points}_r{rnd}.npz",
                x=np.asarray(res["x"]),
                y=np.asarray(res["y"]),
                dual=dual,
            )
        if rnd == args.rounds or time.monotonic() > deadline:
            break
        t1 = time.monotonic()
        if args.separators == "zerohalf":
            from sypha.milp.cuts import zero_half_mod2

            cuts = zero_half_mod2(
                base, res["x"], res["y"], 1e-6, max_cuts=args.max_cuts
            )
        else:
            cuts = separate_cuts(
                base, res["x"], res["y"], 1e-6, max_cuts=args.max_cuts
            )
        room = solver.room_for_cuts()
        cuts = cuts[:room]
        sep_s = time.monotonic() - t1
        print(
            json.dumps(
                {"round": rnd, "separated": len(cuts), "room": room,
                 "sep_s": round(sep_s, 2)}
            ),
            flush=True,
        )
        if not cuts:
            break
        base.add_cuts(cuts)
        total_cuts += len(cuts)
        solver.refresh()


if __name__ == "__main__":
    main()
