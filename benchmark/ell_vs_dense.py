#!/usr/bin/env python3
"""Measure the padded-ELL sparse operator vs the dense operator on the
large (500x5000) Beasley families: operator memory, LP wall time, and
objective parity (VERDICT r1 item 5: 'measured memory/throughput vs
dense', matching src/sypha_solver_krylov.cu:305-329 semantics).

Writes benchmark/results/ell_vs_dense.csv and prints a summary.

Usage: python benchmark/ell_vs_dense.py [--lanes 8] [--instances scpnre1,...]
"""

import argparse
import csv
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

DATA_DIR = os.environ.get("SYPHA_DATA_DIR", "/root/reference/data")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument(
        "--instances",
        default="scpnre1,scpnrf1,scpnrg1,scpnrh1",
    )
    ap.add_argument(
        "--strategy", default="dense", choices=["dense", "cg"],
        help="linear-solver strategy for BOTH operators ('dense' = f32 "
        "Gram-factor preconditioner; 'cg' = pure Jacobi-CG, the "
        "reference Krylov path)",
    )
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "results"))
    args = ap.parse_args()

    import numpy as np
    import jax

    from sypha import pad_lp, read_scp_file
    from sypha.config import IpmOptions
    from sypha.ipm.shared import (
        make_shared_batch,
        make_shared_batch_sparse,
        mehrotra_solve_shared,
    )

    opts = IpmOptions(linear_solver=args.strategy)
    rows = []
    for name in args.instances.split(","):
        model = read_scp_file(os.path.join(DATA_DIR, f"{name.strip()}.txt"))
        sp = make_shared_batch_sparse(model, args.lanes)
        dn = make_shared_batch(
            pad_lp(model, m_pad=sp.m_pad, n_pad=sp.n_pad), args.lanes
        )
        ell = sp.A
        ell_bytes = sum(
            int(np.prod(a.shape)) * a.dtype.itemsize
            for a in (ell.row_idx, ell.row_val, ell.col_idx, ell.col_val)
        )
        dense_bytes = ell.m_pad * ell.n_pad * 8

        solve = jax.jit(lambda b: mehrotra_solve_shared(b, opts))
        rec = {"instance": name, "lanes": args.lanes,
               "strategy": args.strategy,
               "ell_mb": round(ell_bytes / 1e6, 2),
               "dense_mb": round(dense_bytes / 1e6, 2),
               "mem_ratio": round(dense_bytes / ell_bytes, 2)}
        for tag, batch in (("dense", dn), ("sparse", sp)):
            st = solve(batch)
            jax.device_get(st.status)  # compile + warm
            t0 = time.perf_counter()
            st = solve(batch)
            status = np.asarray(jax.device_get(st.status))
            dt = time.perf_counter() - t0
            obj = float(
                np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st.x))[0]
            )
            rec[f"{tag}_s"] = round(dt, 4)
            rec[f"{tag}_obj"] = round(obj, 6)
            rec[f"{tag}_conv"] = int((status == 1).sum())
        rec["speed_ratio_sparse_over_dense"] = round(
            rec["dense_s"] / rec["sparse_s"], 3
        )
        rows.append(rec)
        print(rec, flush=True)

    os.makedirs(args.out, exist_ok=True)
    out_csv = os.path.join(args.out, "ell_vs_dense.csv")
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {out_csv}")


if __name__ == "__main__":
    main()
