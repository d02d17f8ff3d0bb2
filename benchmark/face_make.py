"""Generate exact-closure-style faces offline (CPU, HiGHS duals).

Usage: python benchmark/face_make.py INSTANCE INCUMBENT OUT.npz

Mimics the B&B driver's plateau state without the device in the loop: solve the
LP relaxation with scipy/HiGHS, iterate reduced-cost fixing at cutoff
incumbent-1 to a fixpoint, and dump the resulting face in the
face_replay.py format (same arrays native.exact_cover passes to
sypha_exact_cover).  Faces made this way are slightly HARDER than in-run
faces (no CG cuts raising the LP bound), which is the right direction for
engine tuning.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import scipy.optimize

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from sypha import native  # noqa: E402
from sypha.io.scp_reader import read_scp_file  # noqa: E402
from sypha.milp.base_model import BaseModel  # noqa: E402


def make_face(name: str, incumbent: float, cut_rounds: int = 0):
    from sypha.milp.cuts import separate_cuts

    m = read_scp_file(f"/root/reference/data/{name}.txt")
    base = BaseModel(m)
    cutoff = incumbent - 1.0 + 1e-6
    z = y = None

    def fixpoint():
        nonlocal z, y
        x_full = None
        for it in range(64):
            A, rhs = base.rel_csr()
            cols = np.flatnonzero(base.active)
            Asub = A[:, cols].tocsc()
            res = scipy.optimize.linprog(
                base.costs[cols], A_ub=-A[:, cols], b_ub=-rhs,
                bounds=(0, 1), method="highs",
            )
            assert res.status == 0, res.message
            z = res.fun
            y = np.maximum(0.0, -res.ineqlin.marginals)
            rc = base.costs[cols] - Asub.T @ y
            x = res.x
            x_full = np.zeros(base.ncols)
            x_full[cols] = x
            fix = (rc > 0) & (x < 0.5) & (z + rc > cutoff + 1e-9)
            n_fix = int(fix.sum())
            print(f"  it{it}: LP={z:.6f} active={len(cols)} rc-fix={n_fix}")
            if n_fix == 0:
                break
            base.deactivate(cols[fix])
        return x_full

    x_full = fixpoint()
    for r in range(cut_rounds):
        cuts = separate_cuts(base, x_full, y, 1e-6, max_cuts=40)
        if not cuts:
            print(f"  cut round {r}: dry")
            break
        base.add_cuts(cuts)
        print(f"  cut round {r}: +{len(cuts)} cuts (model {base.nrows} rows)")
        x_full = fixpoint()
    return base, z, y


if __name__ == "__main__":
    name, incumbent, out = sys.argv[1], float(sys.argv[2]), sys.argv[3]
    cut_rounds = int(sys.argv[4]) if len(sys.argv) > 4 else 0
    base, z, y = make_face(name, incumbent, cut_rounds)
    ar = native._arrays(base)
    extra = {}
    if base.cuts:
        nc = len(base.cuts)
        coef = np.zeros((nc, base.ncols))
        rhs_c = np.zeros(nc)
        for i, cu in enumerate(base.cuts):
            coef[i, cu.indices] = cu.values
            rhs_c[i] = cu.rhs
        extra = dict(
            cut_w=np.ascontiguousarray(
                np.maximum(0.0, y[base.nrows_cover:])
            ),
            cut_coef=np.ascontiguousarray(coef),
            cut_rhs=np.ascontiguousarray(rhs_c),
        )
    np.savez_compressed(
        out,
        masks=ar.masks, costs=ar.costs,
        active=np.ascontiguousarray(base.active.astype(np.uint8)),
        col_ptr=ar.col_ptr, col_idx=ar.col_idx,
        nrows=np.int64(ar.nrows), nwords=np.int64(ar.nwords),
        budget=np.float64(np.ceil(z - 1e-6)),  # first bottom-up probe level
        deadline=np.float64(60.0),
        duals=np.ascontiguousarray(y[: ar.nrows]),
        **extra,
    )
    print(f"{name}: face {base.n_active} cols, LP bound {z:.6f} -> {out}")
