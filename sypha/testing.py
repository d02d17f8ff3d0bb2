"""Golden values for the Beasley OR-Library SCP suite.

LP-relaxation optima copied from the reference's end-to-end test tables
(python/sypha_unit_tests.py:21-77, ACCEPT_TOL 1e-4) — the single most
valuable test artifact of the reference per SURVEY §4.  MILP incumbents and
statuses come from its committed benchmark CSVs
(benchmark/results/sypha_results.csv, scpnre_nrf_compare.csv).

``highs_lp`` and ``highs_milp`` are the plain references for instances
without golden values (e.g. sypha.io.generate): scipy's HiGHS on the same
model.
"""

from __future__ import annotations

import numpy as np

# instance name -> LP relaxation optimum (primal == dual at optimality)
GOLDEN_LP = {
    # scp4x (200 rows x 1000 cols)
    "scp41": 429.0,
    "scp42": 512.0,
    "scp43": 516.0,
    "scp44": 494.0,
    "scp45": 512.0,
    "scp46": 557.25,
    "scp47": 430.0,
    "scp48": 488.66666666666663,
    "scp49": 638.5384615384615,
    "scp410": 513.5,
    # scp5x (200 rows x 2000 cols)
    "scp51": 251.22499999999997,
    "scp52": 299.76111111111112,
    "scp53": 226.0,
    "scp54": 240.5,
    "scp55": 211.0,
    "scp56": 212.5,
    "scp57": 291.77777777777783,
    "scp58": 287.0,
    "scp59": 279.0,
    "scp510": 265.0,
    # scpnre (500 rows x 5000 cols)
    "scpnre1": 21.379416207246248,
    "scpnre2": 22.360044873608039,
    "scpnre3": 20.486142236242543,
    "scpnre4": 21.352715255058822,
    "scpnre5": 21.321920958180868,
    # scpnrf
    "scpnrf1": 8.7952638227569615,
    "scpnrf2": 9.9936151600008856,
    "scpnrf3": 9.4923769291525240,
    "scpnrf4": 8.4711900922824324,
    "scpnrf5": 7.8355272485863994,
    # scpnrg
    "scpnrg1": 159.88624078126432,
    "scpnrg2": 142.07332051900437,
    "scpnrg3": 148.26913540494277,
    "scpnrg4": 148.94652093714018,
    "scpnrg5": 148.23146550380926,
    # scpnrh
    "scpnrh1": 48.124554641790994,
    "scpnrh2": 48.637624895853385,
    "scpnrh3": 45.197462139046252,
    "scpnrh4": 44.042108164700451,
    "scpnrh5": 42.370358868231932,
}

# instance -> (MILP incumbent, status) from the reference's own benchmark run
# (benchmark/results/sypha_results.csv; 120 s limit on its GPU)
GOLDEN_MILP = {
    "scp41": (429, "OPTIMAL"),
    "scp42": (512, "OPTIMAL"),
    "scp43": (516, "OPTIMAL"),
    "scp44": (494, "OPTIMAL"),
    "scp45": (512, "OPTIMAL"),
    "scp46": (560, "OPTIMAL"),
    "scp47": (430, "OPTIMAL"),
    "scp48": (492, "OPTIMAL"),
    "scp49": (641, "OPTIMAL"),
    "scp410": (514, "OPTIMAL"),
    "scp51": (253, "OPTIMAL"),
    "scp52": (302, "OPTIMAL"),
    "scp53": (226, "OPTIMAL"),
    "scp54": (242, "OPTIMAL"),
    "scp55": (211, "OPTIMAL"),
    "scp56": (213, "OPTIMAL"),
    "scp57": (293, "OPTIMAL"),
    "scp58": (288, "FEASIBLE"),
    "scp59": (279, "OPTIMAL"),
    "scp510": (265, "OPTIMAL"),
}

ACCEPT_TOL = 1e-4  # reference python/sypha_unit_tests.py:10


def _covering_matrix(model):
    import scipy.sparse as sp

    rows = np.concatenate([np.full(len(r), i) for i, r in enumerate(model.rows)])
    cols = np.concatenate(model.rows)
    return sp.csr_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(model.nrows, model.ncols)
    )


def highs_lp(model, fix0=(), fix1=()) -> float:
    """Plain reference: the SCP LP relaxation min c.x, Ax >= 1, x >= 0 by
    scipy's HiGHS, with columns ``fix0`` fixed to 0 and ``fix1`` to 1."""
    from scipy.optimize import linprog

    A = _covering_matrix(model)
    bounds = [(0.0, None)] * model.ncols
    for j in fix0:
        bounds[j] = (0.0, 0.0)
    for j in fix1:
        bounds[j] = (1.0, 1.0)
    res = linprog(model.costs, A_ub=-A, b_ub=-np.ones(model.nrows),
                  bounds=bounds, method="highs")
    assert res.status == 0, res.message
    return float(res.fun)


def highs_milp(model, time_limit: float = 300.0):
    """Plain reference: scipy's HiGHS MILP.  Returns (status, incumbent,
    dual bound); status 0 means proven optimal."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    A = _covering_matrix(model)
    res = milp(model.costs, constraints=LinearConstraint(A, lb=1.0),
               integrality=np.ones(model.ncols), bounds=Bounds(0.0, 1.0),
               options={"time_limit": time_limit})
    inc = float(res.fun) if res.fun is not None else np.inf
    return int(res.status), inc, float(res.mip_dual_bound)
