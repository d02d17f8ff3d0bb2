"""IPM correctness: scipy oracle on random LPs + reference golden values.

Golden LP-relaxation optima come from the reference's end-to-end test tables
(python/sypha_unit_tests.py:21-77), acceptance tolerance 1e-4 there; we
assert much tighter (1e-6 absolute) since we solve to 1e-8 relative gap.
"""

import numpy as np
import pytest
import scipy.optimize

from sypha import (
    IpmOptions,
    IpmStatus,
    pad_lp,
    parse_scp_text,
    read_scp_file,
    solve_lp,
    solve_lp_batch,
    stack_lps,
)
from sypha.io.standard_form import pad_standard_form


TINY = """3 4
2 3 4 5
2 1 2
2 2 3
3 1 3 4
"""


def scipy_lp_optimum(lp_model):
    """LP relaxation optimum via scipy HiGHS on the covering form."""
    A = lp_model.dense_matrix()
    res = scipy.optimize.linprog(
        c=lp_model.costs,
        A_ub=-A,
        b_ub=-np.ones(lp_model.nrows),
        bounds=[(0, None)] * lp_model.ncols,
        method="highs",
    )
    assert res.status == 0
    return res.fun


def test_tiny_matches_scipy():
    m = parse_scp_text(TINY)
    lp = pad_lp(m)
    r = solve_lp(lp)
    assert r.status == IpmStatus.CONVERGED
    expected = scipy_lp_optimum(m)
    assert abs(r.primal_objective - expected) < 1e-7
    assert abs(r.dual_objective - expected) < 1e-7
    assert r.gap < 1e-8


def test_demo_tiny_instances(data_dir):
    for name in ["scp_demo_tiny00", "scp_demo_tiny01", "scp_demo_tiny02"]:
        m = read_scp_file(str(data_dir / f"{name}.txt"))
        lp = pad_lp(m)
        r = solve_lp(lp)
        assert r.status == IpmStatus.CONVERGED, name
        expected = scipy_lp_optimum(m)
        assert abs(r.primal_objective - expected) < 1e-6, name


def test_random_lps_match_scipy():
    rng = np.random.default_rng(42)
    for trial in range(3):
        mr, nr = 20, 60
        A0 = (rng.random((mr, nr)) < 0.25).astype(np.float64)
        A0[A0.sum(axis=1) == 0, rng.integers(0, nr)] = 1.0  # coverable rows
        costs = rng.integers(1, 20, nr).astype(np.float64)
        # covering LP via scipy
        res = scipy.optimize.linprog(
            c=costs, A_ub=-A0, b_ub=-np.ones(mr), bounds=[(0, None)] * nr,
            method="highs",
        )
        assert res.status == 0
        # standard form for our solver
        A = np.hstack([A0, -np.eye(mr)])
        b = np.ones(mr)
        c = np.concatenate([costs, np.zeros(mr)])
        lp = pad_standard_form(A, b, c, n_struct=nr)
        r = solve_lp(lp)
        assert r.status == IpmStatus.CONVERGED, f"trial {trial}"
        assert abs(r.primal_objective - res.fun) < 1e-6, f"trial {trial}"


def test_scp41_golden(data_dir):
    """scp41 LP relaxation = 429 exactly (python/sypha_unit_tests.py:22)."""
    m = read_scp_file(str(data_dir / "scp41.txt"))
    lp = pad_lp(m)
    r = solve_lp(lp)
    assert r.status == IpmStatus.CONVERGED
    assert abs(r.primal_objective - 429.0) < 1e-5
    assert abs(r.dual_objective - 429.0) < 1e-5


def test_batch_solve(data_dir):
    names = ["scp_demo_tiny00", "scp_demo_tiny01", "scp_demo_tiny03", "scp_demo_tiny04"]
    models = [read_scp_file(str(data_dir / f"{n}.txt")) for n in names]
    mp = max(m.nrows for m in models) + 8
    np_ = max(m.nrows + m.ncols for m in models) + 128
    mp += (-mp) % 8
    np_ += (-np_) % 128
    lps = stack_lps([pad_lp(m, m_pad=mp, n_pad=np_) for m in models])
    results = solve_lp_batch(lps)
    for m, r in zip(models, results):
        assert r.status == IpmStatus.CONVERGED, m.name
        assert abs(r.primal_objective - scipy_lp_optimum(m)) < 1e-6, m.name


def test_warm_start_plumbing(data_dir):
    """Warm-started batch solve from a generic interior point converges to
    the same optimum as the cold start."""
    import jax.numpy as jnp

    m = read_scp_file(str(data_dir / "scp_demo_tiny00.txt"))
    lp = stack_lps([pad_lp(m)])
    cold = solve_lp_batch(lp)[0]
    x0 = jnp.ones((1, lp.n_pad))
    y0 = jnp.zeros((1, lp.m_pad))
    s0 = jnp.ones((1, lp.n_pad))
    warm = solve_lp_batch(lp, warm_start=(x0, y0, s0))[0]
    assert warm.status == IpmStatus.CONVERGED
    assert abs(warm.primal_objective - cold.primal_objective) < 1e-6
