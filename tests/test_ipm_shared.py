"""Shared-matrix batched IPM: parity with the per-lane solver and with
scipy, plus column-fixing (branch-mask) semantics."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sypha import pad_lp, read_scp_file
from sypha.config import IpmOptions
from sypha.core.status import IpmStatus
from sypha.ipm.shared import (
    SharedLpBatch,
    fix_columns,
    make_shared_batch,
    mehrotra_solve_shared,
)
from sypha.io.scp_reader import parse_scp_text

TINY = "3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n"


def _tiny_batch(B=4):
    model = parse_scp_text(TINY, name="tiny")
    lp = pad_lp(model, m_pad=8, n_pad=128)
    return model, lp, make_shared_batch(lp, B)


def test_shared_matches_scipy_tiny():
    from scipy.optimize import linprog

    model, lp, batch = _tiny_batch(3)
    st = jax.jit(lambda b: mehrotra_solve_shared(b, IpmOptions()))(batch)
    assert np.all(np.asarray(st.status) == IpmStatus.CONVERGED)

    A = np.asarray(lp.A)[: model.nrows, : model.ncols]
    res = linprog(
        np.asarray(model.costs),
        A_ub=-A,
        b_ub=-np.ones(model.nrows),
        bounds=[(0, None)] * model.ncols,
        method="highs",
    )
    obj = np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st.x))
    # pad columns cost 1 each but converge to ~0; tolerance absorbs them
    np.testing.assert_allclose(obj, res.fun, rtol=1e-6)


def test_fix_columns_semantics():
    """Fixing x_0 = 1 must shift rhs/offset; fixing x_j = 0 must exclude j."""
    from scipy.optimize import linprog

    model, lp, batch = _tiny_batch(2)
    n_pad = lp.n_pad
    fix0 = np.zeros((2, n_pad))
    fix1 = np.zeros((2, n_pad))
    fix1[0, 0] = 1.0  # lane 0: x_0 = 1
    fix0[1, 1] = 1.0  # lane 1: x_1 = 0
    fixed = fix_columns(batch, fix0, fix1)
    st = jax.jit(lambda b: mehrotra_solve_shared(b, IpmOptions()))(fixed)
    assert np.all(np.asarray(st.status) == IpmStatus.CONVERGED)
    obj = (
        np.einsum("bn,bn->b", np.asarray(fixed.c * fixed.col_mask), np.asarray(st.x))
        + np.asarray(fixed.obj_offset)
    )

    A = np.asarray(lp.A)[: model.nrows, : model.ncols]
    c = np.asarray(model.costs)
    # lane 0: x0 = 1
    res0 = linprog(
        c,
        A_ub=-A,
        b_ub=-np.ones(model.nrows),
        bounds=[(1, 1)] + [(0, None)] * (model.ncols - 1),
        method="highs",
    )
    # lane 1: x1 = 0
    res1 = linprog(
        c,
        A_ub=-A,
        b_ub=-np.ones(model.nrows),
        bounds=[(0, None), (0, 0)] + [(0, None)] * (model.ncols - 2),
        method="highs",
    )
    np.testing.assert_allclose(obj[0], res0.fun, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(obj[1], res1.fun, rtol=1e-6, atol=1e-6)


def test_shared_scp41_lp(data_dir):
    """scp41 LP relaxation to 1e-8 on the shared path = 429 (golden value,
    reference python/sypha_unit_tests.py:21-31)."""
    model = read_scp_file(str(data_dir / "scp41.txt"))
    lp = pad_lp(model)
    batch = make_shared_batch(lp, 2)
    st = jax.jit(lambda b: mehrotra_solve_shared(b, IpmOptions()))(batch)
    assert np.all(np.asarray(st.status) == IpmStatus.CONVERGED)
    obj = np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st.x))
    np.testing.assert_allclose(obj, 429.0, rtol=1e-5)
    assert np.all(np.asarray(st.gap) < 1e-8)


def test_shared_warm_start(data_dir):
    model = read_scp_file(str(data_dir / "scp41.txt"))
    lp = pad_lp(model)
    batch = make_shared_batch(lp, 2)
    solve = jax.jit(lambda b: mehrotra_solve_shared(b, IpmOptions()))
    st = solve(batch)
    base_iters = int(np.max(np.asarray(st.iterations)))

    # shift-to-interior warm start from the converged iterate
    x0 = jnp.maximum(st.x, 1e-4)
    s0 = jnp.maximum(st.s, 1e-4)
    st2 = jax.jit(
        lambda b, x0, y0, s0: mehrotra_solve_shared(b, IpmOptions(), x0, y0, s0)
    )(batch, x0, st.y, s0)
    assert np.all(np.asarray(st2.status) == IpmStatus.CONVERGED)
    assert int(np.max(np.asarray(st2.iterations))) <= base_iters


def test_chunked_resume_matches_one_shot(data_dir):
    """A solve run in iteration chunks (dynamic iter_limit + state resume)
    must land on the same terminal state as the one-shot solve — the
    mechanism behind hard-time-limit enforcement in the B&B driver."""
    model = read_scp_file(str(data_dir / "scp41.txt"))
    lp = pad_lp(model)
    batch = make_shared_batch(lp, 2)
    opts = IpmOptions()

    solve = jax.jit(
        lambda b, lim, st0: mehrotra_solve_shared(
            b, opts, state0=st0, iter_limit=lim
        )
    )
    first = jax.jit(
        lambda b, lim: mehrotra_solve_shared(b, opts, iter_limit=lim)
    )

    st = first(batch, jnp.asarray(4, jnp.int32))
    assert np.all(np.asarray(st.status) == IpmStatus.MAX_ITER)
    assert np.all(np.asarray(st.iterations) == 4)
    limit = 4
    # resume in chunks of 5 until every lane terminates for a real reason
    for _ in range(40):
        status = np.asarray(st.status)
        if not np.any(status == IpmStatus.MAX_ITER):
            break
        limit += 5
        st = solve(batch, jnp.asarray(limit, jnp.int32), st)

    one_shot = jax.jit(lambda b: mehrotra_solve_shared(b, opts))(batch)
    assert np.all(np.asarray(st.status) == IpmStatus.CONVERGED)
    np.testing.assert_array_equal(
        np.asarray(st.iterations), np.asarray(one_shot.iterations)
    )
    obj = np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st.x))
    np.testing.assert_allclose(obj, 429.0, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(st.x), np.asarray(one_shot.x), atol=1e-10
    )


def test_shared_gram_matches_float64():
    """The f32 Gram A diag(w) A^T agrees with float64 to 1e-5 relative.
    True f32 matmuls give ~1e-7; a reduced-precision (TF32) GEMM would miss
    the bound by two orders of magnitude."""
    from sypha.io.generate import random_scp
    from sypha.ipm.shared import shared_gram

    m = random_scp(40, 256, 0.05, seed=3)
    A = pad_lp(m, m_pad=40, n_pad=384).A
    rng = np.random.default_rng(0)
    d2 = 10.0 ** rng.uniform(-3, 3, size=(3, A.shape[1]))
    M = np.asarray(shared_gram(jnp.asarray(A, jnp.float32), jnp.asarray(d2), jnp.float32))
    A64 = np.asarray(A, np.float64)
    ref = np.einsum("ik,bk,jk->bij", A64, d2, A64)
    assert M.dtype == np.float32
    assert np.abs(M - ref).max() / np.abs(ref).max() <= 1e-5
