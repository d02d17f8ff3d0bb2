"""Matrix-free Jacobi-CG linear-solver strategy (the reference's Krylov
path, src/sypha_solver_krylov.cu + adaptive tolerance schedule
src/sypha_solver.cpp:552-553) must reach the same golden optima as the
dense-factor strategy."""

import numpy as np
import jax

from sypha import pad_lp, read_scp_file, solve_lp
from sypha.config import IpmOptions
from sypha.core.status import IpmStatus
from sypha.ipm.shared import make_shared_batch, mehrotra_solve_shared
from sypha.io.scp_reader import parse_scp_text

TINY = "3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n"


def test_cg_path_tiny():
    model = parse_scp_text(TINY, name="tiny")
    lp = pad_lp(model, m_pad=8, n_pad=128)
    res = solve_lp(lp, IpmOptions(linear_solver="cg"))
    assert res.status == IpmStatus.CONVERGED
    assert abs(res.primal_objective - 4.5) < 1e-7


def test_cg_path_scp41_shared(data_dir):
    """Jacobi-CG at the reference's accuracy class: its Krylov path was only
    ever driven to mu <= 1e-4 (kMehrotraMuTol, src/sypha_environment_defaults.h:16);
    a diagonal preconditioner cannot track the endgame conditioning, so we
    converge at 1e-4 like the reference and rely on the dense-factor
    strategy for 1e-8 targets."""
    model = read_scp_file(str(data_dir / "scp41.txt"))
    lp = pad_lp(model)
    batch = make_shared_batch(lp, 2)
    opts = IpmOptions(linear_solver="cg", tol_gap=1e-4, tol_feas=1e-4,
                      cg_max_iter=1000)
    st = jax.jit(lambda b: mehrotra_solve_shared(b, opts))(batch)
    assert np.all(np.asarray(st.status) == IpmStatus.CONVERGED)
    obj = np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st.x))
    np.testing.assert_allclose(obj, 429.0, rtol=2e-4)


def test_cg_path_failure_keeps_best_iterate(data_dir):
    """At a 1e-8 target the Jacobi-CG lane must stop on the solve-quality
    gate (GAP_STALLED) with a still-sane iterate instead of stepping on a
    garbage direction."""
    model = read_scp_file(str(data_dir / "scp41.txt"))
    lp = pad_lp(model)
    batch = make_shared_batch(lp, 2)
    opts = IpmOptions(linear_solver="cg", cg_max_iter=500)
    st = jax.jit(lambda b: mehrotra_solve_shared(b, opts))(batch)
    status = np.asarray(st.status)
    assert np.all(
        (status == IpmStatus.CONVERGED) | (status == IpmStatus.GAP_STALLED)
    ), status
    obj = np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st.x))
    np.testing.assert_allclose(obj, 429.0, rtol=1e-3)


def test_auto_strategy_resolution():
    from sypha.ipm.shared import use_cg_strategy

    assert not use_cg_strategy(IpmOptions(linear_solver="auto"), 512)
    assert use_cg_strategy(IpmOptions(linear_solver="auto"), 4096)
    assert use_cg_strategy(IpmOptions(linear_solver="cg"), 8)
    assert not use_cg_strategy(IpmOptions(linear_solver="dense"), 4096)
