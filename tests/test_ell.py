"""Padded-ELL sparse operator: product parity vs dense + full LP parity
on the matrix-free CG path (VERDICT r1 item 5 / SURVEY §7 stage 3)."""

import numpy as np
import jax
import jax.numpy as jnp

from sypha import pad_lp, read_scp_file
from sypha.config import IpmOptions
from sypha.core.status import IpmStatus
from sypha.ipm.shared import (
    make_shared_batch,
    make_shared_batch_sparse,
    mehrotra_solve_shared,
)
from sypha.ops.ell import EllMatrix, ell_from_dense, ell_from_rows


def test_ell_products_match_dense():
    rng = np.random.RandomState(3)
    A = rng.rand(24, 40)
    A[A < 0.7] = 0.0  # ~30% dense
    ell = ell_from_dense(A, m_pad=32, n_pad=128)
    Ap = np.zeros((32, 128))
    Ap[:24, :40] = A

    v = rng.rand(5, 128)
    u = rng.rand(5, 32)
    np.testing.assert_allclose(np.asarray(ell.Av(jnp.asarray(v))), v @ Ap.T, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ell.ATu(jnp.asarray(u))), u @ Ap, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(ell.sqAv(jnp.asarray(v))), v @ (Ap * Ap).T, atol=1e-12
    )
    np.testing.assert_allclose(np.asarray(ell.todense()), Ap, atol=1e-15)


def test_ell_from_rows_matches_standard_form(data_dir):
    """ell_from_rows must produce exactly the padded [A0 | -I] the dense
    path builds for the same instance."""
    from sypha.io.standard_form import scp_standard_form, pad_standard_form

    m = read_scp_file(str(data_dir / "scp_demo_tiny00.txt"))
    A, b, c = scp_standard_form(m)
    lp = pad_standard_form(A, b, c, n_struct=m.ncols, m_pad=16, n_pad=128)
    rows = [(np.asarray(r, np.int32), np.ones(len(r))) for r in m.rows]
    ell = ell_from_rows(rows, n_struct=m.ncols, m_pad=16, n_pad=128)
    np.testing.assert_allclose(np.asarray(ell.todense()), np.asarray(lp.A), atol=1e-15)


def test_sparse_lp_matches_dense_scp41(data_dir):
    """scp41 LP on the sparse operator (default factor-preconditioned
    strategy: f32 Gram from a transient scatter, f64 side matrix-free)
    must converge to 1e-8 and match the dense path exactly."""
    model = read_scp_file(str(data_dir / "scp41.txt"))
    opts = IpmOptions()

    sp = make_shared_batch_sparse(model, 2)
    st = jax.jit(lambda b: mehrotra_solve_shared(b, opts))(sp)
    assert np.all(np.asarray(st.status) == IpmStatus.CONVERGED), np.asarray(st.status)
    obj = np.einsum("bn,bn->b", np.asarray(sp.c), np.asarray(st.x))
    np.testing.assert_allclose(obj, 429.0, rtol=1e-6)
    assert np.all(np.asarray(st.gap) < 1e-8)

    # same bucket on the dense path for an exact cross-check
    dn = make_shared_batch(pad_lp(model, m_pad=sp.m_pad, n_pad=sp.n_pad), 2)
    st_d = jax.jit(lambda b: mehrotra_solve_shared(b, opts))(dn)
    obj_d = np.einsum("bn,bn->b", np.asarray(dn.c), np.asarray(st_d.x))
    np.testing.assert_allclose(obj, obj_d, rtol=1e-9)


def test_sparse_cg_strategy_matches_dense_cg(data_dir):
    """On the pure Jacobi-CG strategy the sparse operator must reproduce
    the dense operator's trajectory (same status/iterations; the strategy
    itself stalls short of 1e-8 on scp41 — parity is with dense-CG, whose
    semantics mirror the reference Krylov backend)."""
    model = read_scp_file(str(data_dir / "scp41.txt"))
    opts = IpmOptions(linear_solver="cg")
    sp = make_shared_batch_sparse(model, 1)
    dn = make_shared_batch(pad_lp(model, m_pad=sp.m_pad, n_pad=sp.n_pad), 1)
    st_s = jax.jit(lambda b: mehrotra_solve_shared(b, opts))(sp)
    st_d = jax.jit(lambda b: mehrotra_solve_shared(b, opts))(dn)
    assert np.asarray(st_s.status)[0] == np.asarray(st_d.status)[0]
    obj_s = float(np.einsum("bn,bn->b", np.asarray(sp.c), np.asarray(st_s.x))[0])
    obj_d = float(np.einsum("bn,bn->b", np.asarray(dn.c), np.asarray(st_d.x))[0])
    # the Jacobi-CG strategy stops near ~1e-7 relative gap here; both
    # operators must land within that accuracy of the golden 429
    assert abs(obj_s - 429.0) < 1e-2 and abs(obj_d - 429.0) < 1e-2


def test_sparse_memory_footprint(data_dir):
    """The ELL operator must sit near its nnz bound, well under dense f64,
    on the 500x5000 families.  scpnre is ~10% dense with 2 orientations at
    8 B/slot, so the ceiling is ~3.9x; require > 3.5x (and the padding
    overhead over raw nnz to stay < 25%)."""
    model = read_scp_file(str(data_dir / "scpnre1.txt"))
    sp = make_shared_batch_sparse(model, 1)
    ell: EllMatrix = sp.A
    ell_bytes = sum(
        int(np.prod(a.shape)) * a.dtype.itemsize
        for a in (ell.row_idx, ell.row_val, ell.col_idx, ell.col_val)
    )
    dense_bytes = ell.m_pad * ell.n_pad * 8
    assert ell_bytes * 3.5 < dense_bytes, (ell_bytes, dense_bytes)
    nnz = sum(len(r) for r in model.rows) + model.nrows  # + surplus diag
    # padding overhead comes mostly from the column orientation (max col
    # degree 72 vs mean 50 on scpnre1) — keep it under 50% over raw nnz
    assert ell_bytes < 1.5 * (2 * nnz * 8), (ell_bytes, nnz)


def test_sparse_golden_lp_scpnre1(data_dir):
    """scpnre1 (500x5000, the large family) LP to 1e-8 on the sparse
    operator must hit the golden value (reference
    python/sypha_unit_tests.py:47-53: 21.3794)."""
    from sypha.testing import ACCEPT_TOL, GOLDEN_LP

    model = read_scp_file(str(data_dir / "scpnre1.txt"))
    sp = make_shared_batch_sparse(model, 1)
    st = jax.jit(lambda b: mehrotra_solve_shared(b, IpmOptions()))(sp)
    assert np.asarray(st.status)[0] == IpmStatus.CONVERGED
    obj = float(np.einsum("bn,bn->b", np.asarray(sp.c), np.asarray(st.x))[0])
    assert abs(obj - GOLDEN_LP["scpnre1"]) < ACCEPT_TOL, obj


import pytest


@pytest.mark.slow
@pytest.mark.parametrize("family", ["scpnre", "scpnrf", "scpnrg", "scpnrh"])
def test_sparse_golden_lp_large_families(family, data_dir):
    """Full nre-nrh LP suite on the SPARSE operator path (VERDICT r1 item
    5 'done' criterion), golden values at 1e-4."""
    from sypha.testing import ACCEPT_TOL, GOLDEN_LP

    names = [f"{family}{i}" for i in range(1, 6)]
    models = [read_scp_file(str(data_dir / f"{n}.txt")) for n in names]
    mp = max(m.nrows for m in models)
    np_ = max(m.nrows + m.ncols for m in models)
    mp += (-mp) % 8
    np_ += (-np_) % 128
    opts = IpmOptions()
    for n, m in zip(names, models):
        sp = make_shared_batch_sparse(m, 1, m_pad=mp, n_pad=np_)
        st = jax.jit(lambda b: mehrotra_solve_shared(b, opts))(sp)
        # scpnrh5 stalls at gap ~9e-8 on BOTH operators (path-independent
        # endgame margin); the reference harness accepts any terminal
        # state at tol 1e-4, so require near-target accuracy, not the
        # strict CONVERGED flag
        status = int(np.asarray(st.status)[0])
        gap = float(np.asarray(st.gap)[0])
        assert status == IpmStatus.CONVERGED or (
            status == IpmStatus.GAP_STALLED and gap < 1e-6
        ), (n, status, gap)
        obj = float(np.einsum("bn,bn->b", np.asarray(sp.c), np.asarray(st.x))[0])
        assert abs(obj - GOLDEN_LP[n]) < ACCEPT_TOL, (n, obj)


def test_auto_operator_selection(data_dir):
    """Density-based auto-selection: dense operator for ~10%-dense scpnre,
    sparse for low-density instances (crossover ~5% density)."""
    from sypha.ipm.shared import make_shared_batch_auto

    dense_b = make_shared_batch_auto(read_scp_file(str(data_dir / "scpnre1.txt")), 1)
    assert not dense_b.is_sparse
    sparse_b = make_shared_batch_auto(read_scp_file(str(data_dir / "scpnrg1.txt")), 1)
    assert sparse_b.is_sparse


def test_ell_column_slabs_products():
    """k-way column slabs must reproduce the full operator: stacked-local
    Av partial products sum to the full Av; per-slab ATu equals the
    corresponding slice of the full ATu (shard-local row-ELL indices)."""
    from sypha.ops.ell import ell_column_slabs

    rng = np.random.RandomState(7)
    A = rng.rand(24, 40)
    A[A < 0.6] = 0.0
    ell = ell_from_dense(A, m_pad=32, n_pad=128)
    Ap = np.zeros((32, 128))
    Ap[:24, :40] = A
    k = 8
    slabs = ell_column_slabs(ell, k)
    nl = 128 // k
    v = rng.rand(3, 128)
    u = rng.rand(3, 32)
    Av_sum = np.zeros((3, 32))
    for j in range(k):
        slab = EllMatrix(
            row_idx=slabs.row_idx[j], row_val=slabs.row_val[j],
            col_idx=slabs.col_idx[j], col_val=slabs.col_val[j],
        )
        vloc = jnp.asarray(v[:, j * nl:(j + 1) * nl])
        Av_sum += np.asarray(slab.Av(vloc))
        np.testing.assert_allclose(
            np.asarray(slab.ATu(jnp.asarray(u))),
            u @ Ap[:, j * nl:(j + 1) * nl], atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(slab.sqAv(vloc)),
            v[:, j * nl:(j + 1) * nl] @ (Ap[:, j * nl:(j + 1) * nl] ** 2).T,
            atol=1e-12,
        )
        np.testing.assert_allclose(
            np.asarray(slab.todense()), Ap[:, j * nl:(j + 1) * nl], atol=1e-15
        )
    np.testing.assert_allclose(Av_sum, v @ Ap.T, atol=1e-12)


def test_node_solver_ell_parity_scp41(data_dir):
    """The production node solver on the padded-ELL operator returns the
    same root LP as the dense operator (VERDICT r2 item 3: production ELL
    wiring)."""
    from sypha.config import SolverConfig
    from sypha.milp.base_model import BaseModel, BranchNode
    from sypha.milp.bnb import _NodeLpSolver
    from sypha.utils.logging import Logger

    model = read_scp_file(str(data_dir / "scp41.txt"))
    base = BaseModel(model)
    log = Logger(verbosity=0)
    ipm = SolverConfig().ipm.replace(newton_max_steps=48)
    res = {}
    for op in ("dense", "ell"):
        cfg = SolverConfig().replace(
            bnb=SolverConfig().bnb.replace(node_operator=op, precompile=False)
        )
        solver = _NodeLpSolver(base, cfg, log)
        res[op] = solver.solve_nodes([BranchNode()], ipm)[0]
        assert res[op]["status"] == IpmStatus.CONVERGED
        assert solver._use_ell == (op == "ell")
    np.testing.assert_allclose(res["ell"]["pobj"], res["dense"]["pobj"], rtol=1e-7)
    np.testing.assert_allclose(res["ell"]["pobj"], 429.0, rtol=1e-6)


def test_bnb_ell_operator_matches_scipy():
    """Full B&B on the sparse node operator proves the same optimum as
    scipy's MILP on random instances (branch fixings + cuts ride the
    EllMatrix path end to end)."""
    from sypha.config import SolverConfig
    from sypha.core.problem import ScpModel
    from sypha.core.status import MilpStatus
    from sypha.milp.bnb import branch_and_bound
    from tests.test_milp import scipy_milp_optimum

    rng = np.random.default_rng(11)
    for trial in range(2):
        nrows, ncols = 8, 16
        rows = [
            np.sort(
                rng.choice(ncols, size=rng.integers(2, 5), replace=False)
            ).astype(np.int32)
            for _ in range(nrows)
        ]
        m = ScpModel(
            nrows=nrows,
            ncols=ncols,
            costs=rng.integers(1, 12, ncols).astype(np.float64),
            rows=rows,
            name=f"rand_ell{trial}",
        )
        expected = scipy_milp_optimum(m)
        cfg = SolverConfig(verbosity=0)
        cfg = cfg.replace(bnb=cfg.bnb.replace(node_operator="ell"))
        r = branch_and_bound(m, cfg)
        assert r.status == MilpStatus.OPTIMAL, (trial, r)
        assert abs(r.objective - expected) < 1e-9, (trial, r.objective, expected)
