"""Multi-chip sharding on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

from sypha import IpmStatus, pad_lp, read_scp_file, stack_lps
from sypha.config import IpmOptions
from sypha.parallel import make_mesh, shard_batch, solve_lp_batch_sharded


def test_sharded_batch_solve(data_dir):
    import jax

    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    mesh = make_mesh(8)

    names = [f"scp_demo_tiny{i:02d}" for i in range(8)]
    models = [read_scp_file(str(data_dir / f"{n}.txt")) for n in names]
    mp = max(m.nrows for m in models)
    np_ = max(m.nrows + m.ncols for m in models)
    mp += (-mp) % 8
    np_ += (-np_) % 128
    lp = stack_lps([pad_lp(m, m_pad=mp, n_pad=np_) for m in models])
    lp = shard_batch(lp, mesh)

    st, (worst_gap, max_iters, n_conv) = solve_lp_batch_sharded(lp, mesh=mesh)
    status = np.asarray(st.status)
    assert (status == IpmStatus.CONVERGED).all(), status
    assert int(n_conv) == 8
    assert float(worst_gap) < 1e-8
    assert int(max_iters) == int(np.max(np.asarray(st.iterations)))


def test_sharded_matches_unsharded(data_dir):
    from sypha import solve_lp_batch

    mesh = make_mesh(4)
    m = read_scp_file(str(data_dir / "scp_demo_tiny00.txt"))
    lp = stack_lps([pad_lp(m)] * 4)
    plain = solve_lp_batch(lp)
    st, _ = solve_lp_batch_sharded(shard_batch(lp, mesh), mesh=mesh)
    obj_sharded = np.asarray(st.x)[:, : int(np.asarray(lp.n_real)[0])] @ np.asarray(
        lp.c
    )[0, : int(np.asarray(lp.n_real)[0])]
    for r, o in zip(plain, obj_sharded):
        assert abs(r.primal_objective - o) < 1e-8


def test_shared_batch_sharded(data_dir):
    """Flagship multi-chip mode: shared-A node window lane-sharded over the
    virtual 8-device mesh with pooled bound statistics."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sypha import pad_lp, read_scp_file
    from sypha.config import IpmOptions
    from sypha.core.status import IpmStatus
    from sypha.ipm.shared import fix_columns, make_shared_batch
    from sypha.parallel import (
        make_mesh,
        shard_shared_batch,
        solve_shared_batch_sharded,
    )

    mesh = make_mesh(8)
    lanes = 16
    model = read_scp_file(str(data_dir / "scp41.txt"))
    lp = pad_lp(model)
    batch = make_shared_batch(lp, lanes)
    fix0 = np.zeros((lanes, lp.n_pad))
    fix1 = np.zeros((lanes, lp.n_pad))
    for i in range(lanes):
        (fix1 if i % 2 else fix0)[i, i % 7] = 1.0
    batch = fix_columns(batch, jnp.asarray(fix0), jnp.asarray(fix1))
    batch = shard_shared_batch(batch, mesh)
    st, (worst_gap, max_iters, n_conv, min_dual) = solve_shared_batch_sharded(
        batch, IpmOptions(), mesh
    )
    status = np.asarray(st.status)
    assert np.all(status == IpmStatus.CONVERGED), status
    # every node LP bounds the root from above; pooled min must be >= root
    # LP optimum 429 - eps and <= cheapest node objective
    assert 428.9 <= float(min_dual) <= 450.0, float(min_dual)
    assert float(worst_gap) < 1e-8


def test_bound_pool_single_process():
    from sypha.parallel.distributed import BoundPool, initialize_distributed

    assert initialize_distributed() == 1
    pool = BoundPool()
    out = pool.sync(429.0, 417.5, False)
    assert out.incumbent == 429.0 and out.dual_bound == 417.5 and not out.stop


def test_tensor_parallel_matches_single_chip(data_dir):
    """Column-sharded (tensor-parallel) solve of one shared batch must match
    the single-chip solve bit-for-bit-ish on scp41 (8-way column sharding)."""
    import jax
    import numpy as np

    from sypha import pad_lp, read_scp_file
    from sypha.config import IpmOptions
    from sypha.core.status import IpmStatus
    from sypha.ipm.shared import make_shared_batch, mehrotra_solve_shared
    from sypha.parallel.mesh import (
        TP_AXIS,
        make_mesh,
        solve_shared_batch_tensor_parallel,
    )

    model = read_scp_file(str(data_dir / "scp41.txt"))
    lp = pad_lp(model, m_pad=208, n_pad=1280)  # 1280 = 8 x 160
    batch = make_shared_batch(lp, 2)
    opts = IpmOptions()

    st_ref = jax.jit(lambda b: mehrotra_solve_shared(b, opts))(batch)
    mesh = make_mesh(8, axis=TP_AXIS)
    st_tp = solve_shared_batch_tensor_parallel(batch, opts, mesh)

    assert np.all(np.asarray(st_tp.status) == IpmStatus.CONVERGED)
    obj_ref = np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st_ref.x))
    obj_tp = np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st_tp.x))
    np.testing.assert_allclose(obj_tp, 429.0, rtol=1e-6)
    np.testing.assert_allclose(obj_tp, obj_ref, rtol=1e-8)
    # duals of a degenerate LP are not unique; compare the dual OBJECTIVE
    dobj_ref = np.einsum("bm,bm->b", np.asarray(batch.b), np.asarray(st_ref.y))
    dobj_tp = np.einsum("bm,bm->b", np.asarray(batch.b), np.asarray(st_tp.y))
    np.testing.assert_allclose(dobj_tp, dobj_ref, rtol=1e-7)


def test_bnb_mesh_scp41(data_dir):
    """End-to-end MILP B&B with node windows dispatched lane-sharded over
    the virtual 8-device mesh (VERDICT r1 item 1: the multi-chip machinery
    must be USED by the driver, not just demonstrated)."""
    from sypha.config import SolverConfig
    from sypha.core.status import MilpStatus
    from sypha.milp.bnb import branch_and_bound

    model = read_scp_file(str(data_dir / "scp41.txt"))
    cfg = SolverConfig(verbosity=1)
    cfg = cfg.replace(
        bnb=cfg.bnb.replace(mesh_devices=8, max_nodes=64, precompile=False)
    )
    res = branch_and_bound(model, cfg)
    assert res.status == MilpStatus.OPTIMAL
    assert res.objective == 429.0
    assert abs(res.dual_bound - 429.0) < 1e-6


def test_mesh_chunked_resume(data_dir):
    """Chunked (iter_limit + resume) node solves must also work through
    the mesh-sharded dispatch path."""
    import time

    import numpy as np

    from sypha.config import SolverConfig
    from sypha.core.status import IpmStatus
    from sypha.milp.base_model import BaseModel, BranchNode
    from sypha.milp.bnb import _NodeLpSolver
    from sypha.utils.logging import Logger

    m = read_scp_file(str(data_dir / "scp41.txt"))
    base = BaseModel(m)
    cfg = SolverConfig(verbosity=0)
    cfg = cfg.replace(bnb=cfg.bnb.replace(iter_chunk=4))
    solver = _NodeLpSolver(base, cfg, Logger(verbosity=0), mesh=make_mesh(8))
    opts = cfg.ipm.replace(newton_max_steps=48)
    nodes = [BranchNode().child(j, j % 2) for j in range(16)]
    res = solver.solve_nodes(nodes, opts, time.monotonic() + 3600)
    assert len(res) == 16
    assert all(
        r["status"] in (IpmStatus.CONVERGED, IpmStatus.GAP_STALLED) for r in res
    )
    # fixed-to-1 lanes must report the fixing in their restored solution
    for j, r in enumerate(res):
        if j % 2 == 1:
            assert r["x"][j] > 0.99


def test_tensor_parallel_sparse_matches_single_chip(data_dir):
    """Tensor parallelism on the padded-ELL operator (CLAUDE.md open
    thread: column-sharded slabs with shard-local row indices): the 8-way
    column-sharded sparse solve must match the single-chip sparse solve on
    scp41 — sparse storage and column scale-out compose."""
    import jax
    import numpy as np

    from sypha import read_scp_file
    from sypha.config import IpmOptions
    from sypha.core.status import IpmStatus
    from sypha.ipm.shared import make_shared_batch_sparse, mehrotra_solve_shared
    from sypha.parallel.mesh import (
        TP_AXIS,
        make_mesh,
        solve_shared_batch_tensor_parallel,
    )

    model = read_scp_file(str(data_dir / "scp41.txt"))
    batch = make_shared_batch_sparse(model, 2, m_pad=208, n_pad=1280)
    assert batch.is_sparse
    opts = IpmOptions()

    st_ref = jax.jit(lambda b: mehrotra_solve_shared(b, opts))(batch)
    mesh = make_mesh(8, axis=TP_AXIS)
    st_tp = solve_shared_batch_tensor_parallel(batch, opts, mesh)

    assert np.all(np.asarray(st_tp.status) == IpmStatus.CONVERGED)
    obj_ref = np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st_ref.x))
    obj_tp = np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st_tp.x))
    np.testing.assert_allclose(obj_tp, 429.0, rtol=1e-6)
    np.testing.assert_allclose(obj_tp, obj_ref, rtol=1e-8)
    dobj_ref = np.einsum("bm,bm->b", np.asarray(batch.b), np.asarray(st_ref.y))
    dobj_tp = np.einsum("bm,bm->b", np.asarray(batch.b), np.asarray(st_tp.y))
    np.testing.assert_allclose(dobj_tp, dobj_ref, rtol=1e-7)


def test_tensor_parallel_sparse_cg_strategy(data_dir):
    """The at-scale combination: matrix-free CG strategy (no dense Gram
    factor at all) + ELL operator + 8-way column sharding — every product
    psums partial row-space results over the mesh."""
    import jax
    import numpy as np

    from sypha import read_scp_file
    from sypha.config import IpmOptions
    from sypha.core.status import IpmStatus
    from sypha.ipm.shared import make_shared_batch_sparse, mehrotra_solve_shared
    from sypha.parallel.mesh import (
        TP_AXIS,
        make_mesh,
        solve_shared_batch_tensor_parallel,
    )

    model = read_scp_file(str(data_dir / "scp41.txt"))
    batch = make_shared_batch_sparse(model, 2, m_pad=208, n_pad=1280)
    opts = IpmOptions(linear_solver="cg")

    st_ref = jax.jit(lambda b: mehrotra_solve_shared(b, opts))(batch)
    st_tp = solve_shared_batch_tensor_parallel(
        batch, opts, make_mesh(8, axis=TP_AXIS)
    )
    # the Jacobi-CG strategy stalls in the endgame on scp41 regardless of
    # sharding (single-chip: gap ~7e-8), and k-way psum reassociation on
    # the ill-conditioned normal equations costs another ~1-2 digits
    # (gap ~5e-6 at k=8).  Crucially it must terminate GAP_STALLED — a
    # near-optimal iterate misread as INFEASIBLE was a real bug (the
    # 1e3*tol_feas infeasibility gate fired on CG endgame noise) — and
    # meet the golden-benchmark accuracy bar.
    status = np.asarray(st_tp.status)
    gap = np.asarray(st_tp.gap)
    assert np.all(
        (status == IpmStatus.CONVERGED)
        | ((status == IpmStatus.GAP_STALLED) & (gap < 1e-4))
    ), (status, gap)
    obj_ref = np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st_ref.x))
    obj_tp = np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st_tp.x))
    np.testing.assert_allclose(obj_tp, 429.0, atol=5e-3)
    np.testing.assert_allclose(obj_tp, obj_ref, atol=5e-3)


@pytest.mark.slow
def test_tensor_parallel_ell_scpnrg_scale(data_dir):
    """VERDICT r4 #7: the scale-the-big-dimension promise at its stated
    scale — a 1000x10000 (scpnrg-class) instance column-sharded 8 ways
    with the ELL slab operator must converge and match the single-device
    sparse solve to 1e-8 relative on both objectives.  This is the
    configuration motivating tensor parallelism (single LPs whose columns
    outgrow one chip's HBM); scp41-sized variants cover the mechanism,
    this covers the shape regime (shard-local column indices over a
    1408-wide slab, psum-assembled 1024-row Gram factor)."""
    import jax
    import numpy as np

    from sypha import read_scp_file
    from sypha.config import IpmOptions
    from sypha.core.status import IpmStatus
    from sypha.ipm.shared import make_shared_batch_sparse, mehrotra_solve_shared
    from sypha.parallel.mesh import (
        TP_AXIS,
        make_mesh,
        solve_shared_batch_tensor_parallel,
    )

    model = read_scp_file(str(data_dir / "scpnrg1.txt"))
    assert model.nrows == 1000 and model.ncols == 10000
    # 11264 = 8 x 1408: the standard form (10000 + 1000 cols) on an 8-chip
    # column grid; 1024 rows
    batch = make_shared_batch_sparse(model, 1, m_pad=1024, n_pad=11264)
    assert batch.is_sparse
    opts = IpmOptions(max_iter=250)

    st_ref = jax.jit(lambda b: mehrotra_solve_shared(b, opts))(batch)
    mesh = make_mesh(8, axis=TP_AXIS)
    st_tp = solve_shared_batch_tensor_parallel(batch, opts, mesh)

    status = np.asarray(st_tp.status)
    gap = np.asarray(st_tp.gap)
    print("tp status", status, "gap", gap)
    assert np.all(
        (status == IpmStatus.CONVERGED)
        | ((status == IpmStatus.GAP_STALLED) & (gap < 1e-6))
    ), (status, gap)
    obj_ref = np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st_ref.x))
    obj_tp = np.einsum("bn,bn->b", np.asarray(batch.c), np.asarray(st_tp.x))
    # LP optimum of scpnrg1 is 159.9 (BASELINE.md golden table)
    np.testing.assert_allclose(obj_tp, 159.8862, rtol=1e-4)
    np.testing.assert_allclose(obj_tp, obj_ref, rtol=1e-8)
    dobj_ref = np.einsum("bm,bm->b", np.asarray(batch.b), np.asarray(st_ref.y))
    dobj_tp = np.einsum("bm,bm->b", np.asarray(batch.b), np.asarray(st_tp.y))
    np.testing.assert_allclose(dobj_tp, dobj_ref, rtol=1e-8)


def test_dryrun_multichip_four_devices():
    """The multi-device path of the smoke script (`chip_smoke.py --gpus 4`)
    on four virtual CPU devices: every leg converges and matches HiGHS, and
    the mesh B&B on a generated scp4-shape instance branches and agrees
    with HiGHS's MILP."""
    from __graft_entry__ import dryrun_multichip

    out = dryrun_multichip(4)
    assert set(out) == {
        "shared_window", "per_lane", "tensor_parallel",
        "tensor_parallel_ell", "bnb",
    }
    assert out["bnb"][0] in ("OPTIMAL", "FEASIBLE")
