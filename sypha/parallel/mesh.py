"""Multi-chip execution: shard the batch of LPs over a device mesh.

The reference is strictly single-GPU (SURVEY §2.3); its B&B frontier window
(DeviceNodeWindow, src/sypha_solver_bnb.cpp:12-97) stages node LPs on device
but solves them one at a time.  Here the batch axis is real parallelism:
``shard_map`` places contiguous lanes on each chip, every chip runs the same
jitted vmapped Mehrotra solve on its shard, and only *scalar statistics*
(pooled bound minima/maxima, convergence counts — the state the reference
keeps in host variables, src/sypha_solver_bnb_driver.cpp:256-261) cross
between devices via psum/pmin.  KKT solves never leave the device.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from sypha.config import IpmOptions
from sypha.core.problem import PaddedLp
from sypha.core.status import IpmStatus
from sypha.ipm.dense import mehrotra_solve


BATCH_AXIS = "batch"


def make_mesh(n_devices: Optional[int] = None, axis: str = BATCH_AXIS) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, only {len(devs)} available")
    return Mesh(np.array(devs[:n]), (axis,))


def shard_batch(lp: PaddedLp, mesh: Mesh) -> PaddedLp:
    """Place a stacked batch with its leading axis sharded over the mesh."""
    spec = NamedSharding(mesh, P(BATCH_AXIS))
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, spec), lp)


def pooled_stats(st, axis: str = BATCH_AXIS):
    """Cross-chip scalar pooling (inside shard_map): the only cross-device traffic.

    Returns (global min dual bound proxy, global max iterations,
    global converged count) — mirrors the host variables the reference's
    B&B shares between nodes (incumbent, global dual bound, stop flag).
    """
    local_converged = jnp.sum((st.status == IpmStatus.CONVERGED).astype(jnp.int32))
    converged = jax.lax.psum(local_converged, axis)
    max_iters = jax.lax.pmax(jnp.max(st.iterations), axis)
    worst_gap = jax.lax.pmax(jnp.max(st.gap), axis)
    return worst_gap, max_iters, converged


def shard_shared_batch(batch, mesh: Mesh):
    """Place a SharedLpBatch: lane arrays sharded over the mesh, the shared
    matrix A (and pad-row vector) replicated on every chip."""
    from sypha.ipm.shared import SharedLpBatch

    lane = NamedSharding(mesh, P(BATCH_AXIS))
    rep = NamedSharding(mesh, P())
    return SharedLpBatch(
        A=jax.device_put(batch.A, rep),
        b=jax.device_put(batch.b, lane),
        c=jax.device_put(batch.c, lane),
        col_mask=jax.device_put(batch.col_mask, lane),
        row_pad=jax.device_put(batch.row_pad, rep),
        obj_offset=jax.device_put(batch.obj_offset, lane),
    )


def solve_shared_batch_sharded(
    batch,
    opts: Optional[IpmOptions] = None,
    mesh: Optional[Mesh] = None,
):
    """Shard the lane axis of a SharedLpBatch over the mesh: each chip runs
    the shared-matrix batched Mehrotra solve on its lane shard (A is
    replicated — B&B nodes share it), and only pooled scalar statistics
    cross between devices.  This is the flagship multi-chip execution mode: the
    B&B frontier window scales by adding chips.

    Returns (IpmState with lane axis sharded, (worst_gap, max_iters,
    n_converged, min_dual) replicated scalars).
    """
    from sypha.ipm.shared import SharedLpBatch, mehrotra_solve_shared

    opts = opts or IpmOptions()
    mesh = mesh or make_mesh()

    def per_chip(A, row_pad, b, c, mask, off):
        local = SharedLpBatch(
            A=A, b=b, c=c, col_mask=mask, row_pad=row_pad, obj_offset=off
        )
        st = mehrotra_solve_shared(local, opts)
        worst_gap, max_iters, converged = pooled_stats(st)
        # pooled dual bound: the cross-chip scalar the distributed B&B
        # prunes against (reference keeps it in a host variable,
        # src/sypha_solver_bnb_driver.cpp:1048-1079)
        local_dual = jnp.min(jnp.sum(b * st.y, axis=-1) + off)
        min_dual = jax.lax.pmin(local_dual, BATCH_AXIS)
        return st, (worst_gap, max_iters, converged, min_dual)

    fn = shard_map(
        per_chip,
        mesh=mesh,
        in_specs=(P(), P(), P(BATCH_AXIS), P(BATCH_AXIS), P(BATCH_AXIS), P(BATCH_AXIS)),
        out_specs=(P(BATCH_AXIS), (P(), P(), P(), P())),
        check_vma=False,
    )
    return jax.jit(fn)(
        batch.A, batch.row_pad, batch.b, batch.c, batch.col_mask, batch.obj_offset
    )


def solve_node_batch_sharded(
    base: PaddedLp,
    fix0,
    fix1,
    opts: IpmOptions,
    mesh: Mesh,
    warm=None,
    resume=None,
    iter_limit=None,
):
    """Multi-chip B&B node window: the full node-batch solve
    (ipm.node_batch.solve_node_batch — per-lane branch fixings, warm
    starts, chunked resume) with the LANE axis sharded over the mesh.

    The padded base LP (one A for the whole window) is replicated on every
    chip; each chip solves its shard of the frontier window; nothing
    crosses between devices during the solve — the cross-chip state the reference
    keeps in host variables (incumbent, global dual bound, stop flag —
    src/sypha_solver_bnb_driver.cpp:256-261, :1048-1079) is pooled by the
    host driver via parallel.distributed.BoundPool on a cadence instead.

    Lane count must divide by the mesh size (the driver pads the window by
    replicating its last node).  Returns the same (state, x_full, pobj,
    dobj) as solve_node_batch, lane axis sharded.
    """
    from sypha.ipm.node_batch import solve_node_batch

    lane = P(BATCH_AXIS)
    rep = P()

    def lane_spec(tree):
        return jax.tree_util.tree_map(lambda _: lane, tree)

    def rep_spec(tree):
        return jax.tree_util.tree_map(lambda _: rep, tree)

    def per_chip(base, fix0, fix1, warm, resume, limit):
        return solve_node_batch(base, fix0, fix1, opts, warm, resume, limit)

    limit = jnp.asarray(
        opts.max_iter if iter_limit is None else iter_limit, jnp.int32
    )
    args = (base, fix0, fix1, warm, resume, limit)
    in_specs = (
        rep_spec(base), lane, lane, lane_spec(warm), lane_spec(resume), rep
    )
    # out structure: (IpmState, x_full, pobj, dobj) — all lane-leading
    fn = shard_map(
        per_chip,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(
            IpmState_lane_spec(),
            lane,
            lane,
            lane,
        ),
        check_vma=False,
    )
    return jax.jit(fn)(*args)


def IpmState_lane_spec():
    """PartitionSpecs of an IpmState with every leaf lane-sharded on its
    leading axis (the node-window / frontier sharding)."""
    from sypha.ipm.dense import IpmState

    lane = P(BATCH_AXIS)
    return IpmState(
        x=lane, y=lane, s=lane, mu=lane, gap=lane, res_p=lane, res_d=lane,
        iterations=lane, status=lane, best_gap=lane, stall_count=lane,
    )


TP_AXIS = "tp"


def solve_shared_batch_tensor_parallel(
    batch,
    opts: Optional[IpmOptions] = None,
    mesh: Optional[Mesh] = None,
):
    """Tensor-parallel solve of ONE SharedLpBatch whose COLUMN axis is
    sharded over the mesh: each chip holds a slab A[:, k] of the constraint
    matrix plus the matching slices of c/col_mask/x/s, while y/b stay
    replicated.  Every A-product onto the row space psums across devices; the
    m x m normal-matrix factor is psum-assembled and factored redundantly
    per chip.  This is the scale-the-big-dimension mechanism for instances
    whose columns outgrow one chip's HBM (SURVEY §5 long-context analogue);
    lane sharding (solve_shared_batch_sharded) remains the throughput mode.

    ``batch.n_pad`` must divide evenly by the mesh size.  Works for both
    the dense A (column slabs of the array) and the padded-ELL operator
    (ops.ell.ell_column_slabs: per-shard row-ELL with SHARD-LOCAL column
    indices; partial row-space products psum over the mesh) — sparse
    storage AND column scale-out compose.
    """
    from sypha.ipm.shared import SharedLpBatch, mehrotra_solve_shared

    opts = opts or IpmOptions()
    mesh = mesh or make_mesh(axis=TP_AXIS)
    k = mesh.devices.size
    if batch.n_pad % k:
        raise ValueError(f"n_pad {batch.n_pad} not divisible by {k} chips")

    if batch.is_sparse:
        from sypha.ops.ell import EllMatrix, ell_column_slabs

        slabs = ell_column_slabs(batch.A, k)

        def per_chip_sparse(ri, rv, ci, cv, row_pad, b, c, mask, off):
            # shard_map hands each chip its [1, ...] block of the leading
            # shard axis; drop it to recover the local EllMatrix slab
            local = SharedLpBatch(
                A=EllMatrix(
                    row_idx=ri[0], row_val=rv[0],
                    col_idx=ci[0], col_val=cv[0],
                ),
                b=b, c=c, col_mask=mask, row_pad=row_pad, obj_offset=off,
            )
            return mehrotra_solve_shared(local, opts, axis_name=TP_AXIS)

        fn = shard_map(
            per_chip_sparse,
            mesh=mesh,
            in_specs=(
                P(TP_AXIS),        # row-ELL indices (shard-local columns)
                P(TP_AXIS),        # row-ELL values
                P(TP_AXIS),        # col-ELL indices (global rows)
                P(TP_AXIS),        # col-ELL values
                P(),               # row_pad replicated
                P(),               # b replicated
                P(None, TP_AXIS),  # c
                P(None, TP_AXIS),  # col_mask
                P(),               # obj_offset replicated
            ),
            out_specs=IpmState_tp_spec(),
            check_vma=False,
        )
        return jax.jit(fn)(
            slabs.row_idx, slabs.row_val, slabs.col_idx, slabs.col_val,
            batch.row_pad, batch.b, batch.c, batch.col_mask, batch.obj_offset,
        )

    def per_chip(A, row_pad, b, c, mask, off):
        local = SharedLpBatch(
            A=A, b=b, c=c, col_mask=mask, row_pad=row_pad, obj_offset=off
        )
        st = mehrotra_solve_shared(local, opts, axis_name=TP_AXIS)
        return st

    fn = shard_map(
        per_chip,
        mesh=mesh,
        in_specs=(
            P(None, TP_AXIS),  # A column slabs
            P(),               # row_pad replicated
            P(),               # b replicated
            P(None, TP_AXIS),  # c
            P(None, TP_AXIS),  # col_mask
            P(),               # obj_offset replicated
        ),
        # x/s/d2-side state comes back column-sharded; y/scalars replicated
        out_specs=IpmState_tp_spec(),
        check_vma=False,
    )
    return jax.jit(fn)(
        batch.A, batch.row_pad, batch.b, batch.c, batch.col_mask, batch.obj_offset
    )


def IpmState_tp_spec():
    """PartitionSpecs of an IpmState under tensor parallelism: primal-side
    vectors sharded on their trailing (n) axis, everything else replicated."""
    from sypha.ipm.dense import IpmState

    return IpmState(
        x=P(None, TP_AXIS),
        y=P(),
        s=P(None, TP_AXIS),
        mu=P(),
        gap=P(),
        res_p=P(),
        res_d=P(),
        iterations=P(),
        status=P(),
        best_gap=P(),
        stall_count=P(),
    )


def solve_lp_batch_sharded(
    lp: PaddedLp,
    opts: Optional[IpmOptions] = None,
    mesh: Optional[Mesh] = None,
):
    """Solve a sharded batch of LPs: per-chip vmapped solves + psum'd stats.

    Returns (batched IpmState with batch axis sharded, (worst_gap,
    max_iters, n_converged) replicated scalars).
    """
    opts = opts or IpmOptions()
    mesh = mesh or make_mesh()

    def per_chip(lp_shard: PaddedLp):
        st = jax.vmap(lambda p: mehrotra_solve(p, opts))(lp_shard)
        stats = pooled_stats(st)
        return st, stats

    # check_vma=False: the while_loop carry mixes lane-varying iterates with
    # scalars initialised from constants; the varying-axis checker cannot
    # unify them even though the program is correct.
    fn = shard_map(
        per_chip,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS),),
        out_specs=(P(BATCH_AXIS), (P(), P(), P())),
        check_vma=False,
    )
    return jax.jit(fn)(lp)
