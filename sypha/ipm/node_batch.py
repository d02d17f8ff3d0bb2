"""Batched B&B node LP solves on the shared-matrix IPM.

The reference rebuilds the CSR on the host and re-uploads the whole model
for every node (src/sypha_solver_bnb_driver.cpp:802-831 — flagged in SURVEY
§3.2 as a per-node cost the batched rebuild must kill), encoding each branch
decision x_j = v as an appended standard-form row
(reference build_branch_model, src/sypha_solver_bnb.cpp:418-490).

Here the padded base LP lives on device once per bucket and branch
decisions are *column fixings* — mathematically equivalent to the branch
rows, but shape-preserving: fixing x_j = 0 masks column j out of every
A-product; fixing x_j = 1 substitutes it into the rhs (b -= A_j) and the
objective offset.  A whole frontier window therefore solves as ONE
shared-matrix batched IPM call (ipm.shared) with no per-node model builds,
no device uploads beyond two [B, n] masks, and no recompiles as depth grows.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from sypha.config import IpmOptions
from sypha.core.problem import PaddedLp
from sypha.ipm.shared import (
    fix_columns,
    make_shared_batch,
    mehrotra_solve_shared,
)


@partial(jax.jit, static_argnames=("opts",))
def solve_node_batch(
    base: PaddedLp,
    fix0: jnp.ndarray,  # [B, n_pad] 1.0 where a column is fixed to 0 (or masked)
    fix1: jnp.ndarray,  # [B, n_pad] 1.0 where a column is fixed to 1
    opts: IpmOptions,
    warm=None,  # optional (x0, y0, s0) [B, ...] parent iterates
    resume=None,  # optional IpmState from a previous chunked dispatch
    iter_limit=None,  # optional traced int32 iteration cap (chunked solves)
):
    """Solve one batch of B&B node LPs sharing the base matrix.

    Returns (state, x_full, pobj, dobj): ``x_full`` restores fixed-to-1
    columns to 1.0 and zeroes masked columns, so the host sees each node's
    solution in the original variable space; pobj/dobj include the
    objective offset of the fixed-to-1 substitutions.

    ``warm`` warm-starts each lane from its parent's converged iterate
    shifted back to the interior (the reference cold-starts every node with
    a dense (AA^T)^-1 solve, src/sypha_solver_init.cpp:543 — flagged in
    SURVEY §7 hard-parts as the waste a batched rebuild should fix).

    ``resume``/``iter_limit`` implement hard time limits: the B&B driver
    runs a window solve in short chunks, checking the wall clock between
    dispatches (the batched analogue of the reference's per-iteration watchdog
    poll, src/sypha_solver.cpp:498-502).  ``iter_limit`` is traced, so
    raising it across chunks reuses the same compiled executable.
    """
    batch = make_shared_batch(base, fix0.shape[0])
    batch = fix_columns(batch, fix0, fix1)
    if resume is not None:
        st = mehrotra_solve_shared(
            batch, opts, state0=resume, iter_limit=iter_limit
        )
    elif warm is not None:
        xw, yw, sw = warm
        eps = 1e-3
        x0 = jnp.maximum(xw.astype(batch.c.dtype), eps)
        s0 = jnp.maximum(sw.astype(batch.c.dtype), eps)
        st = mehrotra_solve_shared(
            batch, opts, x0, yw.astype(batch.c.dtype), s0,
            iter_limit=iter_limit,
        )
    else:
        st = mehrotra_solve_shared(batch, opts, iter_limit=iter_limit)
    x_masked = st.x * batch.col_mask
    x_full = x_masked + jnp.asarray(fix1, st.x.dtype)
    pobj = jnp.sum(batch.c * x_masked, axis=-1) + batch.obj_offset
    dobj = jnp.sum(batch.b * st.y, axis=-1) + batch.obj_offset
    return st, x_full, pobj, dobj
