"""Shared-matrix batched Mehrotra IPM: one A, many LP lanes.

The reference solves one LP at a time, rebuilding + re-uploading the model
per B&B node (src/sypha_solver_bnb_driver.cpp:802-826 — build_branch_model
then copyModelOnDevice per node, flagged in SURVEY §3.2 as the per-node cost
a batched rebuild must kill).  Here the whole batch of B&B nodes / replicas
shares ONE constraint matrix A resident on device; lanes differ only in

  * ``col_mask`` [B, n]: 0 where a variable is fixed by branching (or pad),
  * ``b`` [B, m]: rhs after substituting fixed-to-1 columns,
  * ``c`` [B, n]: costs (masked columns get cost 1, the pad convention),
  * ``obj_offset`` [B]: sum of costs of fixed-to-1 columns.

Branch decisions x_j=0 / x_j=1 are therefore *column masks + rhs shifts*
(no appended rows, no shape changes, no recompiles), and every A-product in
the solver is a single GEMM shared across lanes instead of B independent
GEMVs — the layout that keeps the f64 arithmetic GEMM-shaped.

Masked columns follow the pad-column convention of core.problem.PaddedLp:
with every A-product masked, a fixed column behaves exactly like an all-zero
column, stays strictly interior, and converges to x_j ~ 0 with s_j ~ c_j = 1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import numpy as np
import jax.numpy as jnp
from jax import lax

from sypha.config import IpmOptions
from sypha.core.problem import PaddedLp
from sypha.core.status import IpmStatus
from sypha.ipm.dense import IpmState, _factor_params
from sypha.ops.linalg import block_chol_inverse


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SharedLpBatch:
    """B standard-form LP lanes min c.x, A(mask)x = b, x >= 0 sharing one A.

    A: [m, n] f64 (shared) — either a dense array or an ops.ell.EllMatrix
    (the padded-ELL sparse operator; forces the matrix-free CG strategy);
    b: [B, m]; c: [B, n]; col_mask: [B, n] in {0,1};
    row_pad: [m] (1 on pad rows); obj_offset: [B].
    """

    A: jnp.ndarray
    b: jnp.ndarray
    c: jnp.ndarray
    col_mask: jnp.ndarray
    row_pad: jnp.ndarray
    obj_offset: jnp.ndarray

    @property
    def m_pad(self) -> int:
        return self.A.shape[-2]

    @property
    def n_pad(self) -> int:
        return self.A.shape[-1]

    @property
    def n_lanes(self) -> int:
        return self.b.shape[-2] if self.b.ndim >= 2 else 1

    @property
    def is_sparse(self) -> bool:
        from sypha.ops.ell import EllMatrix

        return isinstance(self.A, EllMatrix)


def _A_products(A):
    """(Av, ATu, sqAv) for dense [m, n] arrays or EllMatrix operators:
    Av: [..., n] -> [..., m] = A @ v;  ATu: [..., m] -> [..., n] = A^T @ u;
    sqAv: [..., n] -> [..., m] = (A∘A) @ d (the Jacobi-diagonal product)."""
    from sypha.ops.ell import EllMatrix

    if isinstance(A, EllMatrix):
        return A.Av, A.ATu, A.sqAv
    A2 = A * A
    return (
        lambda v: v @ A.T,
        lambda u: u @ A,
        lambda d: d @ A2.T,
    )


def make_shared_batch(lp: PaddedLp, n_lanes: int) -> SharedLpBatch:
    """Replicate a single PaddedLp into a SharedLpBatch of ``n_lanes``.

    ``lp.A`` may be a dense [m, n] array or an ops.ell.EllMatrix (built by
    io.standard_form.pad_standard_form_ell) — the batch carries the sparse
    operator through unchanged and every product stays matrix-free."""
    from sypha.ops.ell import EllMatrix

    if not isinstance(lp.A, EllMatrix) and lp.A.ndim != 2:
        raise ValueError("make_shared_batch expects an unbatched PaddedLp")
    B = n_lanes
    n = lp.n_pad
    mask = jnp.broadcast_to(
        (jnp.arange(n) < lp.n_real).astype(lp.c.dtype), (B, n)
    )
    return SharedLpBatch(
        A=lp.A,
        b=jnp.broadcast_to(lp.b, (B, lp.m_pad)),
        c=jnp.broadcast_to(lp.c, (B, n)),
        col_mask=mask,
        row_pad=lp.row_pad,
        obj_offset=jnp.zeros((B,), lp.A.dtype),
    )


def make_shared_batch_sparse(
    model,
    n_lanes: int,
    m_pad: Optional[int] = None,
    n_pad: Optional[int] = None,
) -> SharedLpBatch:
    """ScpModel -> SharedLpBatch whose A is a padded-ELL sparse operator.

    Same padding conventions as pad_lp/make_shared_batch (pad columns cost
    1 and masked out; pad rows rhs 0 with row_pad regularisation), but the
    standard form [A0 | -I] is built straight into EllMatrix row/column
    slots — a resident dense f64 [m_pad, n_pad] matrix never exists.
    Every f64 product is matrix-free (EllMatrix.Av/ATu/sqAv, mirroring the
    reference Krylov backend's two SpMVs, src/sypha_solver_krylov.cu:
    305-329); under the default dense-factor strategy the f32 Gram
    preconditioner is formed from a transient f32 scatter of the operator.
    """
    from sypha.io.standard_form import bucket_dims
    from sypha.ops.ell import ell_from_rows

    m, n0 = model.nrows, model.ncols
    n = n0 + m
    auto_mp, auto_np = bucket_dims(m, n)
    mp = m_pad if m_pad is not None else auto_mp
    np_ = n_pad if n_pad is not None else auto_np
    rows = [
        (np.asarray(cols, dtype=np.int32), np.ones(len(cols))) for cols in model.rows
    ]
    A = ell_from_rows(rows, n_struct=n0, m_pad=mp, n_pad=np_)

    b = np.zeros(mp)
    b[:m] = 1.0
    c = np.ones(np_)
    c[:n0] = model.costs
    c[n0:n] = 0.0
    row_pad = np.zeros(mp)
    row_pad[m:] = 1.0

    B = n_lanes
    mask = jnp.broadcast_to(
        (jnp.arange(np_) < n).astype(jnp.float64), (B, np_)
    )
    return SharedLpBatch(
        A=A,
        b=jnp.broadcast_to(jnp.asarray(b), (B, mp)),
        c=jnp.broadcast_to(jnp.asarray(c), (B, np_)),
        col_mask=mask,
        row_pad=jnp.asarray(row_pad),
        obj_offset=jnp.zeros((B,)),
    )


def make_shared_batch_auto(
    model,
    n_lanes: int,
    m_pad: Optional[int] = None,
    n_pad: Optional[int] = None,
    density_threshold: float = 0.05,
) -> SharedLpBatch:
    """Operator auto-selection by density (the reference's memory-driven
    path pick, src/sypha_solver.cpp:218-320): the padded-ELL gather
    products beat the dense GEMM on sparse matrices and store far less,
    and lose on denser ones.  The 5% crossover was measured on another
    machine; benchmark/ell_vs_dense.py re-measures it."""
    from sypha.io.standard_form import pad_lp

    nnz = sum(len(r) for r in model.rows) + model.nrows
    density = nnz / float(model.nrows * (model.ncols + model.nrows))
    if density <= density_threshold:
        return make_shared_batch_sparse(model, n_lanes, m_pad, n_pad)
    return make_shared_batch(
        pad_lp(model, m_pad=m_pad, n_pad=n_pad), n_lanes
    )


def fix_columns(
    batch: SharedLpBatch,
    fix0: np.ndarray,
    fix1: np.ndarray,
) -> SharedLpBatch:
    """Apply per-lane branch fixings (host-side batch construction).

    fix0/fix1: [B, n] {0,1} float masks of variables fixed to 0 / 1.
    Fixing to 1 substitutes the column out: b -= A_j, offset += c_j
    (the branch row x_j >= 1 of reference build_branch_model,
    src/sypha_solver_bnb.cpp:418-490, without the row).
    """
    Av, _, _ = _A_products(batch.A)
    fix0 = jnp.asarray(fix0, batch.c.dtype)
    fix1 = jnp.asarray(fix1, batch.c.dtype)
    fixed = jnp.clip(fix0 + fix1, 0.0, 1.0)
    mask = batch.col_mask * (1.0 - fixed)
    b = batch.b - Av(fix1)
    c = jnp.where(mask > 0, batch.c, 1.0)
    offset = batch.obj_offset + jnp.sum(fix1 * batch.c, axis=-1)
    return SharedLpBatch(
        A=batch.A, b=b, c=c, col_mask=mask, row_pad=batch.row_pad,
        obj_offset=offset,
    )


# ---------------------------------------------------------------------------
# solver internals: every A-product is a shared GEMM over the lane axis
# ---------------------------------------------------------------------------


def _reducers(axis_name):
    """Cross-chip reducers for the tensor-parallel (column-sharded) mode;
    identity when axis_name is None (single-chip / lane-sharded modes)."""
    if axis_name is None:
        return (lambda v: v), (lambda v: v), (lambda: 1)
    return (
        lambda v: lax.psum(v, axis_name),
        lambda v: lax.pmin(v, axis_name),
        lambda: lax.psum(1, axis_name),
    )


def shared_gram(A32, d2_eff, ft):
    """Batched Gram M_b = A diag(d2_eff_b) A^T in dtype ``ft``.

    Aw is the broadcasted [B, m, n] weighted matrix (one cast of A, reused).
    The Gram is the iteration's largest FLOP block; XLA lowers the batched
    einsum to a GEMM, and the package-wide "highest" matmul precision keeps
    it in true f32 rather than TF32.
    """
    w = jnp.sqrt(d2_eff).astype(ft)
    Aw = A32[None, :, :] * w[:, None, :]
    return jnp.einsum("bik,bjk->bij", Aw, Aw, preferred_element_type=ft)


def _shared_factor(A32, d2_eff, row_reg, ft, ridge: float, leaf_size: int, psum=None):
    """f32 factor of M_b = A diag(d2_eff_b) A^T + diag(row_reg), batched.

    Same structure as ops.spd.normal_eq_factor but with A shared.
    """
    M = shared_gram(A32, d2_eff, ft)
    if psum is not None:
        M = psum(M)  # n-axis is sharded: partial Gram matrices sum over chips
    m = M.shape[-1]
    M = M + row_reg.astype(ft)[:, None, :] * jnp.eye(m, dtype=ft)
    diag = jnp.diagonal(M, axis1=-2, axis2=-1)
    dinv = lax.rsqrt(jnp.maximum(diag, jnp.asarray(1e-30, ft)))
    Ms = M * dinv[:, None, :] * dinv[:, :, None]
    Ms = Ms + jnp.asarray(ridge, ft) * jnp.eye(m, dtype=ft)
    Linv = block_chol_inverse(Ms, leaf_size=leaf_size)
    return Linv, dinv


def _precond(Linv, dinv, r):
    """P r = Dg L^-T L^-1 Dg r per lane (f32 batched GEMVs)."""
    rf = dinv * r.astype(dinv.dtype)
    z = jnp.einsum("bij,bj->bi", Linv, rf)
    z = jnp.einsum("bji,bj->bi", Linv, z)
    return (dinv * z).astype(r.dtype)


def _pcg(Linv, dinv, matvec, f, tol, max_steps: int):
    """Flexible PCG preconditioned by the f32 Cholesky factor (ops.spd)."""
    from sypha.ops.spd import pcg_solve

    return pcg_solve(lambda r: _precond(Linv, dinv, r), matvec, f, tol, max_steps)


def use_cg_strategy(opts: IpmOptions, m_pad: int) -> bool:
    """Resolve the linear-solver strategy (reference picks dense vs Krylov
    by GPU memory, src/sypha_solver.cpp:218-320; the batched analogue is
    the O(B m^2) factor footprint + O(m^3) factor FLOPs, so `auto`
    switches to matrix-free CG for large row counts)."""
    if opts.linear_solver == "cg":
        return True
    if opts.linear_solver == "auto":
        return m_pad > 2048
    return False


def shared_initial_point(batch: SharedLpBatch, opts: IpmOptions, A32, use_cg: bool, axis_name=None):
    """Mehrotra initial point, batched over lanes of the shared matrix
    (reference src/sypha_solver_init.cpp:543-652)."""
    from sypha.ops.spd import pcg_solve

    A, b, c, mask = batch.A, batch.b, batch.c, batch.col_mask
    Av, ATu, sqAv = _A_products(A)
    ft, ridge = _factor_params(opts)
    row_reg = jnp.broadcast_to(batch.row_pad, b.shape)
    psum, pmin, _ = _reducers(axis_name)

    def matvec(v):
        return psum(Av(mask * ATu(v))) + batch.row_pad * v

    if use_cg:
        diag = psum(sqAv(mask)) + row_reg
        solve = lambda f: pcg_solve(
            lambda r: r / jnp.maximum(diag, 1e-300),
            matvec, f, 1e-12, opts.cg_max_iter,
        )[0]
    else:
        Linv, dinv = _shared_factor(
            A32, mask, row_reg, ft, ridge, opts.chol_leaf_size,
            psum if axis_name else None,
        )
        solve = lambda f: _pcg(Linv, dinv, matvec, f, 1e-12, opts.newton_max_steps)[0]

    vy = solve(b)
    x = mask * ATu(vy)
    Ac = psum(Av(mask * c))
    y = solve(Ac)
    s = c - mask * ATu(y)

    delta_x = jnp.maximum(-1.5 * pmin(jnp.min(x, axis=-1, keepdims=True)), 0.0)
    delta_s = jnp.maximum(-1.5 * pmin(jnp.min(s, axis=-1, keepdims=True)), 0.0)
    x_hat = x + delta_x
    s_hat = s + delta_s
    p = psum(jnp.sum(x_hat * s_hat, axis=-1, keepdims=True))
    x = x_hat + 0.5 * p / psum(jnp.sum(s_hat, axis=-1, keepdims=True))
    s = s_hat + 0.5 * p / psum(jnp.sum(x_hat, axis=-1, keepdims=True))
    return x, y, s


def _alpha_max_batch(v, dv):
    """Per-lane max alpha in [0,1] with v + alpha dv >= 0 (masked min-reduce;
    reference alpha_max_dev, src/sypha_solver_utils.cu:139-177)."""
    ratios = jnp.where(dv < 0.0, -v / jnp.where(dv < 0.0, dv, -1.0), jnp.inf)
    return jnp.minimum(1.0, jnp.min(ratios, axis=-1))


def mehrotra_solve_shared(
    batch: SharedLpBatch,
    opts: IpmOptions,
    x0=None,
    y0=None,
    s0=None,
    axis_name=None,
    state0=None,
    iter_limit=None,
) -> IpmState:
    """Batched Mehrotra predictor-corrector over a SharedLpBatch.

    Returns an IpmState whose leaves carry a leading lane axis.  The whole
    batch runs as ONE ``lax.while_loop``; lanes that converge freeze while
    the rest continue (per-lane status gating, as in ipm.dense).

    ``iter_limit`` is a *traced* int32 cap on the per-lane iteration count
    (default ``opts.max_iter``).  Because it is dynamic, callers can run a
    solve in short chunks — dispatch with a small limit, check the wall
    clock on the host, then resume by passing the returned state back as
    ``state0`` with a higher limit — without triggering any recompiles.
    This is the batched analogue of the reference's per-IPM-iteration watchdog
    poll (src/sypha_solver.cpp:498-502): the host regains control every
    chunk instead of every iteration.  Lanes that stopped at MAX_ITER are
    revived when the new limit allows more steps; all other terminal
    statuses stay frozen.
    """
    from sypha.ops.spd import pcg_solve

    A, b, c, mask = batch.A, batch.b, batch.c, batch.col_mask
    Av, ATu, sqAv = _A_products(A)
    B, n_pad = c.shape[-2], c.shape[-1]
    ft, ridge = _factor_params(opts)
    use_cg = use_cg_strategy(opts, batch.m_pad)
    # the dense-factor strategy forms its f32 Gram preconditioner from a
    # dense A; with the ELL operator that dense f32 view is scattered
    # transiently (todense(float32)) while every f64 product stays
    # matrix-free — sparse storage, dense-strength preconditioning
    if use_cg:
        A32 = None
    else:
        A32 = A.todense(ft) if batch.is_sparse else A.astype(ft)
    row_reg = jnp.broadcast_to(batch.row_pad, b.shape)
    # tensor-parallel mode: the n (column) axis is sharded over axis_name;
    # every sum/min over n and every A-product onto the row space reduces
    # across chips.  axis_name=None degrades to identity reducers.
    psum, pmin, axis_size = _reducers(axis_name)
    n_total = n_pad * axis_size()

    norm_b = 1.0 + jnp.linalg.norm(b, axis=-1)
    norm_c = 1.0 + jnp.sqrt(psum(jnp.sum(c * c, axis=-1)))

    iter_limit = (
        jnp.asarray(opts.max_iter, jnp.int32)
        if iter_limit is None
        else jnp.asarray(iter_limit, jnp.int32)
    )

    if state0 is not None:
        # resume a chunked solve: revive lanes the previous (lower) limit
        # cut short; every other terminal status is final
        import dataclasses

        revive = (state0.status == IpmStatus.MAX_ITER) & (
            state0.iterations < iter_limit
        )
        state0 = dataclasses.replace(
            state0,
            status=jnp.where(
                revive, IpmStatus.RUNNING, state0.status
            ).astype(jnp.int32),
        )
    else:
        if x0 is None:
            x, y, s = shared_initial_point(batch, opts, A32, use_cg, axis_name)
        else:
            x, y, s = x0, y0, s0

        one = jnp.ones((B,), c.dtype)
        state0 = IpmState(
            x=x,
            y=y,
            s=s,
            mu=psum(jnp.sum(x * s, axis=-1)) / n_total,
            gap=one,
            res_p=one,
            res_d=one,
            iterations=jnp.zeros((B,), jnp.int32),
            status=jnp.full((B,), IpmStatus.RUNNING, jnp.int32),
            best_gap=jnp.full((B,), jnp.inf, c.dtype),
            stall_count=jnp.zeros((B,), jnp.int32),
        )

    def cond(st):
        return jnp.any(st.status == IpmStatus.RUNNING)

    def one_step(st, Linv_c, dinv_c):
        """One predictor-corrector step.  ``Linv_c/dinv_c`` is the (possibly
        stale) f32 preconditioner factor — with factor_refresh_every > 1 the
        while-loop body factors once and runs several steps against it; the
        f64 matrix-free PCG absorbs the staleness with extra cheap steps.
        (A lax.cond-gated refresh does NOT work here: under vmap a batched
        predicate lowers to select and executes both branches.)"""
        x, y, s = st.x, st.y, st.s

        r_b = psum(Av(mask * x)) - b
        r_c = mask * ATu(y) + s - c
        mu = psum(jnp.sum(x * s, axis=-1)) / n_total

        pobj = psum(jnp.sum(c * x, axis=-1))
        dobj = jnp.sum(b * y, axis=-1)
        gap = jnp.abs(pobj - dobj) / (1.0 + jnp.abs(pobj))
        res_p = jnp.linalg.norm(r_b, axis=-1) / norm_b
        res_d = jnp.sqrt(psum(jnp.sum(r_c * r_c, axis=-1))) / norm_c

        feasible = (res_p < opts.tol_feas) & (res_d < opts.tol_feas)
        tiny_mu = mu < opts.mu_tol_hard
        converged = feasible & ((gap < opts.tol_gap) | tiny_mu)
        # mu -> 0 with a stubborn primal residual = infeasible lane (a node
        # whose fixings make the cover impossible); see ipm.dense for the
        # 1e-3 floor rationale (CG endgame noise vs true-infeasible ~0.07).
        infeasible = tiny_mu & (res_p > jnp.maximum(1e3 * opts.tol_feas, 1e-3))
        diverged = ~jnp.isfinite(mu) | (mu > opts.mu_max) | infeasible
        hit_max = st.iterations >= iter_limit

        improved = gap < st.best_gap * (1.0 - opts.gap_stall_min_improv)
        best_gap = jnp.where(improved, gap, st.best_gap)
        stall_count = jnp.where(improved, 0, st.stall_count + 1).astype(jnp.int32)
        stalled = (
            (stall_count >= opts.gap_stall_window)
            if opts.gap_stall_window > 0
            else jnp.zeros((B,), bool)
        )

        d2 = jnp.clip(x / s, opts.d2_min, opts.d2_max)
        d2_eff = d2 * mask

        def matvec(v):
            return psum(Av(d2_eff * ATu(v))) + batch.row_pad * v

        if use_cg:
            # Jacobi-CG Krylov path with the reference's adaptive tolerance
            # schedule per IPM iteration (src/sypha_solver.cpp:552-553)
            diag = psum(sqAv(d2_eff)) + row_reg
            cg_tol = jnp.maximum(
                opts.cg_tol_final,
                opts.cg_tol_initial
                * opts.cg_tol_decay ** st.iterations.astype(c.dtype),
            )[:, None]
            solve = lambda f: pcg_solve(
                lambda r: r / jnp.maximum(diag, 1e-300),
                matvec, f, cg_tol, opts.cg_max_iter,
            )
            solve_gate = jnp.maximum(100.0 * cg_tol[:, 0], 1e-3)
        else:
            if Linv_c is None:
                # default path: factor inline so XLA schedules/fuses it with
                # the residual work (hoisting it to the macro-iteration body
                # measured ~20% slower); a carried stale factor is only used
                # when factor_refresh_every > 1
                Linv_c, dinv_c = _shared_factor(
                    A32, d2_eff, row_reg, ft, ridge, opts.chol_leaf_size,
                    psum if axis_name else None,
                )
            solve = lambda f: _pcg(
                Linv_c, dinv_c, matvec, f, opts.newton_tol, opts.newton_max_steps
            )
            solve_gate = jnp.asarray(1e-3, c.dtype)

        # 1e-30 floor (not 1e-300): sigma*mu/s with s ~ 1e-300 overflows to
        # inf in the Newton rhs and NaNs the step; alpha-max keeps the
        # clamped coordinate's step sane
        s_safe = jnp.maximum(s, 1e-30)

        def newton(r_xs):
            vec1 = r_xs / s_safe
            f = psum(Av(mask * (vec1 - d2 * r_c))) - r_b
            dy, solve_rel = solve(f)
            ds = -r_c - mask * ATu(dy)
            dx = -vec1 - d2 * ds
            return dx, dy, ds, solve_rel

        r_xs = x * s
        dxa, dya, dsa, rel_a = newton(r_xs)
        a_p = pmin(_alpha_max_batch(x, dxa))[:, None]
        a_d = pmin(_alpha_max_batch(s, dsa))[:, None]
        mu_aff = psum(
            jnp.sum((x + a_p * dxa) * (s + a_d * dsa), axis=-1)
        ) / n_total
        sigma = (mu_aff / mu) ** opts.sigma_pow

        dx, dy, ds, rel_c = newton(r_xs + dxa * dsa - (sigma * mu)[:, None])

        # Gondzio multiple centrality correctors: push complementarity
        # products toward [beta_min, beta_max] * sigma*mu with extra solves
        # that reuse the factor; accept a correction only if it lengthens
        # the step.  (No reference counterpart; where the factor dominates
        # the iteration, correctors that save iterations are cheap.)
        mu_t = (sigma * mu)[:, None]
        for _ in range(opts.max_correctors):
            ap = _alpha_max_batch(x, dx)
            ad = _alpha_max_batch(s, ds)
            ap_t = jnp.minimum(ap * 1.08 + 0.08, 1.0)[:, None]
            ad_t = jnp.minimum(ad * 1.08 + 0.08, 1.0)[:, None]
            v = (x + ap_t * dx) * (s + ad_t * ds)
            target = jnp.clip(v, opts.corrector_beta_min * mu_t,
                              opts.corrector_beta_max * mu_t)
            t = v - target  # residual to remove (0 inside the window)
            vec1 = t / s_safe
            fcc = psum(Av(mask * vec1))
            dyc, _ = solve(fcc)
            dsc = -(mask * ATu(dyc))
            dxc = -vec1 - d2 * dsc
            ap2 = _alpha_max_batch(x, dx + dxc)
            ad2 = _alpha_max_batch(s, ds + dsc)
            better = ((ap2 >= ap + 0.01) & (ad2 >= ad)) | (
                (ad2 >= ad + 0.01) & (ap2 >= ap)
            )
            sel_c = better[:, None]
            dx = jnp.where(sel_c, dx + dxc, dx)
            dy = jnp.where(sel_c, dy + dyc, dy)
            ds = jnp.where(sel_c, ds + dsc, ds)

        eta = (
            jnp.maximum(opts.eta, 1.0 - mu) if opts.adaptive_eta else jnp.full_like(mu, opts.eta)
        )
        alpha_p = jnp.minimum(1.0, eta * pmin(_alpha_max_batch(x, dx)))[:, None]
        alpha_d = jnp.minimum(1.0, eta * pmin(_alpha_max_batch(s, ds)))[:, None]

        x_new = x + alpha_p * dx
        y_new = y + alpha_d * dy
        s_new = s + alpha_d * ds

        finite_local = jnp.all(jnp.isfinite(x_new), axis=-1) & jnp.all(
            jnp.isfinite(s_new), axis=-1
        )
        step_ok = (
            (psum(1.0 - finite_local.astype(x.dtype)) == 0.0)
            & jnp.all(jnp.isfinite(y_new), axis=-1)
        )
        # linear-solve quality gates: a Newton system the (Jacobi-)CG could
        # not solve to within ~100x of its requested tolerance produces a
        # garbage direction (reference CG breakdown -> failure,
        # src/sypha_solver_krylov.cu:335-339); additionally ACCEPT the step
        # only if it does not blow up primal feasibility (near the endgame,
        # dx error ~ d2 * ds error is amplified by up to 1e12, which no
        # residual gate on dy can see).  A rejected step terminates the lane
        # at its current (best) iterate with GAP_STALLED.
        res_p_new = jnp.linalg.norm(
            psum(Av(mask * x_new)) - b, axis=-1
        ) / norm_b
        step_bad = res_p_new > jnp.maximum(10.0 * res_p, 1e-4)
        solve_failed = (jnp.maximum(rel_a, rel_c) > solve_gate) | step_bad

        # a non-finite step (step_ok False) ends the lane at its current
        # iterate as GAP_STALLED — numerical exhaustion, NOT infeasibility:
        # the iterate may already be feasibility- and gap-wise excellent,
        # and the B&B's weak-duality path can still extract its bound
        new_status = jnp.where(
            converged,
            IpmStatus.CONVERGED,
            jnp.where(
                diverged,
                IpmStatus.INFEASIBLE_OR_NUMERICAL,
                jnp.where(
                    hit_max,
                    IpmStatus.MAX_ITER,
                    jnp.where(
                        stalled | solve_failed | ~step_ok,
                        IpmStatus.GAP_STALLED,
                        IpmStatus.RUNNING,
                    ),
                ),
            ),
        ).astype(jnp.int32)
        # lanes already terminated keep their status and iterate no further
        final = st.status != IpmStatus.RUNNING
        new_status = jnp.where(final, st.status, new_status)
        stepped = new_status == IpmStatus.RUNNING
        sel = stepped[:, None]

        return IpmState(
            x=jnp.where(sel, x_new, x),
            y=jnp.where(sel, y_new, y),
            s=jnp.where(sel, s_new, s),
            mu=jnp.where(final, st.mu, mu),
            gap=jnp.where(final, st.gap, gap),
            res_p=jnp.where(final, st.res_p, res_p),
            res_d=jnp.where(final, st.res_d, res_d),
            iterations=st.iterations + stepped.astype(jnp.int32),
            status=new_status,
            best_gap=best_gap,
            stall_count=stall_count,
        )

    def body(st):
        if use_cg or opts.factor_refresh_every <= 1:
            Linv = dinv = None  # one_step factors inline (or needs none)
        else:
            d2_eff0 = jnp.clip(st.x / st.s, opts.d2_min, opts.d2_max) * mask
            Linv, dinv = _shared_factor(
                A32, d2_eff0, row_reg, ft, ridge, opts.chol_leaf_size,
                psum if axis_name else None,
            )
        for _ in range(max(1, opts.factor_refresh_every)):
            st = one_step(st, Linv, dinv)
        return st

    return lax.while_loop(cond, body, state0)
