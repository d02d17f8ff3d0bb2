"""Mehrotra predictor-corrector IPM on dense normal equations.

Batched rewrite of the reference LP core (src/sypha_solver.cpp:42-886).
Instead of factorising the (2n+m)^2 indefinite 3x3 KKT system the reference
assembles for cusolverSp, we solve the m x m normal equations

    (A D^2 A^T) dy = f,   D^2 = X / S,

like the reference's Krylov path (src/sypha_solver_krylov.cu:180-223) and the
prototype's dense path (python/interior_point.py:114-121).  The factorisation
is computed once per iteration and reused for predictor and corrector (the
reference reuses its LU factor the same way,
src/sypha_solver_dense_linear.cpp:187-203); here the factor is an
equilibrated f32 inverse-Cholesky (ops.linalg.block_chol_inverse) and each
Newton solve is flexible PCG in f64 preconditioned by it (ops.spd).

Everything here is shape-static, jit-safe and vmap-safe: the whole solve is
one ``lax.while_loop``; per-iteration device->host syncs (the reference's
cuBLAS scalar returns, see SURVEY §3.4) do not exist.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import lax

from sypha.config import IpmOptions
from sypha.core.problem import PaddedLp
from sypha.core.status import IpmStatus
from sypha.ops.spd import (
    _apply_normal_precond,
    normal_eq_factor,
    normal_eq_solve,
    pcg_solve,
)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class IpmState:
    """Device-resident iterate. All leaves are arrays; batchable via vmap."""

    x: jnp.ndarray  # [n_pad] primal
    y: jnp.ndarray  # [m_pad] dual
    s: jnp.ndarray  # [n_pad] dual slacks
    mu: jnp.ndarray  # scalar duality measure x.s / n_pad
    gap: jnp.ndarray  # scalar relative duality gap
    res_p: jnp.ndarray  # scalar relative primal infeasibility
    res_d: jnp.ndarray  # scalar relative dual infeasibility
    iterations: jnp.ndarray  # int32
    status: jnp.ndarray  # int32 IpmStatus
    best_gap: jnp.ndarray  # scalar: best gap seen (stagnation monitor)
    stall_count: jnp.ndarray  # int32: iterations without gap improvement


def _factor_params(opts: IpmOptions):
    dtype = jnp.float32 if opts.factor_dtype == "float32" else jnp.float64
    ridge = opts.factor_ridge
    if ridge is None:
        ridge = 2e-6 if dtype == jnp.float32 else 1e-12
    return dtype, ridge


def initial_point(lp: PaddedLp, opts: IpmOptions = IpmOptions()):
    """Mehrotra's initial-point heuristic (reference
    src/sypha_solver_init.cpp:543-652; python/interior_point.py:13-57):
    x = A^T (A A^T)^-1 b,  y = (A A^T)^-1 A c,  s = c - A^T y, followed by
    positivity shifts.  ``row_pad`` regularises A A^T on pad rows."""
    A, b, c = lp.A, lp.b, lp.c
    dtype, ridge = _factor_params(opts)
    ones = jnp.ones(A.shape[-1], A.dtype)
    fac = normal_eq_factor(A, ones, lp.row_pad, dtype, ridge, opts.chol_leaf_size)

    def matvec(v):
        return A @ (A.T @ v) + lp.row_pad * v

    x = A.T @ normal_eq_solve(fac, matvec, b, tol=1e-12, max_steps=opts.newton_max_steps)
    y = normal_eq_solve(fac, matvec, A @ c, tol=1e-12, max_steps=opts.newton_max_steps)
    s = c - A.T @ y

    delta_x = jnp.maximum(-1.5 * jnp.min(x), 0.0)
    delta_s = jnp.maximum(-1.5 * jnp.min(s), 0.0)
    x_hat = x + delta_x
    s_hat = s + delta_s
    p = jnp.dot(x_hat, s_hat)
    x = x_hat + 0.5 * p / jnp.sum(s_hat)
    s = s_hat + 0.5 * p / jnp.sum(x_hat)
    return x, y, s


def _alpha_max(v: jnp.ndarray, dv: jnp.ndarray) -> jnp.ndarray:
    """max alpha in [0,1] with v + alpha*dv >= 0 (fractional-step rule;
    reference alpha_max_dev, src/sypha_solver_utils.cu:139-177, as a pure
    masked min-reduction — no D2H sync)."""
    ratios = jnp.where(dv < 0.0, -v / jnp.where(dv < 0.0, dv, -1.0), jnp.inf)
    return jnp.minimum(1.0, jnp.min(ratios))


def _make_state(lp: PaddedLp, x, y, s) -> IpmState:
    n_pad = lp.c.shape[-1]
    one = jnp.asarray(1.0, lp.c.dtype)
    return IpmState(
        x=x,
        y=y,
        s=s,
        mu=jnp.dot(x, s) / n_pad,
        gap=one,
        res_p=one,
        res_d=one,
        iterations=jnp.asarray(0, jnp.int32),
        status=jnp.asarray(IpmStatus.RUNNING, jnp.int32),
        best_gap=jnp.asarray(jnp.inf, lp.c.dtype),
        stall_count=jnp.asarray(0, jnp.int32),
    )


def mehrotra_solve(
    lp: PaddedLp,
    opts: IpmOptions,
    x0=None,
    y0=None,
    s0=None,
) -> IpmState:
    """Full Mehrotra solve as one ``lax.while_loop``.  Optionally warm-started.

    Single-instance; wrap with ``jax.vmap`` for batches (driver.solve_lp_batch).
    """
    from sypha.ipm.shared import use_cg_strategy

    A, b, c = lp.A, lp.b, lp.c
    n_pad = c.shape[-1]
    norm_b = 1.0 + jnp.linalg.norm(b)
    norm_c = 1.0 + jnp.linalg.norm(c)
    dtype, ridge = _factor_params(opts)
    use_cg = use_cg_strategy(opts, lp.m_pad)

    if x0 is None:
        x, y, s = initial_point(lp, opts)
    else:
        x, y, s = x0, y0, s0
    state0 = _make_state(lp, x, y, s)

    def cond(st: IpmState):
        return st.status == IpmStatus.RUNNING

    def body(st: IpmState) -> IpmState:
        x, y, s = st.x, st.y, st.s

        # Fresh residuals every iteration (the reference rescales them
        # incrementally, src/sypha_solver.cpp:714-720; recomputing costs two
        # matvecs and removes float drift on the way to 1e-8).
        r_b = A @ x - b
        r_c = A.T @ y + s - c
        mu = jnp.dot(x, s) / n_pad

        pobj = jnp.dot(c, x)
        dobj = jnp.dot(b, y)
        gap = jnp.abs(pobj - dobj) / (1.0 + jnp.abs(pobj))
        res_p = jnp.linalg.norm(r_b) / norm_b
        res_d = jnp.linalg.norm(r_c) / norm_c

        feasible = jnp.logical_and(res_p < opts.tol_feas, res_d < opts.tol_feas)
        tiny_mu = mu < opts.mu_tol_hard
        converged = jnp.logical_and(
            feasible, jnp.logical_or(gap < opts.tol_gap, tiny_mu)
        )
        # mu -> 0 with a stubborn primal residual is the complementarity
        # signature of an infeasible LP (e.g. a B&B node whose fixings make
        # the cover impossible) — the reference reaches the same verdict via
        # its numerical-failure paths (SURVEY §5 failure detection).
        # Floor 1e-3: a genuinely uncoverable row leaves a RELATIVE residual
        # ~1/norm_b ~ 0.07, while truncated-CG endgame noise (esp. under
        # tensor parallelism, where psum reassociation perturbs the matvec)
        # parks res_p around 1e-5 — 1e3*tol_feas = 1e-5 misclassified those
        # near-optimal iterates as infeasible.
        infeasible = jnp.logical_and(
            tiny_mu, res_p > jnp.maximum(1e3 * opts.tol_feas, 1e-3)
        )
        diverged = jnp.logical_or(
            jnp.logical_or(~jnp.isfinite(mu), mu > opts.mu_max), infeasible
        )
        hit_max = st.iterations >= opts.max_iter

        # gap-stagnation monitor (reference src/sypha_solver.cpp:739-769)
        improved = gap < st.best_gap * (1.0 - opts.gap_stall_min_improv)
        best_gap = jnp.where(improved, gap, st.best_gap)
        stall_count = jnp.where(improved, 0, st.stall_count + 1).astype(jnp.int32)
        stalled = (
            (stall_count >= opts.gap_stall_window)
            if opts.gap_stall_window > 0
            else jnp.asarray(False)
        )

        # --- one predictor-corrector step (computed unconditionally; lanes
        # that just finished discard it via the select below) ---
        # Factor the normal matrix A D^2 A^T in f32; the f64 side of each
        # Newton solve stays matrix-free (2 GEMVs per PCG step), which
        # avoids every O(m^2 n) f64 GEMM.
        d2 = jnp.clip(x / s, opts.d2_min, opts.d2_max)

        def matvec(v):
            return A @ (d2 * (A.T @ v)) + lp.row_pad * v

        if use_cg:
            # Jacobi-CG Krylov path + adaptive tolerance schedule
            # (reference src/sypha_solver_krylov.cu, src/sypha_solver.cpp:552-553)
            diag = (A * A) @ d2 + lp.row_pad
            cg_tol = jnp.maximum(
                opts.cg_tol_final,
                opts.cg_tol_initial
                * opts.cg_tol_decay ** st.iterations.astype(c.dtype),
            )
            solve = lambda f: pcg_solve(
                lambda r: r / jnp.maximum(diag, 1e-300),
                matvec, f, cg_tol, opts.cg_max_iter,
            )
            solve_gate = jnp.maximum(100.0 * cg_tol, 1e-3)
        else:
            fac = normal_eq_factor(
                A, d2, lp.row_pad, dtype, ridge, opts.chol_leaf_size
            )
            solve = lambda f: pcg_solve(
                lambda r: _apply_normal_precond(fac, r),
                matvec, f, opts.newton_tol, opts.newton_max_steps,
            )
            solve_gate = jnp.asarray(1e-3, c.dtype)

        # 1e-30 floor (not 1e-300): sigma*mu/s with s ~ 1e-300 overflows to
        # inf in the Newton rhs and NaNs the step; alpha-max keeps the
        # clamped coordinate's step sane
        s_safe = jnp.maximum(s, 1e-30)

        def newton(r_xs):
            vec1 = r_xs / s_safe
            f = A @ (vec1 - d2 * r_c) - r_b
            dy, solve_rel = solve(f)
            ds = -r_c - A.T @ dy
            dx = -vec1 - d2 * ds
            return dx, dy, ds, solve_rel

        # predictor (affine scaling)
        r_xs = x * s
        dxa, dya, dsa, rel_a = newton(r_xs)
        a_p = _alpha_max(x, dxa)
        a_d = _alpha_max(s, dsa)
        mu_aff = jnp.dot(x + a_p * dxa, s + a_d * dsa) / n_pad
        sigma = (mu_aff / mu) ** opts.sigma_pow

        # corrector, reusing the factor (reference corrector_rhs_dev,
        # src/sypha_solver_utils.cu:51-65: r_xs += dx_aff*ds_aff - sigma*mu)
        dx, dy, ds, rel_c = newton(r_xs + dxa * dsa - sigma * mu)

        eta = (
            jnp.maximum(opts.eta, 1.0 - mu) if opts.adaptive_eta else opts.eta
        )
        alpha_p = jnp.minimum(1.0, eta * _alpha_max(x, dx))
        alpha_d = jnp.minimum(1.0, eta * _alpha_max(s, ds))

        x_new = x + alpha_p * dx
        y_new = y + alpha_d * dy
        s_new = s + alpha_d * ds

        step_ok = jnp.logical_and(
            jnp.all(jnp.isfinite(x_new)),
            jnp.logical_and(jnp.all(jnp.isfinite(y_new)), jnp.all(jnp.isfinite(s_new))),
        )
        # linear-solve quality gates (see ipm.shared): a failed (Jacobi-)CG
        # solve, or a step that blows up primal feasibility, must stop the
        # lane at its current iterate instead of stepping on garbage
        res_p_new = jnp.linalg.norm(A @ x_new - b) / norm_b
        step_bad = res_p_new > jnp.maximum(10.0 * res_p, 1e-4)
        solve_failed = (jnp.maximum(rel_a, rel_c) > solve_gate) | step_bad

        # non-finite step -> GAP_STALLED at the current iterate (numerical
        # exhaustion, not infeasibility); see ipm.shared
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
        stepped = new_status == IpmStatus.RUNNING

        return IpmState(
            x=jnp.where(stepped, x_new, x),
            y=jnp.where(stepped, y_new, y),
            s=jnp.where(stepped, s_new, s),
            mu=mu,
            gap=gap,
            res_p=res_p,
            res_d=res_d,
            iterations=st.iterations + stepped.astype(jnp.int32),
            status=new_status,
            best_gap=best_gap,
            stall_count=stall_count,
        )

    return lax.while_loop(cond, body, state0)
