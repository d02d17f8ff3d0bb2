"""Mixed-precision SPD solves for the IPM normal equations.

The O(m^2 n) Gram and the O(m^3) factor are the IPM's largest FLOP blocks,
so they run in f32, where the arithmetic is cheapest.  We factor a
Jacobi-equilibrated copy of M in f32 (with a small ridge so the factor
always exists), and recover f64 accuracy by running flexible preconditioned
CG *in f64* with the f32 factor as preconditioner.  Early IPM iterations
need 1-2 CG steps; endgame ill-conditioning costs a few more.  This is the
counterpart of the reference's Jacobi-CG Krylov path with its
per-IPM-iteration adaptive tolerance (src/sypha_solver_krylov.cu:230-393,
src/sypha_solver.cpp:552-553) — except our preconditioner is a full
Cholesky factor, not a diagonal.

All functions are batched ([..., m, m] / [..., m]) and jit/vmap-safe.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax

from sypha.ops.linalg import block_chol_inverse


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SpdFactor:
    """Equilibrated factor of an SPD matrix M = Dg Ms Dg.

    Ms: [..., m, m] f64 equilibrated matrix (unit-ish diagonal)
    Linv: [..., m, m] inverse Cholesky factor of Ms (+ ridge), possibly f32
    dinv: [..., m] 1/sqrt(diag M) equilibration scales (f64)
    """

    Ms: jnp.ndarray
    Linv: jnp.ndarray
    dinv: jnp.ndarray


def spd_factor(
    M: jnp.ndarray,
    factor_dtype=jnp.float32,
    ridge: float = 2e-6,
    leaf_size: int = 64,
) -> SpdFactor:
    """Equilibrate and factor M (SPD, f64)."""
    diag = jnp.diagonal(M, axis1=-2, axis2=-1)
    dinv = lax.rsqrt(jnp.maximum(diag, 1e-300))
    Ms = M * dinv[..., None, :] * dinv[..., :, None]
    m = M.shape[-1]
    Mf = Ms.astype(factor_dtype) + jnp.asarray(ridge, factor_dtype) * jnp.eye(
        m, dtype=factor_dtype
    )
    Linv = block_chol_inverse(Mf, leaf_size=leaf_size)
    return SpdFactor(Ms=Ms, Linv=Linv, dinv=dinv)


def _apply_precond(Linv: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """P r = L^{-T} L^{-1} r, computed in the factor dtype, returned f64."""
    rf = r.astype(Linv.dtype)
    z = jnp.einsum("...ij,...j->...i", Linv, rf)
    z = jnp.einsum("...ji,...j->...i", Linv, z)
    return z.astype(r.dtype)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class NormalEqFactor:
    """Preconditioner factor of the normal matrix M = A D^2 A^T + diag(r).

    Built entirely in the factor dtype (one f32 GEMM + block Cholesky)
    without ever forming M in f64 — the f64 side of the Newton solve stays
    matrix-free (see ``normal_eq_solve``).  This is the counterpart of
    the reference never materialising A D^2 A^T on its Krylov path
    (src/sypha_solver_krylov.cu:305-329).

    Linv: [..., m, m] inverse Cholesky of the equilibrated M (factor dtype)
    dinv: [..., m] equilibration scales 1/sqrt(diag M) (factor dtype)
    """

    Linv: jnp.ndarray
    dinv: jnp.ndarray


def normal_eq_factor(
    A: jnp.ndarray,
    d2: jnp.ndarray,
    row_reg: jnp.ndarray,
    factor_dtype=jnp.float32,
    ridge: float = 2e-6,
    leaf_size: int = 64,
) -> NormalEqFactor:
    """Factor M = A diag(d2) A^T + diag(row_reg) in ``factor_dtype``.

    A: [..., m, n] (any float dtype), d2: [..., n] >= 0, row_reg: [..., m].
    The GEMM runs in the factor dtype; symmetry/PSD-ness is exact
    because M is formed as Aw @ Aw^T with Aw = A * sqrt(d2).
    """
    ft = factor_dtype
    Aw = A.astype(ft) * jnp.sqrt(d2).astype(ft)[..., None, :]
    M = jnp.einsum("...ik,...jk->...ij", Aw, Aw, preferred_element_type=ft)
    m = M.shape[-1]
    M = M + row_reg.astype(ft)[..., :] * jnp.eye(m, dtype=ft)
    diag = jnp.diagonal(M, axis1=-2, axis2=-1)
    dinv = lax.rsqrt(jnp.maximum(diag, jnp.asarray(1e-30, ft)))
    Ms = M * dinv[..., None, :] * dinv[..., :, None]
    Ms = Ms + jnp.asarray(ridge, ft) * jnp.eye(m, dtype=ft)
    Linv = block_chol_inverse(Ms, leaf_size=leaf_size)
    return NormalEqFactor(Linv=Linv, dinv=dinv)


def _apply_normal_precond(fac: NormalEqFactor, r: jnp.ndarray) -> jnp.ndarray:
    """P r = Dg L^{-T} L^{-1} Dg r in the factor dtype, returned in r.dtype."""
    rf = fac.dinv * r.astype(fac.dinv.dtype)
    z = jnp.einsum("...ij,...j->...i", fac.Linv, rf)
    z = jnp.einsum("...ji,...j->...i", fac.Linv, z)
    return (fac.dinv * z).astype(r.dtype)


def pcg_solve(
    precond: Callable[[jnp.ndarray], jnp.ndarray],
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    f: jnp.ndarray,
    tol: jnp.ndarray | float = 1e-10,
    max_steps: int = 40,
) -> jnp.ndarray:
    """Flexible (Polak-Ribiere) PCG in f.dtype, fully matrix-free and
    batch-first.  ``precond`` may be inexact/low-precision (an f32 Cholesky
    apply, a Jacobi diagonal); flexibility restores convergence anyway.

    This one loop serves both reference linear-solve paths: with the f32
    Cholesky preconditioner it plays the dense-factor role
    (src/sypha_solver_dense_linear.cpp), with Jacobi it IS the Krylov path
    (krylovSolveCG, src/sypha_solver_krylov.cu:230-393) minus the per-CG-step
    device->host syncs the reference pays for every cuBLAS dot (SURVEY §3.4).
    """
    norm_f = jnp.linalg.norm(f, axis=-1, keepdims=True)
    thresh = tol * jnp.maximum(norm_f, 1e-300)

    x0 = precond(f)
    r0 = f - matvec(x0)
    z0 = precond(r0)
    rz0 = jnp.sum(r0 * z0, axis=-1, keepdims=True)

    def cond(carry):
        x, r, z, p, rz, k = carry
        rnorm = jnp.linalg.norm(r, axis=-1, keepdims=True)
        return jnp.logical_and(k < max_steps, jnp.any(rnorm > thresh))

    def body(carry):
        x, r, z, p, rz, k = carry
        Ap = matvec(p)
        pAp = jnp.sum(p * Ap, axis=-1, keepdims=True)
        ok = pAp > 0.0
        alpha = jnp.where(ok, rz / jnp.where(ok, pAp, 1.0), 0.0)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        rz_new = jnp.sum(r_new * z_new, axis=-1, keepdims=True)
        # flexible (Polak-Ribiere) beta: robust to an inexact preconditioner
        num = jnp.sum((r_new - r) * z_new, axis=-1, keepdims=True)
        beta = jnp.where(jnp.abs(rz) > 0, num / jnp.where(jnp.abs(rz) > 0, rz, 1.0), 0.0)
        p_new = z_new + beta * p
        return (x_new, r_new, z_new, p_new, rz_new, k + 1)

    x, r, *_ = lax.while_loop(
        cond, body, (x0, r0, z0, z0, rz0, jnp.asarray(0, jnp.int32))
    )
    # achieved relative residual per lane — callers use it to reject steps
    # when the linear solve failed (the reference's CG-breakdown detection,
    # src/sypha_solver_krylov.cu:335-339, :370-374)
    rel = jnp.linalg.norm(r, axis=-1) / jnp.maximum(norm_f[..., 0], 1e-300)
    return x, rel


def normal_eq_solve(
    fac: NormalEqFactor,
    matvec: Callable[[jnp.ndarray], jnp.ndarray],
    f: jnp.ndarray,
    tol: jnp.ndarray | float = 1e-10,
    max_steps: int = 40,
) -> jnp.ndarray:
    """Solve M x = f with the f32 Cholesky factor as PCG preconditioner.

    ``matvec`` applies the exact f64 operator v -> A (d2 * (A^T v)) + reg*v;
    the f32 factor is only a preconditioner, so the result converges to full
    f64 accuracy at ~2 cheap matvecs per step instead of an O(m^2 n) f64
    GEMM per IPM iteration.
    """
    return pcg_solve(
        lambda r: _apply_normal_precond(fac, r), matvec, f, tol, max_steps
    )[0]


def spd_solve(
    fac: SpdFactor,
    f: jnp.ndarray,
    tol: jnp.ndarray | float = 1e-12,
    max_steps: int = 50,
) -> jnp.ndarray:
    """Solve M x = f to relative residual ``tol`` (on the equilibrated
    system) via flexible PCG in f64 preconditioned by the f32 factor.

    ``tol`` may be a traced scalar (the IPM feeds its per-iteration
    tolerance schedule).  Returns x in f64.
    """
    fs = fac.dinv * f
    norm_fs = jnp.linalg.norm(fs, axis=-1, keepdims=True)
    thresh = tol * jnp.maximum(norm_fs, 1e-300)

    Ms = fac.Ms

    def matvec(v):
        return jnp.einsum("...ij,...j->...i", Ms, v)

    x0 = _apply_precond(fac.Linv, fs)
    r0 = fs - matvec(x0)
    z0 = _apply_precond(fac.Linv, r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0, axis=-1, keepdims=True)

    def cond(carry):
        x, r, z, p, rz, r_prev, k = carry
        rnorm = jnp.linalg.norm(r, axis=-1, keepdims=True)
        return jnp.logical_and(k < max_steps, jnp.any(rnorm > thresh))

    def body(carry):
        x, r, z, p, rz, r_prev, k = carry
        Ap = matvec(p)
        pAp = jnp.sum(p * Ap, axis=-1, keepdims=True)
        # guard against breakdown (non-SPD rounding): freeze the lane
        ok = pAp > 0.0
        alpha = jnp.where(ok, rz / jnp.where(ok, pAp, 1.0), 0.0)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z_new = _apply_precond(fac.Linv, r_new)
        # flexible (Polak-Ribiere) beta: robust to the inexact f32 precond
        rz_new = jnp.sum(r_new * z_new, axis=-1, keepdims=True)
        num = jnp.sum((r_new - r) * z_new, axis=-1, keepdims=True)
        beta = jnp.where(jnp.abs(rz) > 0, num / jnp.where(jnp.abs(rz) > 0, rz, 1.0), 0.0)
        p_new = z_new + beta * p
        return (x_new, r_new, z_new, p_new, rz_new, r, k + 1)

    x, r, *_ = lax.while_loop(
        cond, body, (x0, r0, z0, p0, rz0, r0, jnp.asarray(0, jnp.int32))
    )
    return fac.dinv * x
