"""Batched dense linear algebra built from GEMMs.

A native ``cholesky`` and ``triangular_solve`` are sequential in depth: for
the batched m x m systems the IPM produces (m ~ 200-600) they can dominate
the iteration.  ``block_chol_inverse`` replaces them with a 2x2 block
recursion that bottoms out in small XLA factorisations and otherwise
consists purely of batched GEMMs, amortised over the batch (whether a
direct ``lax.linalg.cholesky`` is faster on the GPU is not measured yet):

    M = [[M11, M21^T], [M21, M22]],   L = chol(M) = [[L11, 0], [L21, L22]]
    L11 = chol(M11)
    L21 = M21 L11^{-T}                  (GEMM with the recursively known L11inv)
    S   = M22 - L21 L21^T               (GEMM)
    Linv = [[L11inv, 0], [-L22inv L21 L11inv, L22inv]]   (GEMMs)

Returning L^{-1} explicitly makes every subsequent Newton solve two GEMVs
(L^{-T} (L^{-1} f)) instead of two triangular solves — the analogue of the
reference's factor-once / solve-twice structure
(src/sypha_solver_dense_linear.cpp:156-203) but with the solve cost moved
into matrix products.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def _leaf_chol_inverse(M: jnp.ndarray) -> jnp.ndarray:
    """Base case: XLA cholesky + triangular inverse for small blocks."""
    L = lax.linalg.cholesky(M)
    eye = jnp.broadcast_to(
        jnp.eye(M.shape[-1], dtype=M.dtype), M.shape
    )
    return lax.linalg.triangular_solve(
        L, eye, left_side=True, lower=True, transpose_a=False
    )


def block_chol_inverse(M: jnp.ndarray, leaf_size: int = 64) -> jnp.ndarray:
    """Return L^{-1} where M = L L^T, via 2x2 block recursion.

    M: [..., m, m] SPD.  Static shapes; recursion depth is static.
    """
    m = M.shape[-1]
    if m <= leaf_size:
        return _leaf_chol_inverse(M)

    h = m // 2
    # round the split to a multiple of 8 for sublane alignment
    h -= h % 8
    if h == 0:
        return _leaf_chol_inverse(M)

    M11 = M[..., :h, :h]
    M21 = M[..., h:, :h]
    M22 = M[..., h:, h:]

    L11inv = block_chol_inverse(M11, leaf_size)
    # L21 = M21 L11^{-T}
    L21 = M21 @ jnp.swapaxes(L11inv, -1, -2)
    # Schur complement S = M22 - L21 L21^T
    S = M22 - L21 @ jnp.swapaxes(L21, -1, -2)
    L22inv = block_chol_inverse(S, leaf_size)
    # bottom-left of L^{-1}: -L22^{-1} L21 L11^{-1}
    B = -(L22inv @ (L21 @ L11inv))

    top = jnp.concatenate(
        [L11inv, jnp.zeros(M.shape[:-2] + (h, m - h), M.dtype)], axis=-1
    )
    bot = jnp.concatenate([B, L22inv], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


@partial(jax.jit, static_argnames=("leaf_size",))
def chol_inverse(M: jnp.ndarray, leaf_size: int = 64) -> jnp.ndarray:
    """Jitted block_chol_inverse."""
    return block_chol_inverse(M, leaf_size)


def spd_solve_with_inv(Linv: jnp.ndarray, f: jnp.ndarray) -> jnp.ndarray:
    """Solve M x = f given Linv = L^{-1}: x = L^{-T} (L^{-1} f) as two GEMVs."""
    z = jnp.einsum("...ij,...j->...i", Linv, f)
    return jnp.einsum("...ji,...j->...i", Linv, z)
