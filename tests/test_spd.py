"""Mixed-precision SPD solver vs numpy, including IPM-grade conditioning."""

import numpy as np
import jax.numpy as jnp

from sypha.ops.spd import spd_factor, spd_solve


def _ipm_like_system(rng, B, m, n, spread):
    """Normal-equations-like matrices A D^2 A^T with diagonal spread."""
    A = (rng.random((B, m, n)) < 0.05).astype(np.float64)
    A[..., -m:] = -np.eye(m)  # surplus block keeps rows independent
    d2 = 10.0 ** rng.uniform(-spread, spread, (B, n))
    M = (A * d2[:, None, :]) @ np.swapaxes(A, -1, -2)
    return M


def test_spd_solve_f32_factor_well_conditioned():
    rng = np.random.default_rng(0)
    M = _ipm_like_system(rng, 4, 64, 400, spread=1.0)
    f = rng.standard_normal((4, 64))
    fac = spd_factor(jnp.asarray(M))
    x = np.asarray(spd_solve(fac, jnp.asarray(f), tol=1e-12))
    x_np = np.linalg.solve(M, f[..., None])[..., 0]
    rel = np.max(np.abs(x - x_np)) / np.max(np.abs(x_np))
    assert rel < 1e-9, rel


def test_spd_solve_f32_factor_ipm_endgame():
    """D^2 spread 1e-6..1e6 (mu ~ 1e-6 endgame): f32 factor + f64 PCG must
    still reach ~1e-9 relative residual."""
    rng = np.random.default_rng(1)
    M = _ipm_like_system(rng, 4, 64, 400, spread=6.0)
    f = rng.standard_normal((4, 64))
    fac = spd_factor(jnp.asarray(M))
    x = np.asarray(spd_solve(fac, jnp.asarray(f), tol=1e-11, max_steps=100))
    r = f - np.einsum("bij,bj->bi", M, x)
    # relative residual on the equilibrated scale
    dinv = 1.0 / np.sqrt(np.diagonal(M, axis1=1, axis2=2))
    rs = dinv * r
    fs = dinv * f
    rel = np.linalg.norm(rs, axis=-1) / np.linalg.norm(fs, axis=-1)
    assert np.all(rel < 1e-9), rel


def test_spd_solve_f64_factor_path():
    rng = np.random.default_rng(2)
    M = _ipm_like_system(rng, 2, 40, 200, spread=3.0)
    f = rng.standard_normal((2, 40))
    fac = spd_factor(jnp.asarray(M), factor_dtype=jnp.float64, ridge=1e-12)
    x = np.asarray(spd_solve(fac, jnp.asarray(f), tol=1e-13))
    x_np = np.linalg.solve(M, f[..., None])[..., 0]
    rel = np.max(np.abs(x - x_np)) / np.max(np.abs(x_np))
    assert rel < 1e-8, rel


def test_spd_solve_traced_tol():
    """tol can be a traced jnp scalar (IPM feeds a schedule)."""
    import jax

    rng = np.random.default_rng(3)
    M = _ipm_like_system(rng, 2, 32, 128, spread=2.0)
    f = rng.standard_normal((2, 32))

    @jax.jit
    def run(M, f, tol):
        fac = spd_factor(M)
        return spd_solve(fac, f, tol=tol)

    x = np.asarray(run(jnp.asarray(M), jnp.asarray(f), jnp.asarray(1e-10)))
    x_np = np.linalg.solve(M, f[..., None])[..., 0]
    assert np.max(np.abs(x - x_np)) / np.max(np.abs(x_np)) < 1e-7
