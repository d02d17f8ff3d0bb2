"""block_chol_inverse vs numpy oracle."""

import numpy as np
import jax.numpy as jnp

from sypha.ops.linalg import chol_inverse, spd_solve_with_inv


def _random_spd(rng, B, m, cond_scale=1.0):
    G = rng.standard_normal((B, m, 3 * m))
    M = G @ np.swapaxes(G, -1, -2) + m * np.eye(m)
    # optionally worsen conditioning like an IPM normal matrix
    d = cond_scale ** rng.uniform(-1, 1, (B, m))
    return d[:, :, None] * M * d[:, None, :]


def test_chol_inverse_matches_numpy():
    rng = np.random.default_rng(0)
    for m in [8, 40, 200]:
        M = _random_spd(rng, 3, m)
        Linv = np.asarray(chol_inverse(jnp.asarray(M)))
        L = np.linalg.cholesky(M)
        err = np.max(np.abs(Linv @ L - np.eye(m)))
        assert err < 1e-10, (m, err)


def test_chol_inverse_solve():
    rng = np.random.default_rng(1)
    m = 200
    M = _random_spd(rng, 4, m, cond_scale=1e3)
    f = rng.standard_normal((4, m))
    Linv = chol_inverse(jnp.asarray(M))
    x = np.asarray(spd_solve_with_inv(Linv, jnp.asarray(f)))
    x_np = np.linalg.solve(M, f[..., None])[..., 0]
    rel = np.max(np.abs(x - x_np)) / np.max(np.abs(x_np))
    assert rel < 1e-8, rel


def test_chol_inverse_ill_conditioned():
    """IPM-like conditioning: diagonal spread ~1e10."""
    rng = np.random.default_rng(2)
    m = 64
    M = _random_spd(rng, 2, m, cond_scale=1e5)
    f = rng.standard_normal((2, m))
    Linv = chol_inverse(jnp.asarray(M))
    x = np.asarray(spd_solve_with_inv(Linv, jnp.asarray(f)))
    r = f - np.einsum("bij,bj->bi", M, x)
    # residual should be small relative to M and x
    rel = np.linalg.norm(r, axis=-1) / (
        np.linalg.norm(M, axis=(1, 2)) * np.linalg.norm(x, axis=-1)
    )
    assert np.all(rel < 1e-12), rel
