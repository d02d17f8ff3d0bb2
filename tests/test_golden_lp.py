"""Golden-value LP integration tests (reference python/sypha_unit_tests.py
tables, tol 1e-4): every instance family solves as one grouped shared-matrix
batch, matching the reference's end-to-end test strategy (SURVEY §4.1)."""

import numpy as np
import pytest

from sypha.testing import ACCEPT_TOL, GOLDEN_LP


def _solve_family(names, data_dir, lanes=1):
    import jax
    import jax.numpy as jnp

    from sypha import pad_lp, read_scp_file
    from sypha.config import IpmOptions
    from sypha.core.status import IpmStatus
    from sypha.ipm.shared import make_shared_batch, mehrotra_solve_shared

    models = [read_scp_file(str(data_dir / f"{n}.txt")) for n in names]
    mp = max(m.nrows for m in models)
    np_ = max(m.nrows + m.ncols for m in models)
    mp += (-mp) % 8
    np_ += (-np_) % 128
    batches = [
        make_shared_batch(pad_lp(m, m_pad=mp, n_pad=np_), lanes) for m in models
    ]
    grouped = jax.tree.map(lambda *xs: jnp.stack(xs), *batches)
    opts = IpmOptions()
    st = jax.jit(jax.vmap(lambda g: mehrotra_solve_shared(g, opts)))(grouped)
    pobj = np.einsum("gln,gln->gl", np.asarray(grouped.c), np.asarray(st.x))
    dobj = np.einsum("glm,glm->gl", np.asarray(grouped.b), np.asarray(st.y))
    status = np.asarray(st.status)
    return pobj[:, 0], dobj[:, 0], status[:, 0]


@pytest.mark.parametrize("family", ["scp4", "scp5"])
def test_golden_lp_family(family, data_dir):
    names = [f"{family}{i}" for i in range(1, 10)] + [f"{family}10"]
    pobj, dobj, status = _solve_family(names, data_dir)
    from sypha.core.status import IpmStatus

    for i, n in enumerate(names):
        golden = GOLDEN_LP[n]
        assert status[i] == IpmStatus.CONVERGED, (n, status[i])
        assert abs(pobj[i] - golden) < ACCEPT_TOL, (n, pobj[i], golden)
        assert abs(dobj[i] - golden) < ACCEPT_TOL, (n, dobj[i], golden)


@pytest.mark.slow
@pytest.mark.parametrize("family", ["scpnre", "scpnrf", "scpnrg", "scpnrh"])
def test_golden_lp_large_family(family, data_dir):
    names = [f"{family}{i}" for i in range(1, 6)]
    pobj, dobj, status = _solve_family(names, data_dir)
    from sypha.core.status import IpmStatus

    for i, n in enumerate(names):
        golden = GOLDEN_LP[n]
        assert status[i] == IpmStatus.CONVERGED, (n, status[i])
        assert abs(pobj[i] - golden) < ACCEPT_TOL, (n, pobj[i], golden)
        assert abs(dobj[i] - golden) < ACCEPT_TOL, (n, dobj[i], golden)
