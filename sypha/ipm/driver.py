"""Solve drivers: jitted single-instance and vmapped batch entry points.

Replaces the reference's host-orchestrated solver entry
``solver_sparse_mehrotra_run`` (src/sypha_solver.cpp:42-886).  The batch
driver is the feature the reference lacks: one compiled program
advances a whole batch of LPs (instances or B&B nodes), and the batch axis
can be sharded over a ``jax.sharding.Mesh`` (see sypha.parallel.mesh).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sypha.config import IpmOptions
from sypha.core.problem import PaddedLp
from sypha.core.status import IpmStatus
from sypha.ipm.dense import IpmState, mehrotra_solve


@dataclass
class IpmResult:
    """Host-side result mirror of the reference SolverExecutionResult
    (src/sypha_solver_sparse.h:22-47)."""

    status: IpmStatus
    primal_objective: float
    dual_objective: float
    iterations: int
    mu: float
    gap: float
    res_primal: float
    res_dual: float
    x: np.ndarray  # primal values over real columns (incl. surplus cols)
    y: np.ndarray  # duals over real rows

    @property
    def converged(self) -> bool:
        return self.status == IpmStatus.CONVERGED


@partial(jax.jit, static_argnames=("opts",))
def _solve_single(lp: PaddedLp, opts: IpmOptions) -> IpmState:
    return mehrotra_solve(lp, opts)


@partial(jax.jit, static_argnames=("opts",))
def _solve_batch(lp: PaddedLp, opts: IpmOptions) -> IpmState:
    return jax.vmap(lambda p: mehrotra_solve(p, opts))(lp)


@partial(jax.jit, static_argnames=("opts",))
def _solve_batch_warm(
    lp: PaddedLp, x0: jnp.ndarray, y0: jnp.ndarray, s0: jnp.ndarray, opts: IpmOptions
) -> IpmState:
    return jax.vmap(lambda p, x, y, s: mehrotra_solve(p, opts, x, y, s))(
        lp, x0, y0, s0
    )


def _extract_host(host_lp: dict, host_st: dict, lane=None) -> IpmResult:
    """Build an IpmResult from already-fetched numpy copies of the state.

    Fetching happens once for the whole batch (jax.device_get) — per-lane
    device indexing would pay one device round-trip per field per lane,
    which would dominate wall time for a large batch.
    """
    idx = (lane,) if lane is not None else ()

    def g(d, k):
        v = d[k]
        return v[idx] if lane is not None else v

    x = g(host_st, "x")
    y = g(host_st, "y")
    c = g(host_lp, "c")
    b = g(host_lp, "b")
    n_real = int(g(host_lp, "n_real"))
    m_real = int(g(host_lp, "m_real"))
    return IpmResult(
        status=IpmStatus(int(g(host_st, "status"))),
        primal_objective=float(c[:n_real] @ x[:n_real]),
        dual_objective=float(b[:m_real] @ y[:m_real]),
        iterations=int(g(host_st, "iterations")),
        mu=float(g(host_st, "mu")),
        gap=float(g(host_st, "gap")),
        res_primal=float(g(host_st, "res_p")),
        res_dual=float(g(host_st, "res_d")),
        x=x[:n_real],
        y=y[:m_real],
    )


def _fetch(lp: PaddedLp, st: IpmState):
    host_lp = jax.device_get(
        {"c": lp.c, "b": lp.b, "n_real": lp.n_real, "m_real": lp.m_real}
    )
    host_st = jax.device_get(
        {
            "x": st.x,
            "y": st.y,
            "status": st.status,
            "iterations": st.iterations,
            "mu": st.mu,
            "gap": st.gap,
            "res_p": st.res_p,
            "res_d": st.res_d,
        }
    )
    return host_lp, host_st


def solve_lp(lp: PaddedLp, opts: Optional[IpmOptions] = None) -> IpmResult:
    """Solve one padded LP; returns a host-side IpmResult."""
    opts = opts or IpmOptions()
    st = _solve_single(lp, opts)
    host_lp, host_st = _fetch(lp, st)
    return _extract_host(host_lp, host_st)


def solve_lp_batch(
    lp: PaddedLp,
    opts: Optional[IpmOptions] = None,
    warm_start: Optional[tuple] = None,
    as_results: bool = True,
):
    """Solve a stacked batch of padded LPs (leading [B] axis on every leaf).

    With ``as_results=False`` returns the raw batched IpmState (device
    resident — used by the B&B driver to avoid host round-trips).
    ``warm_start`` is an optional (x0, y0, s0) batch.
    """
    opts = opts or IpmOptions()
    if warm_start is not None:
        st = _solve_batch_warm(lp, *warm_start, opts)
    else:
        st = _solve_batch(lp, opts)
    if not as_results:
        return st
    B = st.x.shape[0]
    host_lp, host_st = _fetch(lp, st)
    return [_extract_host(host_lp, host_st, lane=i) for i in range(B)]
