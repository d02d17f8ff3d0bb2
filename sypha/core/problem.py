"""Problem containers.

``ScpModel`` is the host-side parsed set-covering instance (numpy, ragged).
``PaddedLp`` is the device-side fixed-shape standard-form LP pytree the IPM
consumes; it replaces the reference's SyphaNodeSparse host+device CSR state
(src/sypha_node_sparse.h:26-119) with a functional, batchable container.

Padding convention (mask-free hot loop):
  * pad columns are genuine LP variables with cost 1 and an all-zero
    constraint column — the optimum leaves them at 0 and the interior-point
    dynamics keep them strictly interior, so no masks are needed;
  * pad rows are ``0 = 0`` constraints; ``row_pad`` carries 1.0 on pad rows
    and is added to the diagonal of A D^2 A^T (and A A^T during the initial
    point) so the Cholesky factor stays SPD with dy = 0 on pad rows.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List

import jax
import numpy as np
import jax.numpy as jnp


@dataclass
class ScpModel:
    """A parsed set-covering instance: min c.x  s.t.  sum_{j in row i} x_j >= 1.

    ``rows[i]`` holds the 0-based column indices covering row i (the on-disk
    format is 1-based; see reference src/model_reader.cpp:137-143).
    """

    nrows: int
    ncols: int
    costs: np.ndarray  # [ncols] float64
    rows: List[np.ndarray]  # nrows arrays of int32 column indices (0-based)
    name: str = ""

    @property
    def nnz(self) -> int:
        return int(sum(len(r) for r in self.rows))

    def dense_matrix(self) -> np.ndarray:
        """The 0/1 covering matrix [nrows, ncols] (before standard form)."""
        A = np.zeros((self.nrows, self.ncols), dtype=np.float64)
        for i, cols in enumerate(self.rows):
            A[i, cols] = 1.0
        return A


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PaddedLp:
    """Fixed-shape standard-form LP:  min c.x  s.t.  A x = b, x >= 0.

    For SCP this is ``[A0 | -I]`` with b = 1 (reference
    src/model_reader.cpp:146-157).  All arrays are padded; see module
    docstring for the padding convention.

    Leaves (batchable — a stacked batch simply has a leading [B] axis):
      A: [m_pad, n_pad] f64; b: [m_pad]; c: [n_pad];
      row_pad: [m_pad] (1.0 on pad rows, else 0);
      m_real, n_real, n_struct: int32 scalars for reporting/masks outside the
      hot loop (n_struct = structural columns before surplus columns).
    """

    A: jnp.ndarray
    b: jnp.ndarray
    c: jnp.ndarray
    row_pad: jnp.ndarray
    m_real: jnp.ndarray
    n_real: jnp.ndarray
    n_struct: jnp.ndarray

    @property
    def m_pad(self) -> int:
        return self.A.shape[-2]

    @property
    def n_pad(self) -> int:
        return self.A.shape[-1]

    @property
    def batch_shape(self):
        return self.A.shape[:-2]
