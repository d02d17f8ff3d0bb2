"""Standard-form construction and fixed-shape padding.

``scp_standard_form`` converts an ScpModel to  min c.x, A x = b, x >= 0 with
A = [A0 | -I] and b = 1 — every covering row gains a surplus column with
coefficient -1 (reference src/model_reader.cpp:146-157 does the same during
reading).

``pad_lp`` then pads to a fixed (m_pad, n_pad) bucket so jit compiles once
per bucket; see core.problem.PaddedLp for the padding convention.  Buckets
default to n rounded to 128 and m rounded to 8, GEMM-friendly multiples that
XLA tiles further internally.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from sypha.core.problem import PaddedLp, ScpModel

# device-side EllMatrix operators keyed by content digest (see
# pad_standard_form_ell); insertion-ordered dict as a 4-entry LRU
_ELL_DEVICE_CACHE: dict = {}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_dims(
    m: int,
    n: int,
    row_multiple: int = 8,
    col_multiple: int = 128,
    extra_rows: int = 0,
) -> Tuple[int, int]:
    """Padded dims for a standard-form LP with m rows, n columns.

    ``extra_rows`` reserves space for B&B branch rows / cuts (each added row
    also adds one surplus column).
    """
    mp = _round_up(m + extra_rows, row_multiple)
    np_ = _round_up(n + extra_rows, col_multiple)
    return mp, np_


def scp_standard_form(model: ScpModel) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense standard form (A, b, c) with A = [A0 | -I], b = 1, c = [costs, 0]."""
    m, n0 = model.nrows, model.ncols
    n = n0 + m
    A = np.zeros((m, n), dtype=np.float64)
    for i, cols in enumerate(model.rows):
        A[i, cols] = 1.0
        A[i, n0 + i] = -1.0
    b = np.ones(m, dtype=np.float64)
    c = np.concatenate([model.costs.astype(np.float64), np.zeros(m)])
    return A, b, c


def pad_standard_form(
    A: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    n_struct: int,
    m_pad: Optional[int] = None,
    n_pad: Optional[int] = None,
    extra_rows: int = 0,
) -> PaddedLp:
    """Pad an explicit standard-form (A, b, c) into a PaddedLp."""
    m, n = A.shape
    auto_mp, auto_np = bucket_dims(m, n, extra_rows=extra_rows)
    mp = m_pad if m_pad is not None else auto_mp
    np_ = n_pad if n_pad is not None else auto_np
    if mp < m or np_ < n:
        raise ValueError(f"padded dims ({mp},{np_}) smaller than real dims ({m},{n})")

    Ap = np.zeros((mp, np_), dtype=np.float64)
    Ap[:m, :n] = A
    bp = np.zeros(mp, dtype=np.float64)
    bp[:m] = b
    cp = np.ones(np_, dtype=np.float64)  # pad columns get cost 1 (kept interior, -> 0)
    cp[:n] = c
    row_pad = np.zeros(mp, dtype=np.float64)
    row_pad[m:] = 1.0

    return PaddedLp(
        A=jnp.asarray(Ap),
        b=jnp.asarray(bp),
        c=jnp.asarray(cp),
        row_pad=jnp.asarray(row_pad),
        m_real=jnp.asarray(m, dtype=jnp.int32),
        n_real=jnp.asarray(n, dtype=jnp.int32),
        n_struct=jnp.asarray(n_struct, dtype=jnp.int32),
    )


def pad_lp(
    model: ScpModel,
    m_pad: Optional[int] = None,
    n_pad: Optional[int] = None,
    extra_rows: int = 0,
) -> PaddedLp:
    """ScpModel -> padded device LP (standard form + bucket padding)."""
    A, b, c = scp_standard_form(model)
    return pad_standard_form(
        A, b, c, n_struct=model.ncols, m_pad=m_pad, n_pad=n_pad, extra_rows=extra_rows
    )


def pad_standard_form_ell(
    row_data,
    rhs: np.ndarray,
    costs: np.ndarray,
    n_struct: int,
    m_pad: int,
    n_pad: int,
) -> PaddedLp:
    """Sparse (padded-ELL) counterpart of pad_standard_form.

    ``row_data``: per row, (structural column indices, values); each row i
    implicitly gains its surplus column n_struct + i with -1 (same standard
    form the reference reader emits, src/model_reader.cpp:146-157).
    ``costs``: structural costs [n_struct] — surplus columns get cost 0,
    pad columns cost 1 (same conventions as pad_standard_form).  The dense
    [m_pad, n_pad] f64 matrix never exists; every product on the returned
    LP is matrix-free through ops.ell.EllMatrix.
    """
    from sypha.ops.ell import ell_from_rows

    m = len(row_data)
    n = n_struct + m
    if m_pad < m or n_pad < n:
        raise ValueError(f"padded dims ({m_pad},{n_pad}) smaller than real ({m},{n})")
    # Content-addressed device-operator cache: the ELL arrays depend only on
    # the exact row content and padding, and the driver rebuilds the SAME
    # operator repeatedly — every rc-fix refresh (the mask lives in c, not
    # A) and every core-search child (same ScpModel, fresh BaseModel).
    # Each rebuild would re-upload tens of MB to the device.  Keyed by a
    # blake2b digest of (dims, indices, values) so the hit is exact, never
    # heuristic.
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray([n_struct, m_pad, n_pad, m], dtype=np.int64).tobytes())
    for idx, val in row_data:
        h.update(np.ascontiguousarray(idx, dtype=np.int32).tobytes())
        h.update(np.ascontiguousarray(val, dtype=np.float64).tobytes())
    key = h.digest()
    A = _ELL_DEVICE_CACHE.get(key)
    if A is None:
        A = ell_from_rows(row_data, n_struct=n_struct, m_pad=m_pad, n_pad=n_pad)
        if len(_ELL_DEVICE_CACHE) >= 4:  # tiny LRU: drop the oldest
            _ELL_DEVICE_CACHE.pop(next(iter(_ELL_DEVICE_CACHE)))
        _ELL_DEVICE_CACHE[key] = A
    bp = np.zeros(m_pad, dtype=np.float64)
    bp[:m] = rhs
    cp = np.ones(n_pad, dtype=np.float64)
    cp[:n_struct] = costs
    cp[n_struct:n] = 0.0
    row_pad = np.zeros(m_pad, dtype=np.float64)
    row_pad[m:] = 1.0
    return PaddedLp(
        A=A,
        b=jnp.asarray(bp),
        c=jnp.asarray(cp),
        row_pad=jnp.asarray(row_pad),
        m_real=jnp.asarray(m, dtype=jnp.int32),
        n_real=jnp.asarray(n, dtype=jnp.int32),
        n_struct=jnp.asarray(n_struct, dtype=jnp.int32),
    )


def stack_lps(lps: Sequence[PaddedLp]) -> PaddedLp:
    """Stack same-bucket PaddedLps into one batched PaddedLp with leading [B]."""
    shapes = {(lp.m_pad, lp.n_pad) for lp in lps}
    if len(shapes) != 1:
        raise ValueError(f"cannot stack LPs from different buckets: {sorted(shapes)}")
    return PaddedLp(
        A=jnp.stack([lp.A for lp in lps]),
        b=jnp.stack([lp.b for lp in lps]),
        c=jnp.stack([lp.c for lp in lps]),
        row_pad=jnp.stack([lp.row_pad for lp in lps]),
        m_real=jnp.stack([lp.m_real for lp in lps]),
        n_real=jnp.stack([lp.n_real for lp in lps]),
        n_struct=jnp.stack([lp.n_struct for lp in lps]),
    )
