"""sypha — a batched interior-point LP/MILP solver for set-covering problems.

A from-scratch JAX/XLA rebuild of the capabilities of the reference
CUDA solver (caerbannogwhite/sypha): a Mehrotra predictor–corrector LP core,
SCP presolve, branch & bound with cuts and rounding heuristics, and an
OR-Tools-style modeling API.

Design (batch-first, not a port):
  * batch-first: the IPM is written for ``[B, ...]`` batches of LPs; ``vmap``
    provides instance- and B&B-node-parallelism, ``shard_map`` spreads the
    batch over a ``jax.sharding.Mesh``.
  * fixed shapes: every instance is padded to a size bucket so jit compiles
    once.  Padding is *trivially feasible LP structure* (cost-1 unconstrained
    columns, ``0 = 0`` rows) rather than masks, so the hot loop is mask-free.
  * resident state: one ``IpmState`` pytree lives on device; the host touches
    scalars and B&B bookkeeping only.
  * normal equations, not the 3x3 KKT: we form ``A D^2 A^T`` (m x m, m << n
    for SCP) and Cholesky/CG it, instead of the large indefinite KKT system
    the reference builds for cusolverSp (see reference src/sypha_solver.cpp:96-186).

f64 note: interior-point methods need ~1e-8 duality gaps, so the numeric core
runs f64 by default.  x64 must be enabled before any JAX computation, hence
the config update at import time.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)
# f32 matmuls may otherwise run in reduced precision (TF32 on the GPU's
# tensor cores, ~1e-3 relative error) — fatal for the f32 Cholesky factors
# in ops.linalg.  Force true-f32 matmuls.
_jax.config.update("jax_default_matmul_precision", "highest")


def _default_cache_dir() -> str:
    """Persistent compilation cache location: JAX reads
    JAX_COMPILATION_CACHE_DIR itself when it is set; otherwise a fixed
    directory inside the checkout (listed in .gitignore) so that every
    process of one checkout shares, and hits, the same cache."""
    return _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )


if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _default_cache_dir())
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from sypha.config import SolverConfig, IpmOptions  # noqa: E402
from sypha.core.status import IpmStatus, MilpStatus  # noqa: E402
from sypha.core.problem import ScpModel, PaddedLp  # noqa: E402
from sypha.io.scp_reader import read_scp_file, parse_scp_text  # noqa: E402
from sypha.io.standard_form import (  # noqa: E402
    scp_standard_form,
    pad_lp,
    stack_lps,
)
from sypha.ipm.driver import solve_lp, solve_lp_batch  # noqa: E402
from sypha.ipm.shared import (  # noqa: E402
    SharedLpBatch,
    make_shared_batch,
    make_shared_batch_auto,
    make_shared_batch_sparse,
    mehrotra_solve_shared,
)
from sypha.ops.ell import EllMatrix  # noqa: E402
from sypha.api import Solver, SolverParameters, ResultStatus  # noqa: E402
from sypha.milp.bnb import MilpResult, branch_and_bound  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "Solver",
    "SolverParameters",
    "ResultStatus",
    "MilpResult",
    "branch_and_bound",
    "SharedLpBatch",
    "EllMatrix",
    "make_shared_batch",
    "make_shared_batch_auto",
    "make_shared_batch_sparse",
    "mehrotra_solve_shared",
    "SolverConfig",
    "IpmOptions",
    "IpmStatus",
    "MilpStatus",
    "ScpModel",
    "PaddedLp",
    "read_scp_file",
    "parse_scp_text",
    "scp_standard_form",
    "pad_lp",
    "stack_lps",
    "solve_lp",
    "solve_lp_batch",
]
