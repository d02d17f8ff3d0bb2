"""ctypes bindings for the native host runtime (csrc/sypha_host.cpp).

The reference's host runtime is C++ (model reader src/model_reader.cpp,
presolve src/sypha_preprocessor.cpp); this module loads this package's
native counterpart.  The library is compiled on first use (g++) into a file
named by a key over the source digest, the compiler flags and the host CPU
model, so a build from another machine or an older source is never loaded.
If compilation fails every entry point reports unavailable and callers fall
back to the numpy implementations — behavior is identical either way, the
native library is purely a host-side speedup.  ``make`` builds the same file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.abspath(os.path.join(_HERE, "..", "csrc", "sypha_host.cpp"))
CXX = "g++"
CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def cpu_model() -> str:
    """The host CPU's model name (``-march=native`` code is only valid on it)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def library_key(source: bytes, flags=(CXX, *CXXFLAGS), cpu: Optional[str] = None) -> str:
    """16-hex-digit key over the source digest, compiler flags and CPU model."""
    h = hashlib.sha256()
    h.update(hashlib.sha256(source).digest())
    h.update("\0".join(flags).encode())
    h.update((cpu_model() if cpu is None else cpu).encode())
    return h.hexdigest()[:16]


def library_path() -> str:
    """Path of the build for this source, flags and host (SYPHA_NATIVE_LIB
    overrides it, e.g. to A/B an engine variant as benchmark/face_replay.py
    --lib does)."""
    override = os.environ.get("SYPHA_NATIVE_LIB")
    if override:
        return override
    with open(_SRC, "rb") as f:
        key = library_key(f.read())
    return os.path.join(_HERE, f"libsypha_host-{key}.so")


def build(path: Optional[str] = None) -> str:
    """Compile csrc/sypha_host.cpp to ``path`` (default ``library_path()``).

    Writes a temporary file and renames it into place, so a process that has
    an older build mapped never sees it truncated."""
    path = path or library_path()
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [CXX, *CXXFLAGS, "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.sypha_scp_open.restype = ctypes.c_void_p
    lib.sypha_scp_open.argtypes = [ctypes.c_char_p]
    lib.sypha_scp_dims.restype = None
    lib.sypha_scp_dims.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sypha_scp_fill.restype = None
    lib.sypha_scp_fill.argtypes = [ctypes.c_void_p, f64p, i64p, i32p]
    lib.sypha_scp_close.restype = None
    lib.sypha_scp_close.argtypes = [ctypes.c_void_p]

    lib.sypha_greedy_set_cover.restype = ctypes.c_int
    lib.sypha_greedy_set_cover.argtypes = [
        i64p, i32p, f64p, u8p,
        ctypes.c_int, ctypes.c_int,
        i32p, ctypes.POINTER(ctypes.c_double),
    ]

    lib.sypha_single_column_dominance.restype = ctypes.c_int
    lib.sypha_single_column_dominance.argtypes = [
        u64p, ctypes.c_int, f64p, u8p, ctypes.c_int,
        ctypes.c_double, ctypes.c_double,
    ]
    shared = [
        u64p, ctypes.c_int, f64p, u8p, ctypes.c_int,
        i64p, i32p, ctypes.c_int, i64p, i32p,
        ctypes.c_double, ctypes.c_double,
    ]
    lib.sypha_two_column_dominance.restype = ctypes.c_int
    lib.sypha_two_column_dominance.argtypes = shared
    lib.sypha_cost_driven_replacement.restype = ctypes.c_int
    lib.sypha_cost_driven_replacement.argtypes = shared
    lib.sypha_budget_pruning.restype = ctypes.c_int
    lib.sypha_budget_pruning.argtypes = [
        u64p, ctypes.c_int, f64p, u8p, ctypes.c_int,
        i64p, i32p, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
    ]
    lib.sypha_exact_cover.restype = ctypes.c_int
    lib.sypha_exact_cover.argtypes = [
        u64p, ctypes.c_int64, f64p, u8p, ctypes.c_int64,
        i64p, i32p, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, f64p, u8p,
    ]
    if hasattr(lib, "sypha_exact_cover_cuts"):
        lib.sypha_exact_cover_cuts.restype = ctypes.c_int
        lib.sypha_exact_cover_cuts.argtypes = [
            u64p, ctypes.c_int64, f64p, u8p, ctypes.c_int64,
            i64p, i32p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double, f64p, u8p,
            f64p, f64p, f64p, ctypes.c_int64,
        ]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it on first use; None if unavailable.
    Disable with SYPHA_NO_NATIVE=1."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("SYPHA_NO_NATIVE"):
            return None
        try:
            path = library_path()
            if not os.path.exists(path):
                build(path)
            _lib = _bind(ctypes.CDLL(path))
        except (OSError, subprocess.SubprocessError):
            _lib = None
        return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# high-level wrappers (None return = use the Python fallback)
# ---------------------------------------------------------------------------


def read_scp_file_native(path: str):
    """(costs, row_ptr, row_idx, nrows, ncols) or None."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.sypha_scp_open(path.encode())
    if not h:
        return None
    try:
        nrows = ctypes.c_int()
        ncols = ctypes.c_int()
        nnz = ctypes.c_int64()
        lib.sypha_scp_dims(h, ctypes.byref(nrows), ctypes.byref(ncols), ctypes.byref(nnz))
        costs = np.empty(ncols.value, dtype=np.float64)
        row_ptr = np.empty(nrows.value + 1, dtype=np.int64)
        row_idx = np.empty(max(nnz.value, 1), dtype=np.int32)
        lib.sypha_scp_fill(h, costs, row_ptr, row_idx)
        return costs, row_ptr, row_idx[: nnz.value], nrows.value, ncols.value
    finally:
        lib.sypha_scp_close(h)


class _ModelArrays:
    """Flat-array view of a BaseModel for the native rules (cached per model
    until its cut set changes — the rules only touch covering rows)."""

    def __init__(self, model):
        self.masks = np.ascontiguousarray(model.col_masks)
        self.nwords = model._nwords
        self.costs = np.ascontiguousarray(model.costs)
        nrows = model.nrows_cover
        ncols = model.ncols
        self.nrows = nrows
        self.ncols = ncols
        self.row_ptr = np.zeros(nrows + 1, dtype=np.int64)
        for i, cols in enumerate(model.cols_by_row):
            self.row_ptr[i + 1] = self.row_ptr[i] + len(cols)
        self.row_idx = (
            np.concatenate(model.cols_by_row).astype(np.int32)
            if nrows
            else np.zeros(0, np.int32)
        )
        self.col_ptr = np.zeros(ncols + 1, dtype=np.int64)
        for j, rows in enumerate(model.rows_by_col):
            self.col_ptr[j + 1] = self.col_ptr[j] + len(rows)
        self.col_idx = (
            np.concatenate(model.rows_by_col).astype(np.int32)
            if ncols
            else np.zeros(0, np.int32)
        )


def _arrays(model) -> _ModelArrays:
    cache = getattr(model, "_native_arrays", None)
    if cache is None:
        cache = _ModelArrays(model)
        model._native_arrays = cache
    return cache


def _run_rule(model, fn_name: str, tol: float, deadline_sec: float) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    ar = _arrays(model)
    active = model.active.astype(np.uint8)
    fn = getattr(lib, fn_name)
    if fn_name == "sypha_single_column_dominance":
        removed = fn(ar.masks, ar.nwords, ar.costs, active, ar.ncols,
                     tol, deadline_sec)
    else:
        removed = fn(ar.masks, ar.nwords, ar.costs, active, ar.ncols,
                     ar.row_ptr, ar.row_idx, ar.nrows, ar.col_ptr, ar.col_idx,
                     tol, deadline_sec)
    model.active[:] = active.astype(bool)
    return int(removed)


def single_column_dominance(model, tol, deadline_sec) -> Optional[int]:
    return _run_rule(model, "sypha_single_column_dominance", tol, deadline_sec)


def two_column_dominance(model, tol, deadline_sec) -> Optional[int]:
    return _run_rule(model, "sypha_two_column_dominance", tol, deadline_sec)


def cost_driven_replacement(model, tol, deadline_sec) -> Optional[int]:
    return _run_rule(model, "sypha_cost_driven_replacement", tol, deadline_sec)


def budget_pruning(model, incumbent, tol, deadline_sec) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    ar = _arrays(model)
    active = model.active.astype(np.uint8)
    removed = lib.sypha_budget_pruning(
        ar.masks, ar.nwords, ar.costs, active, ar.ncols,
        ar.row_ptr, ar.row_idx, ar.nrows,
        float(incumbent), tol, deadline_sec,
    )
    model.active[:] = active.astype(bool)
    return int(removed)


def greedy_set_cover(model):
    """(objective, selected) or None."""
    lib = get_lib()
    if lib is None:
        return None
    ar = _arrays(model)
    active = model.active.astype(np.uint8)
    selected = np.zeros(ar.ncols, dtype=np.int32)
    obj = ctypes.c_double()
    nsel = lib.sypha_greedy_set_cover(
        ar.col_ptr, ar.col_idx, ar.costs, active,
        ar.nrows, ar.ncols, selected, ctypes.byref(obj),
    )
    if nsel < 0:
        return (np.inf, np.zeros(0, dtype=np.int64))
    return (float(obj.value), selected[:nsel].astype(np.int64))


def exact_cover(model, budget: float, deadline_sec: float, duals=None,
                cuts=None):
    """Native implicit enumeration (sypha_exact_cover): find a cover with
    cost <= budget among active columns or prove none exists.  ``duals``
    (optional, per covering row) arms the LP-dual Lagrangian bound — any
    y >= 0 is admissible; near-optimal LP duals make plateau faces
    refutable at hundreds of columns.  ``cuts`` (optional, requires duals)
    = (w[nc], coef[nc, ncols], rhs[nc]) arms the static cut-row Lagrangian
    term: the cut-strengthened LP bound exceeds the plain LP bound the
    covering-row ascent is capped by.

    Returns (True, x) / (False, None) / None when the library is absent or
    the deadline fired (caller falls back / treats as inconclusive)."""
    lib = get_lib()
    if lib is None:
        return None
    ar = _arrays(model)
    active = np.ascontiguousarray(model.active.astype(np.uint8))
    out = np.zeros(model.ncols, dtype=np.uint8)
    if duals is None:
        y = np.zeros(ar.nrows, dtype=np.float64)
    else:
        y = np.ascontiguousarray(
            np.nan_to_num(np.asarray(duals, dtype=np.float64)[: ar.nrows],
                          nan=0.0, posinf=0.0, neginf=0.0)
        )
        if len(y) < ar.nrows:
            y = np.concatenate([y, np.zeros(ar.nrows - len(y))])
    dump_dir = os.environ.get("SYPHA_DUMP_FACES")
    if dump_dir:
        # offline-tuning hook: persist the exact native-call inputs so the
        # DFS engine can be benchmarked/iterated on without re-running the
        # whole MILP search that produced this face
        os.makedirs(dump_dir, exist_ok=True)
        tag = f"face_{int(time.monotonic_ns())}"
        extra = {}
        if cuts is not None:
            extra = dict(
                cut_w=np.asarray(cuts[0], dtype=np.float64),
                cut_coef=np.asarray(cuts[1], dtype=np.float64),
                cut_rhs=np.asarray(cuts[2], dtype=np.float64),
            )
        np.savez_compressed(
            os.path.join(dump_dir, tag),
            masks=ar.masks, costs=ar.costs, active=active,
            col_ptr=ar.col_ptr, col_idx=ar.col_idx,
            nrows=np.int64(ar.nrows), nwords=np.int64(ar.nwords),
            budget=np.float64(budget), deadline=np.float64(deadline_sec),
            duals=y, **extra,
        )
    if cuts is not None and hasattr(lib, "sypha_exact_cover_cuts"):
        cut_w, cut_coef, cut_rhs = cuts
        cut_w = np.ascontiguousarray(
            np.nan_to_num(np.asarray(cut_w, dtype=np.float64),
                          nan=0.0, posinf=0.0, neginf=0.0)
        )
        cut_coef = np.ascontiguousarray(
            np.asarray(cut_coef, dtype=np.float64)
        )
        cut_rhs = np.ascontiguousarray(np.asarray(cut_rhs, dtype=np.float64))
        nc = int(len(cut_w))
        assert cut_coef.shape == (nc, model.ncols), cut_coef.shape
        rc = lib.sypha_exact_cover_cuts(
            ar.masks, ctypes.c_int64(ar.nwords), ar.costs, active,
            ctypes.c_int64(ar.ncols), ar.col_ptr, ar.col_idx,
            ctypes.c_int64(ar.nrows),
            float(budget), float(deadline_sec), y, out,
            cut_w, cut_coef, cut_rhs, ctypes.c_int64(nc),
        )
    else:
        rc = lib.sypha_exact_cover(
            ar.masks, ctypes.c_int64(ar.nwords), ar.costs, active,
            ctypes.c_int64(ar.ncols), ar.col_ptr, ar.col_idx,
            ctypes.c_int64(ar.nrows),
            float(budget), float(deadline_sec), y, out,
        )
    if rc == 1:
        return True, out.astype(np.float64)
    if rc == 0:
        return False, None
    return (None, None)  # ran but inconclusive (deadline)


if __name__ == "__main__":
    # `python -m sypha.native` builds the library (what `make` runs) and
    # prints its path
    print(build() if "--build" in sys.argv else library_path())
