"""Native C++ host runtime (csrc/sypha_host.cpp) vs the numpy fallbacks:
identical results on real instances."""

import os

import numpy as np
import pytest

from sypha import native
from sypha.core.problem import ScpModel
from sypha.milp.base_model import BaseModel
from sypha.milp import presolve


@pytest.fixture(scope="module")
def lib_available():
    if not native.available():
        pytest.skip("native library unavailable (g++ missing?)")


def _fresh_models(data_dir, name="scp41"):
    from sypha.io.scp_reader import read_scp_file

    m = read_scp_file(str(data_dir / f"{name}.txt"))
    return BaseModel(m), BaseModel(m)


def _python_only():
    """Context manager: force the numpy fallbacks."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        old = native._lib, native._tried
        native._lib, native._tried = None, True
        try:
            yield
        finally:
            native._lib, native._tried = old

    return ctx()


def test_native_reader_matches_python(lib_available, data_dir):
    from sypha.io.scp_reader import parse_scp_text, read_scp_file

    path = str(data_dir / "scp41.txt")
    m_native = read_scp_file(path)
    with open(path) as f:
        m_py = parse_scp_text(f.read(), name="scp41")
    assert m_native.nrows == m_py.nrows
    assert m_native.ncols == m_py.ncols
    np.testing.assert_array_equal(m_native.costs, m_py.costs)
    assert len(m_native.rows) == len(m_py.rows)
    for a, b in zip(m_native.rows, m_py.rows):
        np.testing.assert_array_equal(a, b)


def test_native_greedy_matches_python(lib_available, data_dir):
    mn, mp = _fresh_models(data_dir)
    rn = presolve.greedy_set_cover(mn)
    with _python_only():
        rp = presolve.greedy_set_cover(mp)
    assert rn.feasible == rp.feasible
    assert abs(rn.objective - rp.objective) < 1e-9
    np.testing.assert_array_equal(np.sort(rn.selected), np.sort(rp.selected))


@pytest.mark.parametrize(
    "rule",
    ["single_column_dominance", "two_column_dominance", "cost_driven_replacement"],
)
def test_native_rules_match_python(lib_available, data_dir, rule):
    mn, mp = _fresh_models(data_dir)
    fn = getattr(presolve, rule)
    # no deadline: both must scan exhaustively and agree exactly
    rn = fn(mn, 1e-12, presolve._Deadline(None))
    with _python_only():
        rp = fn(mp, 1e-12, presolve._Deadline(None))
    assert rn == rp, (rule, rn, rp)
    np.testing.assert_array_equal(mn.active, mp.active)


def test_native_budget_pruning_matches_python(lib_available, data_dir):
    mn, mp = _fresh_models(data_dir)
    inc = presolve.greedy_set_cover(mn).objective
    rn = presolve.incumbent_budget_pruning(mn, inc, 1e-12, None)
    with _python_only():
        rp = presolve.incumbent_budget_pruning(mp, inc, 1e-12, None)
    assert rn == rp, (rn, rp)
    np.testing.assert_array_equal(mn.active, mp.active)


def test_native_exact_cover_stress_vs_python_oracle(lib_available):
    """Sibling-exclusion branching + probe-budget root filtering in the
    native DFS must not change verdicts: on instances large enough for the
    machinery to engage (the tiny brute-force tests never ban a column),
    native find/refute must agree with the plain Python DFS oracle at the
    exact optimum boundary, with LP duals armed and columns masked."""
    from scipy.optimize import linprog

    from sypha.milp.presolve import exact_small_cover

    rng = np.random.default_rng(77)
    for trial in range(6):
        nrows, ncols = 14, 36
        rows = []
        for i in range(nrows):
            k = int(rng.integers(2, 7))
            rows.append(
                np.sort(rng.choice(ncols, size=k, replace=False)).astype(np.int32)
            )
        m = ScpModel(
            nrows=nrows, ncols=ncols,
            costs=rng.integers(1, 20, ncols).astype(np.float64),
            rows=rows, name=f"s{trial}",
        )
        base = BaseModel(m)
        # mask a random late slice (the closure operates on masked models)
        masked = rng.choice(ncols, size=ncols // 5, replace=False)
        base.active[masked] = False
        A, rhs = base.rel_csr()
        cols = np.flatnonzero(base.active)
        lp = linprog(
            base.costs[cols], A_ub=-A[:, cols].toarray(), b_ub=-rhs,
            bounds=(0, 1), method="highs",
        )
        if lp.status != 0:
            continue  # masked model infeasible: nothing to compare
        y = np.maximum(0.0, -np.asarray(lp.ineqlin.marginals))
        # exact optimum from the Python oracle (trusted: brute-force
        # validated in test_presolve), via descending budget probing
        with _python_only():
            v, x = exact_small_cover(base, 1e9, time_limit_sec=30.0)
        assert v is True
        best = float(base.costs @ (x > 0.5))
        while True:
            with _python_only():
                v, x2 = exact_small_cover(
                    base, best - 1.0 + 1e-9, time_limit_sec=30.0
                )
            if v is not True:
                break
            best = float(base.costs @ (x2 > 0.5))
        assert v is False
        for budget, expect in ((best - 1.0 + 1e-9, False), (best + 1e-9, True)):
            verdict, xs = exact_small_cover(
                base, budget, time_limit_sec=30.0, duals=y
            )
            assert verdict is expect, (trial, budget, best, verdict)
            if expect:
                assert base.is_cover(xs)
                assert float(base.costs @ (xs > 0.5)) <= budget + 1e-6
                assert not np.any(xs[masked] > 0.5)


@pytest.mark.parametrize("change", ["source", "flags", "cpu"])
def test_library_key_changes_with_inputs(change):
    """The build's file name is keyed by the source digest, the compiler
    flags and the host CPU model, so a library built from another source,
    with other flags or on another machine is never loaded."""
    src, flags, cpu = b"int f() { return 1; }", ("g++", "-O3"), "cpu A"
    key = native.library_key(src, flags, cpu)
    assert key == native.library_key(src, flags, cpu)
    other = {
        "source": (src + b"\n", flags, cpu),
        "flags": (src, ("g++", "-O2"), cpu),
        "cpu": (src, flags, "cpu B"),
    }[change]
    assert native.library_key(*other) != key


def test_library_path_is_keyed_by_current_source(monkeypatch):
    monkeypatch.delenv("SYPHA_NATIVE_LIB", raising=False)
    with open(native._SRC, "rb") as f:
        key = native.library_key(f.read())
    path = native.library_path()
    assert os.path.basename(path) == f"libsypha_host-{key}.so"
    assert os.path.dirname(path) == os.path.dirname(native.__file__)
