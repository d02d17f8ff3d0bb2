"""Presolve rules vs brute-force oracles."""

import itertools

import numpy as np
import pytest

from sypha import parse_scp_text, read_scp_file
from sypha.milp.base_model import BaseModel
from sypha.milp.presolve import (
    _Deadline,
    apply_presolve_rules,
    greedy_set_cover,
    incumbent_budget_pruning,
    single_column_dominance,
)


def brute_force_scp(model: BaseModel):
    """Exact optimum by enumeration (tiny instances only)."""
    n = model.ncols
    best = np.inf
    for bits in itertools.product([0, 1], repeat=n):
        x = np.asarray(bits, dtype=np.float64)
        if model.is_cover(x):
            best = min(best, model.costs @ x)
    return best


TINY = """3 4
2 3 4 5
2 1 2
2 2 3
3 1 3 4
"""


def test_greedy_cover_tiny():
    base = BaseModel(parse_scp_text(TINY))
    g = greedy_set_cover(base)
    assert g.feasible
    x = np.zeros(base.ncols)
    x[g.selected] = 1.0
    assert base.is_cover(x)
    assert abs(g.objective - base.costs @ x) < 1e-12


def test_greedy_cover_beasley(data_dir):
    base = BaseModel(read_scp_file(str(data_dir / "scp41.txt")))
    g = greedy_set_cover(base)
    assert g.feasible
    x = np.zeros(base.ncols)
    x[g.selected] = 1.0
    assert base.is_cover(x)
    # reference-quality greedy should land within ~2x of the LP bound (429)
    assert g.objective < 2 * 429


def test_single_dominance_removes_dominated():
    # col 0 covers {0,1} at cost 2; col 1 covers {0} at cost 3 -> dominated
    text = "2 3\n2 3 1\n2 1 2\n1 1\n"
    base = BaseModel(parse_scp_text(text))
    removed = single_column_dominance(base, 1e-12, _Deadline(None))
    assert removed >= 1
    assert not base.active[1]
    assert base.active[0]


def test_dominance_preserves_optimum():
    rng = np.random.default_rng(7)
    for trial in range(5):
        nrows, ncols = 6, 10
        rows = []
        for i in range(nrows):
            k = rng.integers(2, 5)
            rows.append(np.sort(rng.choice(ncols, size=k, replace=False)).astype(np.int32))
        from sypha.core.problem import ScpModel

        m = ScpModel(
            nrows=nrows,
            ncols=ncols,
            costs=rng.integers(1, 10, ncols).astype(np.float64),
            rows=rows,
        )
        base = BaseModel(m)
        before = brute_force_scp(base)
        apply_presolve_rules(base, "single,two,cost_driven", 1e-12, None)
        # optimum restricted to active columns must be unchanged
        best_after = np.inf
        act = np.flatnonzero(base.active)
        for r in range(len(act) + 1):
            for sel in itertools.combinations(act, r):
                x = np.zeros(ncols)
                x[list(sel)] = 1.0
                if base.is_cover(x):
                    best_after = min(best_after, base.costs @ x)
        assert best_after == before, f"trial {trial}"


def test_budget_pruning_preserves_better_solutions():
    rng = np.random.default_rng(11)
    nrows, ncols = 5, 8
    rows = []
    for i in range(nrows):
        k = rng.integers(2, 4)
        rows.append(np.sort(rng.choice(ncols, size=k, replace=False)).astype(np.int32))
    from sypha.core.problem import ScpModel

    m = ScpModel(
        nrows=nrows,
        ncols=ncols,
        costs=rng.integers(1, 8, ncols).astype(np.float64),
        rows=rows,
    )
    base = BaseModel(m)
    opt = brute_force_scp(base)
    if not np.isfinite(opt):
        pytest.skip("random instance infeasible")
    incumbent = opt + 2.0  # a weak incumbent
    incumbent_budget_pruning(base, incumbent)
    # the true optimum must still be reachable with active columns
    best_after = np.inf
    act = np.flatnonzero(base.active)
    for r in range(len(act) + 1):
        for sel in itertools.combinations(act, r):
            x = np.zeros(ncols)
            x[list(sel)] = 1.0
            if base.is_cover(x):
                best_after = min(best_after, base.costs @ x)
    assert best_after == opt


def test_presolve_none_is_noop():
    base = BaseModel(parse_scp_text(TINY))
    assert apply_presolve_rules(base, "none") == 0
    assert base.n_active == 4


def test_exact_small_cover_vs_bruteforce():
    """Implicit enumeration must agree with brute force on find/refute for
    many budgets and random instances."""
    import itertools
    import numpy as np

    from sypha.core.problem import ScpModel
    from sypha.milp.base_model import BaseModel
    from sypha.milp.presolve import exact_small_cover

    rng = np.random.default_rng(9)
    for trial in range(10):
        nrows, ncols = 7, 12
        rows = []
        for i in range(nrows):
            k = int(rng.integers(2, 5))
            rows.append(np.sort(rng.choice(ncols, size=k, replace=False)).astype(np.int32))
        m = ScpModel(nrows=nrows, ncols=ncols,
                     costs=rng.integers(1, 9, ncols).astype(np.float64),
                     rows=rows, name=f"r{trial}")
        base = BaseModel(m)
        # brute-force best cover cost
        best = np.inf
        for bits in itertools.product([0, 1], repeat=ncols):
            xx = np.asarray(bits, dtype=np.float64)
            if base.is_cover(xx):
                best = min(best, float(base.costs @ xx))
        for budget in (best - 1, best, best + 3):
            for use_native in (True, False):
                if not use_native:
                    # exercise the Python fallback DFS as well
                    import sypha.native as native
                    orig = native.exact_cover
                    native.exact_cover = lambda *a, **k: None
                try:
                    verdict, x = exact_small_cover(base, budget)
                finally:
                    if not use_native:
                        native.exact_cover = orig
                if budget < best:
                    assert verdict is False, (trial, budget, best, use_native)
                else:
                    assert verdict is True, (trial, budget, best, use_native)
                    assert base.is_cover(x)
                    assert base.costs @ (x > 0.5) <= budget + 1e-9
        # with half the columns masked the verdict must respect the mask
        base.active[: ncols // 2] = False
        verdict, x = exact_small_cover(base, best + 5)
        if verdict is True:
            assert not np.any(x[: ncols // 2] > 0.5)


def test_exact_small_cover_dual_bound_admissible():
    """The LP-dual (Lagrangian) bound must never change a verdict: for
    LP-optimal duals, random y >= 0, garbage (negative / NaN / inf) duals,
    and wrong-length vectors, find/refute must still agree with brute
    force on both the native engine and the Python fallback."""
    import itertools
    import numpy as np
    from scipy.optimize import linprog

    from sypha.core.problem import ScpModel
    from sypha.milp.base_model import BaseModel
    from sypha.milp.presolve import exact_small_cover

    rng = np.random.default_rng(31)
    for trial in range(6):
        nrows, ncols = 7, 12
        rows = []
        for i in range(nrows):
            k = int(rng.integers(2, 5))
            rows.append(
                np.sort(rng.choice(ncols, size=k, replace=False)).astype(np.int32)
            )
        m = ScpModel(nrows=nrows, ncols=ncols,
                     costs=rng.integers(1, 9, ncols).astype(np.float64),
                     rows=rows, name=f"d{trial}")
        base = BaseModel(m)
        best = np.inf
        for bits in itertools.product([0, 1], repeat=ncols):
            xx = np.asarray(bits, dtype=np.float64)
            if base.is_cover(xx):
                best = min(best, float(base.costs @ xx))
        A, rhs = base.rel_csr()
        lp = linprog(base.costs, A_ub=-A.toarray(), b_ub=-rhs,
                     bounds=(0, 1), method="highs")
        y_lp = np.abs(np.asarray(lp.ineqlin.marginals))
        garbage = np.array(
            [np.nan, np.inf, -np.inf, -3.0, 1e305, 0.0, 2.5][:nrows]
        )
        dual_cases = [y_lp, rng.uniform(0, 4, nrows), garbage, y_lp[:3]]
        for duals in dual_cases:
            for budget in (best - 1, best, best + 3):
                for use_native in (True, False):
                    if not use_native:
                        import sypha.native as native
                        orig = native.exact_cover
                        native.exact_cover = lambda *a, **k: None
                    try:
                        verdict, x = exact_small_cover(base, budget, duals=duals)
                    finally:
                        if not use_native:
                            native.exact_cover = orig
                    if budget < best:
                        assert verdict is False, (trial, budget, best, use_native)
                    else:
                        assert verdict is True, (trial, budget, best, use_native)
                        assert base.is_cover(x)
                        assert base.costs @ (x > 0.5) <= budget + 1e-9


def test_sample_cover_finds_budgeted_cover():
    """The LP-guided sampler must find an optimal-cost cover given the
    LP solution of a small instance, and respect the budget."""
    import numpy as np
    from scipy.optimize import linprog

    from sypha import parse_scp_text
    from sypha.milp.base_model import BaseModel
    from sypha.milp.presolve import sample_cover

    TINY = "3 4\n2 3 4 5\n2 1 2\n2 2 3\n3 1 3 4\n"
    base = BaseModel(parse_scp_text(TINY))
    A, rhs = base.rel_csr()
    res = linprog(base.costs, A_ub=-A.toarray(), b_ub=-rhs, bounds=(0, 1), method="highs")
    # known optimum is 5 (cols 0+2: costs 2+3)
    found = sample_cover(base, res.x, budget=5.0)
    assert found is not None
    assert base.is_cover(found)
    assert base.costs @ (found > 0.5) <= 5.0
    # impossible budget must fail
    assert sample_cover(base, res.x, budget=3.0, tries=50) is None


def test_exact_cover_with_cut_lagrangian():
    """The cut-armed native engine must agree with the plain verdicts:
    a valid CG cut only strengthens bounds, never changes which covers
    exist at a budget."""
    import numpy as np

    from sypha.io.scp_reader import parse_scp_text
    from sypha.milp.base_model import BaseModel
    from sypha.milp.presolve import exact_small_cover
    from sypha import native

    if native.get_lib() is None or not hasattr(
        native.get_lib(), "sypha_exact_cover_cuts"
    ):
        import pytest

        pytest.skip("native cut engine unavailable")

    tiny = """3 4
2 3 4 5
2 1 2
2 2 3
3 1 3 4
"""
    base = BaseModel(parse_scp_text(tiny))
    # optimum {0, 1} costs 5; no single column covers all rows, so
    # sum_j x_j >= 2 is a valid cut.  Arm it with dual weight 1.
    cuts = (
        np.array([1.0]),
        np.ones((1, base.ncols)),
        np.array([2.0]),
    )
    duals = np.ones(base.nrows_cover)
    v, x = exact_small_cover(base, 4.0 + 1e-6, 5.0, duals=duals, cuts=cuts)
    assert v is False  # no cover of cost <= 4
    v, x = exact_small_cover(base, 5.0 + 1e-6, 5.0, duals=duals, cuts=cuts)
    assert v is True
    assert float(base.costs @ (x > 0.5)) == 5.0
