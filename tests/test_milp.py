"""MILP pipeline: heuristics, cuts, and end-to-end B&B vs scipy HiGHS."""

import numpy as np
import pytest
import scipy.optimize
import scipy.sparse

from sypha import parse_scp_text, read_scp_file
from sypha.config import SolverConfig
from sypha.core.status import MilpStatus
from sypha.milp import branch_and_bound
from sypha.milp.base_model import BaseModel, BranchNode
from sypha.milp.cuts import separate_cuts
from sypha.milp.heuristics import (
    dual_guided_cover_repair,
    nearest_integer_fixing,
    select_branch_variable,
)


TINY = """3 4
2 3 4 5
2 1 2
2 2 3
3 1 3 4
"""


def scipy_milp_optimum(model):
    A = model.dense_matrix()
    res = scipy.optimize.milp(
        c=model.costs,
        constraints=scipy.optimize.LinearConstraint(A, lb=1.0),
        integrality=np.ones(model.ncols),
        bounds=scipy.optimize.Bounds(0, 1),
    )
    assert res.status == 0, res.message
    return res.fun


def test_nearest_integer_fixing_accepts_valid_rounding():
    base = BaseModel(parse_scp_text(TINY))
    # LP-like point that rounds to a valid cover {0, 2}: covers {0,1},{1,2},{0,2,3}? col2 covers rows 1,2; col0 covers 0,1 -> row 2 covered by col2? rows are 0-indexed: col 2 in rows[1] and rows[2]. cover ok.
    x = np.array([0.9, 0.1, 0.8, 0.4])
    h = nearest_integer_fixing(base, x, np.zeros(3))
    assert h.feasible
    assert h.objective == base.costs @ np.array([1, 0, 1, 0])


def test_nearest_integer_fixing_respects_decisions():
    base = BaseModel(parse_scp_text(TINY))
    node = BranchNode().child(0, 0)  # fix col0 = 0
    x = np.array([0.9, 0.1, 0.8, 0.4])
    h = nearest_integer_fixing(base, x, np.zeros(3), node)
    # col0 forced off -> {2} doesn't cover row 0 -> infeasible rounding
    assert not h.feasible


def test_dual_guided_repair_builds_cover():
    base = BaseModel(parse_scp_text(TINY))
    x = np.array([0.5, 0.5, 0.5, 0.5])
    dual = np.array([0.5, 0.3, 0.2])
    h = dual_guided_cover_repair(base, x, dual)
    assert h.feasible
    assert base.is_cover(h.solution)
    # redundancy removal should keep it minimal-ish
    assert h.objective <= base.costs.sum()


def test_branch_selector():
    x = np.array([0.5, 0.9, 0.2])
    costs = np.array([1.0, 10.0, 5.0])
    cands = np.array([0, 1, 2])
    assert select_branch_variable("most_fractional", x, costs, cands) == 0
    assert select_branch_variable("highest_cost_fractional", x, costs, cands) == 1


def test_cut_separation_valid_for_integer_covers():
    base = BaseModel(parse_scp_text(TINY))
    # fractional LP-ish point + plausible duals
    x = np.array([0.5, 0.5, 0.5, 0.5])
    dual = np.array([0.7, 0.6, 0.4])
    cuts = separate_cuts(base, x, dual, tol=1e-6)
    # any returned cut must hold for every integer cover (validity)
    import itertools

    for cut in cuts:
        for bits in itertools.product([0, 1], repeat=base.ncols):
            xx = np.asarray(bits, dtype=np.float64)
            if base.is_cover(xx):
                lhs = cut.values @ xx[cut.indices]
                assert lhs + 1e-9 >= cut.rhs, (cut.kind, bits)


def test_cut_separation_valid_under_noisy_duals():
    """Regression for the scp44 unsoundness: IPM duals sitting a few 1e-7
    ABOVE integers made ceil(agg - tol) round coefficients DOWN, producing
    cuts violated by optimal covers.  Hammer the separators with many
    noisy near-integer dual vectors and brute-force-check validity."""
    import itertools

    rng = np.random.RandomState(11)
    base = BaseModel(parse_scp_text(TINY))
    covers = [
        np.asarray(bits, dtype=np.float64)
        for bits in itertools.product([0, 1], repeat=base.ncols)
        if base.is_cover(np.asarray(bits, dtype=np.float64))
    ]
    for trial in range(200):
        dual = rng.randint(0, 8, size=base.nrows_cover).astype(np.float64)
        dual += rng.uniform(-5e-7, 5e-7, size=base.nrows_cover)  # IPM fuzz
        if trial % 3 == 0:
            dual += rng.uniform(0, 1, size=base.nrows_cover)  # fractional too
        x = rng.uniform(0, 1, size=base.ncols)
        for cut in separate_cuts(base, x, np.maximum(dual, 0.0), tol=1e-6):
            for xx in covers:
                lhs = cut.values @ xx[cut.indices]
                assert lhs + 1e-9 >= cut.rhs, (cut.kind, dual, xx)


def test_bnb_tiny_optimal():
    m = parse_scp_text(TINY, name="tiny")
    expected = scipy_milp_optimum(m)
    cfg = SolverConfig(verbosity=0)
    r = branch_and_bound(m, cfg)
    assert r.status == MilpStatus.OPTIMAL
    assert abs(r.objective - expected) < 1e-9
    # solution is a valid cover
    base = BaseModel(m)
    assert base.is_cover(r.solution)
    assert abs(base.objective_of(r.solution) - expected) < 1e-9


@pytest.mark.parametrize("name", ["scp_demo_tiny00", "scp_demo_tiny03", "scp_demo_tiny05"])
def test_bnb_demo_instances(data_dir, name):
    m = read_scp_file(str(data_dir / f"{name}.txt"))
    expected = scipy_milp_optimum(m)
    cfg = SolverConfig(verbosity=0)
    r = branch_and_bound(m, cfg)
    assert r.status == MilpStatus.OPTIMAL, r
    assert abs(r.objective - expected) < 1e-9, (r.objective, expected)
    base = BaseModel(m)
    assert base.is_cover(r.solution)


def test_bnb_random_instances_vs_scipy():
    from sypha.core.problem import ScpModel

    rng = np.random.default_rng(5)
    for trial in range(3):
        nrows, ncols = 8, 16
        rows = []
        for i in range(nrows):
            k = rng.integers(2, 5)
            rows.append(np.sort(rng.choice(ncols, size=k, replace=False)).astype(np.int32))
        m = ScpModel(
            nrows=nrows,
            ncols=ncols,
            costs=rng.integers(1, 12, ncols).astype(np.float64),
            rows=rows,
            name=f"rand{trial}",
        )
        expected = scipy_milp_optimum(m)
        r = branch_and_bound(m, SolverConfig(verbosity=0))
        assert r.status == MilpStatus.OPTIMAL, (trial, r)
        assert abs(r.objective - expected) < 1e-9, (trial, r.objective, expected)


def test_zero_half_mod2_closes_odd_cycles():
    """The mod-2 zerohalf separator must find the full odd-cycle cut
    sum(x) >= ceil(L/2) on an odd L-cycle — a set the pair/triple
    enumerators cannot reach for L >= 5 — and the cut must be valid for
    every integer cover."""
    import itertools

    from sypha.milp.cuts import zero_half_mod2

    for L in (5, 7, 9):
        lines = [f"{L} {L}", " ".join(["1"] * L)]
        for i in range(L):
            cols = sorted([i, (i - 1) % L])
            lines.append("2")
            lines.append(" ".join(str(c + 1) for c in cols))
        m = parse_scp_text("\n".join(lines) + "\n", name=f"odd{L}")
        base = BaseModel(m)
        x = np.full(L, 0.5)  # the LP optimum of the odd cycle
        dual = np.full(L, 0.5)
        cuts = zero_half_mod2(base, x, dual, 1e-6)
        assert cuts, f"no zerohalf cut on the odd {L}-cycle"
        full = [c for c in cuts if len(c.indices) == L and c.rhs == (L + 1) // 2]
        assert full, f"odd-{L} cycle cut missing: {[(c.indices, c.rhs) for c in cuts]}"
        for cut in cuts:
            for bits in itertools.product([0, 1], repeat=L):
                xx = np.asarray(bits, dtype=np.float64)
                if base.is_cover(xx):
                    lhs = cut.values @ xx[cut.indices]
                    assert lhs + 1e-9 >= cut.rhs, (L, bits)


def test_mod_k_cuts_close_circulant_triples():
    """Mod-3 CG must cut the 1/3-fractional circulant: 7 rows, col j covers
    rows {j, j+1, j+2} mod 7.  LP optimum is x*=1/3 (obj 7/3); weight-1/3
    aggregation of ALL rows gives sum(x) >= ceil(7/3) = 3 — a cut no
    {0,1/2} weighting can produce from this point (every column would
    need odd parity and the x* mass of any 3+ columns exceeds the mod-2
    deficit budget)."""
    import itertools

    from sypha.milp.cuts import mod_k_cuts

    L = 7
    lines = [f"{L} {L}", " ".join(["1"] * L)]
    for i in range(L):
        cols = sorted({i, (i - 1) % L, (i - 2) % L})
        lines.append(str(len(cols)))
        lines.append(" ".join(str(c + 1) for c in cols))
    m = parse_scp_text("\n".join(lines) + "\n", name="circ7x3")
    base = BaseModel(m)
    x = np.full(L, 1.0 / 3.0)
    dual = np.full(L, 1.0 / 3.0)
    cuts = mod_k_cuts(base, x, dual, 1e-6, k=3)
    assert cuts, "no mod-3 cut on the 3-circulant"
    assert any(
        len(c.indices) == L and c.rhs == 3.0 and np.all(c.values == 1.0)
        for c in cuts
    ), [(c.indices, c.values, c.rhs) for c in cuts]
    for cut in cuts:
        for bits in itertools.product([0, 1], repeat=L):
            xx = np.asarray(bits, dtype=np.float64)
            if base.is_cover(xx):
                lhs = cut.values @ xx[cut.indices]
                assert lhs + 1e-9 >= cut.rhs, bits


def test_objective_cover_cuts_valid_for_improving_covers():
    """Objective-budget cover cuts must hold for every cover STRICTLY
    better than the incumbent (they are conditional cuts, like the
    incumbent-driven reductions)."""
    import itertools
    from sypha.milp.cuts import objective_cover_cuts

    rng = np.random.RandomState(5)
    base = BaseModel(parse_scp_text(TINY))
    for U in (5.0, 7.0, 9.0, 12.0):
        for _ in range(50):
            x = rng.uniform(0, 1, size=base.ncols)
            for cut in objective_cover_cuts(base, x, U, 1e-6):
                assert cut.rhs <= 0 and np.all(cut.values == -1.0)
                for bits in itertools.product([0, 1], repeat=base.ncols):
                    xx = np.asarray(bits, dtype=np.float64)
                    if base.is_cover(xx) and base.costs @ xx <= U - 1 + 1e-9:
                        lhs = cut.values @ xx[cut.indices]
                        assert lhs + 1e-9 >= cut.rhs, (U, bits, cut.indices)


def test_local_search_improves_padded_cover():
    """Local search must strictly improve an incumbent that wastes cost and
    must never break feasibility."""
    from sypha.milp.heuristics import local_search_improve

    base = BaseModel(parse_scp_text(TINY))
    # deliberately wasteful cover: all four columns (cost 14)
    x0 = np.ones(base.ncols)
    x, obj = local_search_improve(base, x0)
    assert base.is_cover(x)
    assert obj < base.costs.sum() - 1e-9
    assert abs(obj - base.costs @ (x > 0.5)) < 1e-9
    # already-optimal cover stays put
    expected = scipy_milp_optimum(parse_scp_text(TINY))
    x2, obj2 = local_search_improve(base, x)
    assert base.is_cover(x2) and obj2 <= obj + 1e-9
    assert obj2 >= expected - 1e-9  # never "improves" past the optimum


def test_solve_nodes_deadline_bounds_wall_time(data_dir):
    """A nearly-expired deadline must stop a window solve after ~one
    chunk, with surviving lanes reporting MAX_ITER (hard limits are hard;
    VERDICT r1 item 2)."""
    import time
    from sypha.core.status import IpmStatus
    from sypha.milp.bnb import _NodeLpSolver
    from sypha.utils.logging import Logger

    m = read_scp_file(str(data_dir / "scp41.txt"))
    base = BaseModel(m)
    cfg = SolverConfig(verbosity=0)
    solver = _NodeLpSolver(base, cfg, Logger(verbosity=0))
    opts = cfg.ipm.replace(newton_max_steps=48)
    # warm up the executables so compile time does not blur the check
    solver.solve_nodes([BranchNode()], opts, time.monotonic() + 3600)
    t0 = time.monotonic()
    res = solver.solve_nodes([BranchNode()], opts, time.monotonic() + 1e-3)[0]
    dt = time.monotonic() - t0
    # at most ~one wall-clock-target-sized dispatch past the deadline
    assert res["status"] in (IpmStatus.MAX_ITER, IpmStatus.CONVERGED)
    assert dt < 3 * cfg.bnb.iter_chunk_target_sec + 2.0, dt


def test_lagrangian_greedy_builds_cover():
    from sypha.milp.heuristics import lagrangian_greedy_covers

    base = BaseModel(parse_scp_text(TINY))
    # LP duals for TINY's relaxation (approximate values are fine — the
    # heuristic only uses them as greedy weights)
    dual = np.array([1.0, 1.0, 2.0])
    h = lagrangian_greedy_covers(base, dual, max_samples=12)
    assert h.feasible
    assert base.is_cover(h.solution)
    assert h.objective == pytest.approx(base.costs @ h.solution)
    # TINY's integer optimum is 5 ({0,1}); the sampled greedy should find it
    assert h.objective == pytest.approx(5.0)


def test_lagrangian_greedy_respects_fixings_and_best_known():
    from sypha.milp.heuristics import lagrangian_greedy_covers

    base = BaseModel(parse_scp_text(TINY))
    dual = np.array([1.0, 1.0, 2.0])
    node = BranchNode().child(0, 0)  # col0 fixed to 0
    h = lagrangian_greedy_covers(base, dual, node=node, max_samples=12)
    if h.feasible:
        assert h.solution[0] == 0.0
        assert base.is_cover(h.solution)
    # best_known at the optimum (5, cover {0,1}): no strictly-better cover
    h2 = lagrangian_greedy_covers(base, dual, max_samples=12, best_known=5.0)
    assert not h2.feasible


def test_lagrangian_greedy_random_instances():
    from sypha.milp.heuristics import lagrangian_greedy_covers
    from sypha.milp.presolve import greedy_set_cover

    rng = np.random.RandomState(7)
    for _ in range(5):
        m, n = 20, 60
        A = (rng.rand(m, n) < 0.15).astype(float)
        A[np.arange(m), rng.randint(0, n, m)] = 1.0  # every row coverable
        costs = rng.randint(1, 20, n).astype(float)
        lines = [f"{m} {n}", " ".join(str(int(c)) for c in costs)]
        for i in range(m):
            cols = np.flatnonzero(A[i])
            lines.append(f"{len(cols)} " + " ".join(str(j + 1) for j in cols))
        base = BaseModel(parse_scp_text("\n".join(lines)))
        # crude multipliers: uniform
        dual = np.ones(m)
        h = lagrangian_greedy_covers(base, dual, max_samples=18)
        g = greedy_set_cover(base)
        assert h.feasible
        assert base.is_cover(h.solution)
        # sampled Lagrangian greedy should not lose to plain greedy by much
        assert h.objective <= g.objective + 1e-9


def test_core_search_sound_and_global_incumbent():
    """Core (kernel) search: restricted-run incumbents must be globally
    valid covers and never degrade the final objective; OPTIMAL claims of
    the restricted run must not leak (the outer run still proves with its
    own tree)."""
    rng = np.random.RandomState(11)
    m, n = 25, 80
    A = (rng.rand(m, n) < 0.2).astype(float)
    A[np.arange(m), rng.randint(0, n, m)] = 1.0
    costs = rng.randint(1, 30, n).astype(float)
    lines = [f"{m} {n}", " ".join(str(int(c)) for c in costs)]
    for i in range(m):
        cols = np.flatnonzero(A[i])
        lines.append(f"{len(cols)} " + " ".join(str(j + 1) for j in cols))
    model = parse_scp_text("\n".join(lines))
    opt = scipy_milp_optimum(model)

    from sypha.config import BnbOptions

    cfg = SolverConfig(
        verbosity=0,
        bnb=BnbOptions(
            core_min_active=10,  # force the core phase on a tiny instance
            core_mult=3,
            core_time_cap_sec=5.0,
            lagrangian_min_gap=0.0,
            hard_time_limit_sec=60.0,
        ),
    )
    r = branch_and_bound(model, cfg)
    assert r.status == MilpStatus.OPTIMAL
    assert r.objective == pytest.approx(opt)


def test_warm_incumbent_and_restrict_active():
    from sypha.milp.bnb import branch_and_bound as bb

    model = parse_scp_text(TINY)
    # restrict away column 1 (part of the true optimum {0,1}): the
    # restriction narrows the LP/tree, but heuristics may still return any
    # valid cover (masked columns stay cover-feasible), so the result must
    # be a cover no worse than the best within-restriction one ({0,2} = 6)
    mask = np.array([True, False, True, True])
    r = bb(model, SolverConfig(verbosity=0), restrict_active=mask)
    assert r.objective <= 6.0 + 1e-9
    A, rhs = BaseModel(model).rel_csr()
    assert np.all(A @ r.solution + 1e-9 >= rhs)
    # warm incumbent better than anything the restricted model can find
    # must survive (it seeds the incumbent and nothing beats it)
    warm = np.array([1.0, 1.0, 0.0, 0.0])
    r2 = bb(
        model,
        SolverConfig(verbosity=0),
        restrict_active=mask,
        warm_incumbent=(warm, 5.0),
    )
    assert r2.objective == pytest.approx(5.0)


def test_node_lp_bucket_stable_under_cut_growth():
    """Regression: appending cuts WITHIN room_for_cuts() must never grow
    the padded bucket (a grown bucket = a fresh XLA compile mid-solve,
    which once cost scp46 ~100s inside a 120s budget)."""
    from sypha.milp.base_model import Cut
    from sypha.milp.bnb import _NodeLpSolver
    from sypha.utils.logging import Logger

    base = BaseModel(parse_scp_text(TINY))
    solver = _NodeLpSolver(base, SolverConfig(verbosity=0), Logger(verbosity=0))
    solver._rebuild_device_base()
    bucket0 = solver._bucket
    room = solver.room_for_cuts()
    assert room > 0
    cuts = [
        Cut(indices=np.array([0, 1], dtype=np.int32),
            values=np.array([1.0, 1.0]), rhs=1.0)
        for _ in range(room)
    ]
    base.add_cuts(cuts)
    solver.refresh()
    solver._rebuild_device_base()
    assert solver._bucket == bucket0, (solver._bucket, bucket0)
    assert solver.room_for_cuts() == 0


def test_compact_scp_mapping():
    """_compact_scp keeps exactly the kept columns, remaps row lists, and
    solutions of the compact model map back to covers of the original."""
    from sypha.milp.bnb import _compact_scp

    m = parse_scp_text(TINY, name="tiny")
    base = BaseModel(m)
    keep = np.array([True, False, True, True])
    cm, cols = _compact_scp(base, keep, "tiny@c")
    assert cm.ncols == 3 and list(cols) == [0, 2, 3]
    np.testing.assert_allclose(cm.costs, m.costs[[0, 2, 3]])
    # original 0-based rows [0,1],[1,2],[0,2,3]; dropping col 1 and
    # remapping {0->0, 2->1, 3->2} gives [0],[1],[0,1,2]
    assert [list(r) for r in cm.rows] == [[0], [1], [0, 1, 2]]
    # a compact cover maps back to an original cover
    x_c = np.array([1.0, 1.0, 0.0])
    x = np.zeros(m.ncols)
    x[cols[np.flatnonzero(x_c > 0.5)]] = 1.0
    assert base.is_cover(x)


def test_compact_resolve_end_to_end(monkeypatch):
    """When the active set collapses but the exact closure cannot finish,
    the driver rebases to a compact model and the delegated search carries
    a globally valid OPTIMAL proof back."""
    from sypha.core.problem import ScpModel
    from sypha.milp import bnb as bnb_mod
    from sypha.milp import presolve as presolve_mod

    # two disjoint odd 7-cycles (LP = 7, IP = 8) + expensive fillers that
    # reduced-cost fixing masks, shrinking the padded bucket > 2x
    rng = np.random.default_rng(3)
    ncyc, L = 2, 7
    rows = []
    costs = []
    col = 0
    cheap_cols = []
    for c in range(ncyc):
        base_col = col
        for i in range(L):
            rows.append(
                np.sort(
                    np.array(
                        [base_col + i, base_col + (i + 1) % L], dtype=np.int32
                    )
                )
            )
        col += L
        cheap_cols += list(range(base_col, base_col + L))
        costs += [1.0] * L
    n_fill = 600
    nrows = len(rows)
    for j in range(n_fill):
        r = rng.integers(0, nrows)
        rows[r] = np.sort(np.append(rows[r], col)).astype(np.int32)
        costs.append(50.0)
        col += 1
    m = ScpModel(
        nrows=nrows, ncols=col, costs=np.asarray(costs), rows=rows,
        name="cyc2x7",
    )
    expected = scipy_milp_optimum(m)  # 8 = 2 * ceil(7/2) ... per cycle 4
    # force the exact closure to be useless so only the compact re-solve's
    # delegated tree can close the gap; the OUTER run keeps it disabled,
    # the inner (compact) run gets the real engine back
    real = presolve_mod.exact_small_cover
    state = {"depth": 0}
    orig_bnb = bnb_mod.branch_and_bound

    def fake_exact(*a, **k):
        if state["depth"] == 0:
            return None, None
        return real(*a, **k)

    def wrapped_bnb(*a, **k):
        state["depth"] = max(state["depth"], k.get("_compact_depth", 0))
        return orig_bnb(*a, **k)

    monkeypatch.setattr(presolve_mod, "exact_small_cover", fake_exact)
    monkeypatch.setattr(bnb_mod, "branch_and_bound", wrapped_bnb)
    # cuts off: the zerohalf separator closes odd cycles at the root,
    # which would solve this instance before the compact re-solve triggers
    from sypha.config import BnbOptions

    r = orig_bnb(m, SolverConfig(verbosity=0, bnb=BnbOptions(cuts_enabled=False)))
    assert state["depth"] >= 1, "compact re-solve did not trigger"
    assert r.status == MilpStatus.OPTIMAL
    assert abs(r.objective - expected) < 1e-9
    assert BaseModel(m).is_cover(r.solution)


def test_async_closure_worker_self_chains_the_ladder():
    """_AsyncClosure runs the refutation ladder on a background thread and
    SELF-CHAINS the levels (r3b: the main loop used to schedule one probe
    per poll, so a mid-run XLA compile left the worker idle between
    trivially fast refutations).  Started below the optimum, one ladder
    must refute every level below it and then find the optimal cover,
    without any main-thread involvement beyond the result drain."""
    import time

    from sypha.milp.bnb import _AsyncClosure
    from sypha.utils.logging import Logger

    base = BaseModel(parse_scp_text(TINY))
    opt = scipy_milp_optimum(parse_scp_text(TINY))
    w = _AsyncClosure(base, 1e-6, Logger(verbosity=0))

    w.start_ladder(
        probe0=opt - 2.0,
        best_obj=opt + 3.0,  # ceiling above the optimum: the find fires
        seed_fn=lambda: (None, None),
        deadline_mono=time.monotonic() + 30.0,
        last_refute_sec=0.0,
        attempts={},
    )
    results = []
    deadline = time.monotonic() + 30.0
    while w.busy() or not results:
        results.extend(w.poll_all())
        if results and results[-1]["verdict"] is True:
            break
        assert time.monotonic() < deadline, "ladder never finished"
        time.sleep(0.01)
    results.extend(w.poll_all())
    w.join(5.0)

    # every level below the optimum refuted, in order, by ONE ladder
    refuted = [r["level"] for r in results if r["verdict"] is False]
    assert refuted == [opt - 2.0, opt - 1.0], results
    found = [r for r in results if r["verdict"] is True]
    assert len(found) == 1
    assert float(base.costs @ (found[0]["x"] > 0.5)) == opt
    assert not w.busy()


def test_root_time_frac_guard_still_solves():
    """Root-phase budget guard (config.root_time_frac): with tree_by
    already expired (frac ~ 0 under a hard limit), the optional root
    phases (Lagrangian, cut rounds, core search) are clipped but the tree
    still runs and proves optimality — the guard trades root polish for a
    guaranteed tree start, never correctness."""
    m = parse_scp_text(TINY, name="tiny")
    expected = scipy_milp_optimum(m)
    cfg = SolverConfig(verbosity=0)
    cfg = cfg.replace(
        bnb=cfg.bnb.replace(
            hard_time_limit_sec=60.0,
            root_time_frac=1e-9,
            precompile=False,
        )
    )
    r = branch_and_bound(m, cfg)
    assert r.status == MilpStatus.OPTIMAL, r
    assert abs(r.objective - expected) < 1e-9
    base = BaseModel(m)
    assert base.is_cover(r.solution)


def test_warm_duals_arm_the_early_closure_ladder():
    """warm_duals (the compact re-solve inheritance) start the refutation
    ladder before the child's root LP exists: with a proven warm_lower
    floor and LP-quality duals, the ladder alone must prove the warm
    incumbent optimal on a tiny plateau face."""
    m = parse_scp_text(TINY, name="tiny")
    expected = scipy_milp_optimum(m)
    # LP-optimal covering-row duals from scipy (the parent's closure seed)
    import itertools

    A = np.zeros((m.nrows, m.ncols))
    for i, cols in enumerate(m.rows):
        A[i, cols] = 1.0
    lp = scipy.optimize.linprog(
        m.costs, A_ub=-A, b_ub=-np.ones(m.nrows), bounds=(0, 1),
        method="highs",
    )
    duals = -lp.ineqlin.marginals
    x_best = np.zeros(m.ncols)
    # a valid (optimal) incumbent cover, found by brute force
    best = None
    for k in range(1, m.ncols + 1):
        for comb in itertools.combinations(range(m.ncols), k):
            sel = np.zeros(m.ncols)
            sel[list(comb)] = 1.0
            if np.all(A @ sel >= 1.0):
                c = float(m.costs @ sel)
                if best is None or c < best[0]:
                    best = (c, sel)
    x_best = best[1]
    cfg = SolverConfig(verbosity=0)
    r = branch_and_bound(
        m,
        cfg,
        warm_incumbent=(x_best, best[0]),
        warm_lower=float(np.ceil(lp.fun - 1e-9)),
        warm_duals=duals,
    )
    assert r.status == MilpStatus.OPTIMAL, r
    assert abs(r.objective - expected) < 1e-9


def test_std_bucket_rungs():
    """Compact/core children snap padded widths to the standard rung
    ladder (compile sharing across a family sweep)."""
    from sypha.milp.bnb import _STD_RUNGS, _std_bucket_cols

    assert _std_bucket_cols(1) == 128
    assert _std_bucket_cols(128) == 128
    assert _std_bucket_cols(129) == 256
    assert _std_bucket_cols(1012) == 1024  # scpnre compact face
    assert _std_bucket_cols(2084) == 3072
    assert _std_bucket_cols(20000) == 20480  # beyond the ladder: 1024-mult
    assert list(_STD_RUNGS) == sorted(_STD_RUNGS)


def test_bnb_device_error_propagates(monkeypatch):
    """A device fault during the search fails the run: the error reaches
    the caller (the CLI exits non-zero) instead of becoming a result."""
    from sypha.core.problem import ScpModel
    from sypha.milp import bnb as bnb_mod
    from sypha.config import BnbOptions

    # an odd cycle (row i covered by columns i and i+1 mod n) has a
    # fractional LP optimum (x = 1/2 everywhere); the slightly non-integral
    # costs defeat the ceil dual-bound tightening, so the root cannot close
    # and the tree genuinely branches
    n = 9
    rows = [np.array([i, (i + 1) % n], dtype=np.int32) for i in range(n)]
    m = ScpModel(
        nrows=n,
        ncols=n,
        costs=1.0 + 0.01 * np.arange(1, n + 1, dtype=np.float64),
        rows=rows,
        name="deverr",
    )
    real = bnb_mod._NodeLpSolver.solve_nodes
    calls = {"n": 0}

    def failing(self, nodes, *a, **k):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("INTERNAL: CUDA error: an illegal memory access")
        return real(self, nodes, *a, **k)

    monkeypatch.setattr(bnb_mod._NodeLpSolver, "solve_nodes", failing)
    cfg = SolverConfig(
        verbosity=0,
        bnb=BnbOptions(exact_closure=False, cuts_enabled=False, int_heuristics=""),
    )
    with pytest.raises(RuntimeError, match="illegal memory access"):
        branch_and_bound(m, cfg)
    assert calls["n"] >= 2, "fault injection never fired; test is vacuous"
