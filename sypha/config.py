"""Configuration for the solver stack.

Mirrors the reference's three-tier flag system (constexpr defaults in
src/sypha_environment_defaults.h, boost::program_options CLI in
src/sypha_environment.cpp:110-149, and the programmatic SolverParameters in
include/sypha/sypha.h:19-42) as a single frozen dataclass; the CLI and the
modeling API both consume it.

``IpmOptions`` is the *static* (hashable) subset that parameterises jitted
code; it is split out so it can be a jit static argument.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class IpmOptions:
    """Static parameters of the jitted Mehrotra predictor-corrector loop.

    Defaults follow reference src/sypha_environment_defaults.h:14-24 where a
    counterpart exists; tolerances default tighter (1e-8 duality gap) per the
    rebuild's accuracy target.
    """

    # Maximum Mehrotra iterations (reference kMehrotraMaxIter=25; we default
    # higher because we target 1e-8 gaps rather than mu<1e-4).
    max_iter: int = 60
    # Step damping factor eta (reference kMehrotraEta=0.95).  With
    # adaptive_eta, eta_k = max(eta, 1 - mu_k) accelerates the endgame.
    eta: float = 0.95
    adaptive_eta: bool = True
    # Convergence: relative duality gap AND relative primal/dual feasibility.
    tol_gap: float = 1e-8
    tol_feas: float = 1e-8
    # Also stop when the duality measure mu falls below this (reference
    # kMehrotraMuTol=1e-4 is its only criterion; ours is the conjunction of
    # gap/feasibility OR mu below mu_tol_hard).
    mu_tol_hard: float = 1e-12
    # Clip on the scaling matrix D^2 = x/s entries to keep the normal
    # equations finite near convergence.
    d2_min: float = 1e-30
    d2_max: float = 1e30
    # --- Newton-system linear solver strategy (reference --linear-solver,
    # src/sypha_environment.cpp:127; its sparse_qr exists to suit cusolverSp
    # and has no reason to exist in the normal-equations design):
    #   "dense": factor the f32 normal matrix once per iteration (batched
    #            GEMM + block Cholesky) and use it as the PCG preconditioner;
    #   "cg":    matrix-free Jacobi-preconditioned CG (the reference's Krylov
    #            path, src/sypha_solver_krylov.cu) with the per-IPM-iteration
    #            adaptive tolerance schedule (src/sypha_solver.cpp:552-553);
    #            right for very large m where an m x m factor is prohibitive.
    linear_solver: str = "dense"
    # CG path: tol_k = max(cg_tol_final, cg_tol_initial * cg_tol_decay^k)
    # (reference kKrylovCgTol*, src/sypha_environment_defaults.h:21-24).
    cg_max_iter: int = 500
    cg_tol_initial: float = 1e-2
    cg_tol_final: float = 1e-8
    cg_tol_decay: float = 0.5
    # --- factoring (dense strategy): factor the equilibrated normal matrix
    # in this dtype ("float32": the O(m^2 n) Gram and O(m^3) factor run in
    # f32), then recover f64 accuracy with flexible PCG in f64
    # preconditioned by that factor.  Whether a direct f64 factor is faster
    # on the GPU is not measured yet. ---
    factor_dtype: str = "float32"
    # Ridge added to the equilibrated (unit-diagonal) matrix before
    # factoring; None = auto by dtype (2e-6 for f32, 1e-12 for f64).
    factor_ridge: float | None = None
    # Leaf size of the block-recursive Cholesky inverse.
    chol_leaf_size: int = 64
    # PCG stopping: relative residual + step cap.  A fresh f32 factor needs
    # ~2-4 f64 PCG steps; the cap is a backstop, and because the batched PCG
    # while_loop runs until EVERY lane meets tol, a large cap lets one
    # struggling lane stall the whole batch.  16 was tuned on another
    # machine; to be re-measured on the GPU.  Lanes the cap cuts short are
    # handled by the solve-quality gates.
    newton_tol: float = 1e-10
    newton_max_steps: int = 16
    # Centering exponent: sigma = (mu_aff/mu)**sigma_pow (reference uses 3,
    # gsl_pow_3 at src/sypha_solver.cpp:622).
    sigma_pow: int = 3
    # Gondzio multiple centrality correctors: extra Newton solves per
    # iteration reusing the factor, each trading ~1 PCG solve for a longer
    # step.  Each corrector saves some iterations but costs an extra PCG
    # solve; it was a net loss at bench scale on another machine, so the
    # default is 0 (not yet re-measured on the GPU).
    max_correctors: int = 0
    # Recompute the f32 preconditioner factor only every k-th iteration.
    # A stale factor needs many extra f64 PCG steps (each ~2 shared GEMM
    # sweeps) and loses endgame convergence; it was a net loss on another
    # machine — keep at 1 unless experimenting.
    factor_refresh_every: int = 1
    # Complementarity target window for corrector clipping [beta_min, beta_max].
    corrector_beta_min: float = 0.1
    corrector_beta_max: float = 10.0
    # Divergence guard: declare numerical failure when mu exceeds this.
    mu_max: float = 1e32
    # Relative-gap stagnation monitor (reference src/sypha_solver.cpp:739-769):
    # stop with GAP_STALLED when the gap fails to improve by
    # gap_stall_min_improv (fraction) for gap_stall_window iterations.
    # 0 disables (LP-only solves); the B&B driver enables it per node.
    gap_stall_window: int = 0
    gap_stall_min_improv: float = 0.01

    def replace(self, **kw) -> "IpmOptions":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CgOptions:
    """Static parameters of the conjugate-gradient normal-equations path.

    Mirrors reference kKrylov* defaults (src/sypha_environment_defaults.h:21-24)
    including the per-IPM-iteration adaptive tolerance decay
    (src/sypha_solver.cpp:552-553).
    """

    max_cg_iter: int = 500
    tol_initial: float = 1e-2
    tol_final: float = 1e-8
    tol_decay_rate: float = 0.5

    def replace(self, **kw) -> "CgOptions":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class BnbOptions:
    """Branch & bound driver knobs (reference src/sypha_environment_defaults.h:32-47)."""

    max_nodes: int = 100000
    # Batch of node LPs solved together per vmapped device round; plays the
    # role (and default size is deliberately smaller than) the reference's
    # DeviceNodeWindow capacity of 1000 — we actually solve the window
    # concurrently rather than staging it.
    node_batch: int = 64
    # Parent-iterate warm starts for node LPs.  Default OFF: measured on
    # scp49 children, warm-started lanes need 43-48 IPM iterations vs
    # 14-15 cold (the 1e-3 interior clamp leaves a near-boundary point
    # Mehrotra recenters from slowly), and under the gap-stagnation
    # throttle (16 iters) every warm lane returns MAX_ITER garbage whose
    # children inherit a worse iterate still — unreliable bounds, no
    # pruning, exponential frontier churn.  Cold starts are 3x faster and
    # reliable; the machinery stays for future shift-tuning experiments.
    warm_start_nodes: bool = False
    gap_stall_branch_iters: int = 5
    gap_stall_min_improv_pct: float = 1.0
    integrality_tol: float = 1e-6
    heuristic_every_n_nodes: int = 1
    log_interval_sec: float = 5.0
    hard_time_limit_sec: float = 0.0
    gap_stagnation_window: int = 50
    auto_fallback_lp: bool = True
    cuts_enabled: bool = True
    cut_rounds_root: int = 5
    max_cuts_per_round: int = 50
    # "most_fractional" / "highest_cost" (the reference's two selectors,
    # src/sypha_solver_heuristics.cpp:10-51) or "pseudocost" (no reference
    # counterpart: per-variable bound-gain statistics, product score)
    var_selection: str = "most_fractional"
    int_heuristics: str = "nearest_integer_fixing,dual_guided_cover_repair"
    # Batched strong branching (both children of the top-K
    # fractional candidates solve as ONE batched LP call): applied at nodes
    # with depth <= strong_branch_depth, candidate cap strong_branch_cands.
    # 0 disables (default: on plateaued SCP trees the per-node batched
    # solve costs more than the tree reduction buys; the reference has only
    # most-fractional/highest-cost selection).
    strong_branch_depth: int = 0
    strong_branch_cands: int = 8
    # checkpoint/resume (new capability, absent in the reference — SURVEY §5
    # notes a killed run restarts from scratch): snapshot frontier +
    # incumbent + bounds to this path every interval; resume when the file
    # exists at startup.  "" disables.
    checkpoint_path: str = ""
    checkpoint_interval_sec: float = 60.0
    # Hard-time-limit enforcement granularity: when a deadline is set, node
    # window solves dispatch in chunks of this many IPM iterations with a
    # host wall-clock check between chunks (the iteration cap is a traced
    # scalar, so chunking costs zero recompiles).  This bounds time-limit
    # overshoot to ~one chunk of the slowest window instead of a whole
    # solve (reference polls its watchdog every IPM iteration,
    # src/sypha_solver.cpp:498-502).  Chunk size then adapts to target
    # iter_chunk_target_sec of wall time per dispatch.
    iter_chunk: int = 8
    iter_chunk_target_sec: float = 3.0
    # Compile every node-LP executable before starting the solve clock
    # (the reference's C++ is AOT-compiled; one-time XLA compiles must not
    # eat the hard time budget).
    precompile: bool = True
    # Multi-chip node windows: when >0, the driver builds a jax mesh over
    # this many devices and dispatches every window through
    # parallel.mesh.solve_node_batch_sharded (lane axis sharded, base LP
    # replicated); host-side bounds pool across processes via
    # parallel.distributed.BoundPool each round.  0 = single-device.
    mesh_devices: int = 0
    # In-tree cut separation: every node whose LP improves its parent bound
    # and stays fractional is a candidate; separate on at most this many
    # nodes per window round (0 disables — root-only cuts, the reference
    # behavior).  Cuts derived from node duals are GLOBALLY valid here
    # because branch decisions are column fixings, not rows: the aggregated
    # rows are always original covering+cut rows.
    tree_cut_nodes_per_round: int = 2
    tree_cut_max_rounds: int = 200
    # CFT-style Lagrangian greedy at the root (heuristics.
    # lagrangian_greedy_covers): sample perturbed multiplier vectors around
    # the root LP duals and run the score-based greedy per sample.  Runs
    # only when the root integer gap is >= lagrangian_min_gap units (easy
    # instances never pay for it); wall-clock bounded.  0 samples disables.
    # Defaults retuned r5 after the greedy went incremental (~10x more
    # samples/sec): 600 samples reached SCIP's nrh3 incumbent (62 vs 63)
    # in 11.8 s offline where 48 samples plateaued at 64.  Small instances
    # finish the full sample count in <2 s; the budget only binds at
    # nrg/nrh scale, where the extra incumbent units are worth it.
    lagrangian_samples: int = 600
    lagrangian_budget_sec: float = 15.0
    lagrangian_min_gap: float = 2.0
    # Core (kernel) search: on large-gap instances, recursively run the
    # B&B restricted to a small column core (incumbent support + sampled
    # Lagrangian cover supports + smallest-reduced-cost columns, ~core_mult
    # x cover size) for core_time_frac of the remaining budget.  Any
    # incumbent the restricted search finds is globally valid (a cover over
    # a column subset is a cover); its bounds/proofs are NOT and are
    # discarded.  0 disables.
    core_time_frac: float = 0.45
    core_time_cap_sec: float = 60.0
    # Endgame mode: when the integer gap is exactly one unit, the frontier
    # holds at least this many nodes (a plateau the tree will not close),
    # and the async closure ladder is grinding the final refutation, the
    # driver stops dispatching node windows and gives the DFS the whole
    # host core (the 1-CPU host otherwise splits it and the final proof
    # misses the budget).  0 disables.
    endgame_frontier: int = 256
    # Second endgame trigger: at one unit of gap with the closure busy, a
    # frontier that is PLATEAUED in time (no incumbent or bound change for
    # this many seconds) arms the endgame even before the frontier-size
    # gate.  Measured scpnre1 (r5 verbose run): windows ramp 1,2,4,... so
    # the frontier took ~55 s of the final 204 s refute to reach 256 nodes
    # of zero bound progress — host cycles the DFS needed.  0 disables.
    endgame_stall_sec: float = 20.0
    # Repeated core rounds (CFT core-refresh style): after a round improves
    # the incumbent the core is rebuilt around the new support and searched
    # again; a non-improving round doubles the core size once before
    # stopping.  Bounded by root_time_frac like every optional root phase.
    core_rounds: int = 3
    # Root-phase budget guard: the OPTIONAL root phases (Lagrangian greedy,
    # root cut rounds, core search) may together spend at most this
    # fraction of the hard time budget before the tree must start.  On
    # 1000x10000 instances the unguarded root pipeline consumed entire
    # 130 s sessions (scpnrg2/scpnrh1: iterations=0, the tree never
    # started).  Mandatory phases (reductions, root LP) are exempt — a
    # tree without a root bound is useless.  0 disables the guard.
    root_time_frac: float = 0.5
    # Padded-column floor for the node-LP bucket (0 = natural rounding).
    # The compact re-solve sets it to a STANDARD rung (bnb._STD_RUNGS) so
    # compact children across a family sweep share compiled executables —
    # each fresh bucket shape costs a compile while the padding waste is
    # bounded at ~33% FLOPs (1.25-1.5x rung spacing).
    bucket_cols_floor: int = 0
    core_min_active: int = 1000
    core_mult: int = 6
    # Skip root cut rounds entirely when the root integer gap exceeds this
    # many objective units (integral objectives only): CG/zero-half rounds
    # can close 1-3 units, never 25, and each round re-solves the root LP.
    # 0 disables the skip.
    cut_skip_gap: float = 10.0
    # Compact re-solve: when improving-preserving reductions (incumbent
    # cutoff, budget pruning, dominance, reduced-cost fixing) collapse the
    # active set enough that the compacted standard form lands in a padded
    # bucket <= compact_frac x the current one, rebase: build a compacted
    # model over (active + incumbent-support) columns and delegate the
    # remaining search to a recursive branch_and_bound on it.  Node LPs
    # then run at the small bucket's throughput (scpnre1: 401/5000 columns
    # active after root rc-fixing, ~13x fewer GEMM FLOPs per window).  The
    # reference's counterpart is physical column removal + remap
    # (rebuildCsrAfterRemoval, src/sypha_node_sparse.cpp:224-282), which
    # the shape-static design replaced with masking; the rebase pays
    # one extra XLA compile (reported in compile_time_sec) to stop paying
    # the masked width every window.
    compact_resolve: bool = True
    compact_frac: float = 0.5
    # Master switch for the exact-closure engine (host bitset DFS budget
    # probing over reduced faces).  Off = pure tree search with cuts and
    # rc-fixing only — used by ablation experiments and by the multichip
    # dryrun's mesh-B&B leg, which must exercise a NON-EMPTY tree (closure
    # proves its instance at the root, so the driver-integrated mesh
    # window path would never dispatch).
    exact_closure: bool = True
    # Run exact-closure probe sessions on a background thread (the native
    # DFS is host work, node windows are device work — concurrency gives
    # the refutation ladder the whole wall clock instead of alternating
    # with the tree).  Requires the native library; falls back to the
    # inline sessions when absent.
    async_closure: bool = True
    # Arm the exact-closure engine's static cut-row Lagrangian term with
    # the seed's cut duals.  Measured on the scpnre1 401-column face:
    # NEUTRAL with covering-dual seeds (refute-26: 58.5s vs 58.8s plain —
    # the joint feasibility scaling leaves the cut multiplier near zero)
    # and a large LOSS with cut-dual seeds (inconclusive at 420s vs 59s:
    # the static cut mass decays as the DFS picks columns while the
    # displaced covering-u machinery would have reallocated).  Default
    # off; the engine capability stays for experiments.
    closure_use_cuts: bool = False
    # Device operator for the node-LP base matrix: "auto" picks the
    # padded-ELL sparse operator below node_ell_density (the ELL gathers
    # win on sparse matrices and store far less; dense GEMMs win on denser
    # ones), matching the reference's size-driven linear-solver auto pick
    # (src/sypha_solver.cpp:291-316).  "dense"/"ell" force a side.  The 5%
    # crossover was measured on another machine; to be re-measured on the
    # GPU (benchmark/ell_vs_dense.py).
    node_operator: str = "auto"
    node_ell_density: float = 0.05

    def replace(self, **kw) -> "BnbOptions":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SolverConfig:
    """Top-level configuration: environment + all subsystem options.

    Field names track the reference CLI flags (src/sypha_environment.cpp:111-149).
    """

    verbosity: int = 5
    time_limit_sec: float = 0.0  # 0 = unlimited (reference kBnbHardTimeLimitSeconds)
    seed: int = 0

    # linear solver strategy: auto | dense | cg  (reference adds sparse_qr,
    # which exists to suit cusolverSp and has no reason to exist here;
    # `auto` picks dense Cholesky vs CG by padded problem size).
    linear_solver: str = "auto"

    disable_bnb: bool = False
    show_solution: bool = False

    preprocess_time_limit_sec: float = 5.0
    preprocess_column_strategies: str = "single_column_dominance,two_column_dominance"

    ipm: IpmOptions = IpmOptions()
    cg: CgOptions = CgOptions()
    bnb: BnbOptions = BnbOptions()

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)
