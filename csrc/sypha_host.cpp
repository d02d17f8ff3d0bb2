// sypha_host — native host-side runtime for sypha.
//
// The reference implements its entire host runtime in C++ (model reader
// src/model_reader.cpp, presolve rules src/sypha_preprocessor.cpp, greedy
// cover :11-98); this library is this package's native counterpart for the
// pieces that are hot on the host: SCP file parsing and the O(n^2)-O(n^3)
// column-elimination loops over bitset row masks.  The Python layer
// (sypha.native) loads it with ctypes and falls back to the vectorised
// numpy implementations when the library is unavailable.
//
// ABI: plain C, flat arrays.  Bitsets are [ncols x nwords] uint64 row masks
// (bit r of column j set iff column j covers row r).  `active` is a uint8
// mask updated in place; every rule returns how many columns it newly
// deactivated.  All rules honor a wall-clock deadline in seconds (<= 0
// disables), like the reference's --preprocess-time-limit-sec.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <x86intrin.h>

namespace {

// cycle counter for the SYPHA_EC_PROF section attribution (profiling only;
// rdtsc is not serializing, good enough for >10%-scale attribution)
inline uint64_t ec_now() { return __rdtsc(); }

using Clock = std::chrono::steady_clock;

struct Deadline {
    Clock::time_point end;
    bool enabled;
    explicit Deadline(double seconds) : enabled(seconds > 0.0) {
        if (enabled)
            end = Clock::now() +
                  std::chrono::duration_cast<Clock::duration>(
                      std::chrono::duration<double>(seconds));
    }
    bool expired() const { return enabled && Clock::now() >= end; }
};

// does `sup` contain every bit of `sub`?
inline bool covers(const uint64_t* sup, const uint64_t* sub, int nwords) {
    for (int w = 0; w < nwords; ++w)
        if (sub[w] & ~sup[w]) return false;
    return true;
}

inline bool any_bits(const uint64_t* m, int nwords) {
    for (int w = 0; w < nwords; ++w)
        if (m[w]) return true;
    return false;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// SCP reader (reference model_reader_read_scp_file_sparse_csr,
// src/model_reader.cpp:90-174; the raw covering matrix, standard form is
// built by the Python layer).  Two-phase handle protocol.
// ---------------------------------------------------------------------------

struct ScpFile {
    int nrows = 0, ncols = 0;
    std::vector<double> costs;
    std::vector<int64_t> row_ptr;   // [nrows + 1]
    std::vector<int32_t> row_idx;   // column indices per row, 0-based
};

void* sypha_scp_open(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(size) + 1);
    if (std::fread(buf.data(), 1, static_cast<size_t>(size), f) !=
        static_cast<size_t>(size)) {
        std::fclose(f);
        return nullptr;
    }
    std::fclose(f);
    buf[static_cast<size_t>(size)] = '\0';

    auto* out = new ScpFile();
    char* p = buf.data();
    char* endp = nullptr;

    auto next_long = [&](long long* v) -> bool {
        *v = std::strtoll(p, &endp, 10);
        if (endp == p) return false;
        p = endp;
        return true;
    };
    auto next_double = [&](double* v) -> bool {
        *v = std::strtod(p, &endp);
        if (endp == p) return false;
        p = endp;
        return true;
    };

    long long nrows = 0, ncols = 0;
    if (!next_long(&nrows) || !next_long(&ncols) || nrows <= 0 || ncols <= 0) {
        delete out;
        return nullptr;
    }
    out->nrows = static_cast<int>(nrows);
    out->ncols = static_cast<int>(ncols);
    out->costs.resize(static_cast<size_t>(ncols));
    for (long long j = 0; j < ncols; ++j) {
        if (!next_double(&out->costs[static_cast<size_t>(j)])) {
            delete out;
            return nullptr;
        }
    }
    out->row_ptr.reserve(static_cast<size_t>(nrows) + 1);
    out->row_ptr.push_back(0);
    for (long long i = 0; i < nrows; ++i) {
        long long cnt = 0;
        if (!next_long(&cnt) || cnt < 0) {
            delete out;
            return nullptr;
        }
        for (long long k = 0; k < cnt; ++k) {
            long long col = 0;  // on-disk indices are 1-based
            if (!next_long(&col) || col < 1 || col > ncols) {
                delete out;
                return nullptr;
            }
            out->row_idx.push_back(static_cast<int32_t>(col - 1));
        }
        out->row_ptr.push_back(static_cast<int64_t>(out->row_idx.size()));
    }
    return out;
}

void sypha_scp_dims(void* h, int* nrows, int* ncols, int64_t* nnz) {
    auto* s = static_cast<ScpFile*>(h);
    *nrows = s->nrows;
    *ncols = s->ncols;
    *nnz = static_cast<int64_t>(s->row_idx.size());
}

void sypha_scp_fill(void* h, double* costs, int64_t* row_ptr, int32_t* row_idx) {
    auto* s = static_cast<ScpFile*>(h);
    std::memcpy(costs, s->costs.data(), s->costs.size() * sizeof(double));
    std::memcpy(row_ptr, s->row_ptr.data(), s->row_ptr.size() * sizeof(int64_t));
    std::memcpy(row_idx, s->row_idx.data(), s->row_idx.size() * sizeof(int32_t));
}

void sypha_scp_close(void* h) { delete static_cast<ScpFile*>(h); }

// ---------------------------------------------------------------------------
// Greedy set cover (reference greedy_set_cover_heuristic,
// src/sypha_preprocessor.cpp:11-98): sort active columns by
// (cost, -coverage, index), single sweep.  Returns #selected (or -1 if the
// sweep cannot cover), fills `selected` (capacity ncols) and *objective.
// ---------------------------------------------------------------------------

int sypha_greedy_set_cover(
    const int64_t* col_ptr, const int32_t* col_idx,  // rows per column (CSC)
    const double* costs, const uint8_t* active,
    int nrows, int ncols,
    int32_t* selected, double* objective) {
    std::vector<int> order;
    order.reserve(static_cast<size_t>(ncols));
    for (int j = 0; j < ncols; ++j)
        if (active[j]) order.push_back(j);
    std::sort(order.begin(), order.end(), [&](int a, int b) {
        if (costs[a] != costs[b]) return costs[a] < costs[b];
        int64_t ca = col_ptr[a + 1] - col_ptr[a];
        int64_t cb = col_ptr[b + 1] - col_ptr[b];
        if (ca != cb) return ca > cb;
        return a < b;
    });

    std::vector<uint8_t> covered(static_cast<size_t>(nrows), 0);
    int uncovered = nrows;
    double total = 0.0;
    int nsel = 0;
    for (int j : order) {
        if (uncovered <= 0) break;
        bool adds = false;
        for (int64_t k = col_ptr[j]; k < col_ptr[j + 1]; ++k)
            if (!covered[static_cast<size_t>(col_idx[k])]) { adds = true; break; }
        if (!adds) continue;
        for (int64_t k = col_ptr[j]; k < col_ptr[j + 1]; ++k) {
            auto r = static_cast<size_t>(col_idx[k]);
            if (!covered[r]) { covered[r] = 1; --uncovered; }
        }
        total += costs[j];
        selected[nsel++] = j;
    }
    *objective = total;
    return uncovered == 0 ? nsel : -1;
}

// ---------------------------------------------------------------------------
// Column dominance rules over bitset row masks
// (reference src/sypha_preprocessor.cpp:217-488).
// ---------------------------------------------------------------------------

int sypha_single_column_dominance(
    const uint64_t* masks, int nwords,
    const double* costs, uint8_t* active,
    int ncols, double tol, double deadline_sec) {
    Deadline dl(deadline_sec);
    int removed = 0;
    for (int t = 0; t < ncols; ++t) {
        if (dl.expired()) break;
        if (!active[t]) continue;
        const uint64_t* tm = masks + static_cast<size_t>(t) * nwords;
        for (int j = 0; j < ncols; ++j) {
            if (j == t || !active[j]) continue;
            if (costs[j] > costs[t] + tol) continue;
            // equal-cost ties keep the lower index
            if (costs[j] >= costs[t] - tol && j >= t) continue;
            if (covers(masks + static_cast<size_t>(j) * nwords, tm, nwords)) {
                active[t] = 0;
                ++removed;
                break;
            }
        }
    }
    return removed;
}

namespace {

// shared pair/triplet search: is there a pair (or triplet) among cand
// (cost-sorted ascending) with total cost <= budget whose union covers tm?
bool pair_triplet_dominated(
    const uint64_t* masks, int nwords, const double* costs,
    const uint64_t* tm, const int32_t* cand, int ncand,
    double budget, bool triplets, const Deadline& dl,
    std::vector<uint64_t>& rem, std::vector<uint64_t>& rem2) {
    rem.resize(static_cast<size_t>(nwords));
    rem2.resize(static_cast<size_t>(nwords));
    for (int i = 0; i < ncand; ++i) {
        if (dl.expired()) return false;
        int a = cand[i];
        double ci = costs[a];
        if (ci > budget) break;
        const uint64_t* ma = masks + static_cast<size_t>(a) * nwords;
        bool empty = true;
        for (int w = 0; w < nwords; ++w) {
            rem[static_cast<size_t>(w)] = tm[w] & ~ma[w];
            if (rem[static_cast<size_t>(w)]) empty = false;
        }
        if (empty) continue;  // single coverage is the single-column rule's job
        for (int j = i + 1; j < ncand; ++j) {
            int b = cand[j];
            double cij = ci + costs[b];
            if (cij > budget) break;
            const uint64_t* mb = masks + static_cast<size_t>(b) * nwords;
            if (covers(mb, rem.data(), nwords)) return true;
            if (!triplets) continue;
            bool empty2 = true;
            for (int w = 0; w < nwords; ++w) {
                rem2[static_cast<size_t>(w)] = rem[static_cast<size_t>(w)] & ~mb[w];
                if (rem2[static_cast<size_t>(w)]) empty2 = false;
            }
            if (empty2) continue;
            for (int k = j + 1; k < ncand; ++k) {
                int c = cand[k];
                if (cij + costs[c] > budget) break;
                if (covers(masks + static_cast<size_t>(c) * nwords,
                           rem2.data(), nwords))
                    return true;
            }
        }
    }
    return false;
}

}  // namespace

// Shared driver for two_column_dominance / cost_driven_replacement.
// `targets` is the scan order; per target the candidate list is every
// active column sharing a row (computed from the row CSR), cost-sorted.
static int dominance_scan(
    const uint64_t* masks, int nwords,
    const double* costs, uint8_t* active, int ncols,
    const int64_t* row_ptr, const int32_t* row_idx, int nrows,
    const int64_t* col_ptr, const int32_t* col_idx,
    const int32_t* targets, int ntargets,
    double budget_tol, bool triplets, double deadline_sec) {
    Deadline dl(deadline_sec);
    int removed = 0;
    std::vector<int32_t> cand;
    std::vector<uint8_t> seen(static_cast<size_t>(ncols), 0);
    std::vector<uint64_t> rem, rem2;
    (void)nrows;
    for (int ti = 0; ti < ntargets; ++ti) {
        if (dl.expired()) break;
        int t = targets[ti];
        if (!active[t]) continue;
        // candidates: active columns sharing a covering row with t
        cand.clear();
        for (int64_t k = col_ptr[t]; k < col_ptr[t + 1]; ++k) {
            int r = col_idx[k];
            for (int64_t q = row_ptr[r]; q < row_ptr[r + 1]; ++q) {
                int j = row_idx[q];
                if (j != t && active[j] && !seen[static_cast<size_t>(j)]) {
                    seen[static_cast<size_t>(j)] = 1;
                    cand.push_back(j);
                }
            }
        }
        for (int32_t j : cand) seen[static_cast<size_t>(j)] = 0;
        if (static_cast<int>(cand.size()) < 2) continue;
        std::sort(cand.begin(), cand.end(), [&](int a, int b) {
            if (costs[a] != costs[b]) return costs[a] < costs[b];
            return a < b;
        });
        double budget = costs[t] + budget_tol;
        if (pair_triplet_dominated(masks, nwords, costs,
                                   masks + static_cast<size_t>(t) * nwords,
                                   cand.data(), static_cast<int>(cand.size()),
                                   budget, triplets, dl, rem, rem2)) {
            active[t] = 0;
            ++removed;
        }
    }
    return removed;
}

int sypha_two_column_dominance(
    const uint64_t* masks, int nwords,
    const double* costs, uint8_t* active, int ncols,
    const int64_t* row_ptr, const int32_t* row_idx, int nrows,
    const int64_t* col_ptr, const int32_t* col_idx,
    double tol, double deadline_sec) {
    // targets scanned in index order; strict budget cost_t - tol
    std::vector<int32_t> targets;
    targets.reserve(static_cast<size_t>(ncols));
    for (int t = 0; t < ncols; ++t)
        if (active[t]) targets.push_back(t);
    return dominance_scan(masks, nwords, costs, active, ncols, row_ptr,
                          row_idx, nrows, col_ptr, col_idx, targets.data(),
                          static_cast<int>(targets.size()),
                          -tol - 1e-300, /*triplets=*/false, deadline_sec);
}

int sypha_cost_driven_replacement(
    const uint64_t* masks, int nwords,
    const double* costs, uint8_t* active, int ncols,
    const int64_t* row_ptr, const int32_t* row_idx, int nrows,
    const int64_t* col_ptr, const int32_t* col_idx,
    double tol, double deadline_sec) {
    // targets scanned most-expensive-first; budget cost_t + tol, triplets on
    std::vector<int32_t> targets;
    targets.reserve(static_cast<size_t>(ncols));
    for (int t = 0; t < ncols; ++t)
        if (active[t]) targets.push_back(t);
    std::sort(targets.begin(), targets.end(), [&](int a, int b) {
        if (costs[a] != costs[b]) return costs[a] > costs[b];
        return a < b;
    });
    return dominance_scan(masks, nwords, costs, active, ncols, row_ptr,
                          row_idx, nrows, col_ptr, col_idx, targets.data(),
                          static_cast<int>(targets.size()),
                          tol, /*triplets=*/true, deadline_sec);
}

// ---------------------------------------------------------------------------
// Incumbent budget pruning (reference IncumbentBudgetPruningRule,
// src/sypha_preprocessor.cpp:490-665): per column, budget =
// floor(incumbent) - 1 - floor(cost); tiered checks for budget {<0, 0, 1}
// and a max-of-min-row-cost bound for budget >= 2.
// ---------------------------------------------------------------------------

int sypha_budget_pruning(
    const uint64_t* masks, int nwords,
    const double* costs, uint8_t* active, int ncols,
    const int64_t* row_ptr, const int32_t* row_idx, int nrows,
    double incumbent, double tol, double deadline_sec) {
    if (!std::isfinite(incumbent)) return 0;
    Deadline dl(deadline_sec);
    int removed = 0;
    double inc_floor = std::floor(incumbent);

    std::vector<int32_t> order;
    order.reserve(static_cast<size_t>(ncols));
    for (int t = 0; t < ncols; ++t)
        if (active[t]) order.push_back(t);
    std::sort(order.begin(), order.end(), [&](int a, int b) {
        if (costs[a] != costs[b]) return costs[a] > costs[b];
        return a < b;
    });

    auto row_min_costs = [&](std::vector<double>& rm) {
        rm.assign(static_cast<size_t>(nrows), HUGE_VAL);
        for (int r = 0; r < nrows; ++r)
            for (int64_t q = row_ptr[r]; q < row_ptr[r + 1]; ++q) {
                int j = row_idx[q];
                if (active[j] && costs[j] < rm[static_cast<size_t>(r)])
                    rm[static_cast<size_t>(r)] = costs[j];
            }
    };
    std::vector<double> rmin;
    row_min_costs(rmin);
    int stale = 0;

    std::vector<int32_t> cost1;
    for (int j = 0; j < ncols; ++j)
        if (active[j] && std::fabs(costs[j] - 1.0) <= tol) cost1.push_back(j);

    std::vector<uint64_t> unc(static_cast<size_t>(nwords));
    for (int t : order) {
        if (dl.expired()) break;
        if (!active[t]) continue;
        double budget = inc_floor - 1.0 - std::floor(costs[t]);
        if (budget < -tol) {
            active[t] = 0;
            ++removed;
            continue;
        }
        const uint64_t* tm = masks + static_cast<size_t>(t) * nwords;
        bool all_covered = true;
        for (int w = 0; w < nwords; ++w) {
            int bits = (w == nwords - 1 && nrows % 64) ? nrows % 64 : 64;
            uint64_t full = bits == 64 ? ~0ULL : ((1ULL << bits) - 1ULL);
            unc[static_cast<size_t>(w)] = full & ~tm[w];
            if (unc[static_cast<size_t>(w)]) all_covered = false;
        }
        if (all_covered) continue;

        if (budget < tol) {  // budget == 0
            active[t] = 0;
            ++removed;
            ++stale;
            continue;
        }
        if (budget < 1.0 + tol) {  // budget == 1
            bool found = false;
            for (int32_t j : cost1) {
                if (j == t || !active[j]) continue;
                if (covers(masks + static_cast<size_t>(j) * nwords,
                           unc.data(), nwords)) {
                    found = true;
                    break;
                }
            }
            if (!found) {
                active[t] = 0;
                ++removed;
                ++stale;
            }
            continue;
        }
        // budget >= 2
        if (stale > 64) {
            row_min_costs(rmin);
            stale = 0;
        }
        double worst = 0.0;
        for (int r = 0; r < nrows; ++r) {
            if (unc[static_cast<size_t>(r / 64)] & (1ULL << (r % 64))) {
                if (rmin[static_cast<size_t>(r)] > worst)
                    worst = rmin[static_cast<size_t>(r)];
            }
        }
        if (!(worst <= budget + tol)) {  // catches inf too
            active[t] = 0;
            ++removed;
            ++stale;
        }
    }
    return removed;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Exact small-cover enumeration (counterpart of presolve.exact_small_cover;
// the FIND/REFUTE engine behind the B&B driver's exact face closure).
// Returns 1 = found (out_sel gets the 0/1 structural solution),
//         0 = proven: no cover with cost <= budget among active columns,
//        -1 = inconclusive (deadline).
// ---------------------------------------------------------------------------

namespace {

struct ExactCoverCtx {
    const uint64_t* full;
    int64_t nwords;
    const double* costs;       // sorted-active order
    const uint64_t* masks;     // sorted-active order, row bitmasks
    const std::vector<std::vector<int32_t>>* by_row;
    const double* spread;
    const double* row_min;
    const int32_t* n_cands;
    // LP-dual (Lagrangian) bound data: dualw[r] = max(0,y_r) + neg_rc is an
    // admissible per-uncovered-row weight (see sypha_exact_cover), rc[i] the
    // clamp-adjusted reduced cost of sorted-active column i.  Any completion
    // of a partial cover with uncovered set U reachable in the remaining
    // subtree costs >= sum_{r in U} dualw[r] on top of the partial cost.
    const double* dualw;
    const double* rc;
    double budget;
    double dual_eps;           // scale-aware slack for the dual-bound prunes
    // Integral-cost bound rounding: when every active cost is integral,
    // every completion's remaining cost is integral, so any fractional
    // lower bound lb on it tightens to ceil(lb - eps) — the in-DFS
    // analogue of the driver's ceil dual-bound tightening
    // (tighten_dual_bound; reference src/sypha_solver_bnb.cpp:398-403).
    // On plateau probes (slack a few units, bounds fractional) this
    // prunes a large constant fraction of every level.
    bool costs_integral = false;
    inline double lbr(double lb) const {
        return costs_integral ? std::ceil(lb - dual_eps) : lb;
    }
    std::chrono::steady_clock::time_point deadline;
    // Ascent sweeps per DFS node (SYPHA_EC_SWEEPS).  Default 1: measured
    // on the scpnre1/3/5 plateau faces, a second sweep changed ZERO DFS
    // calls (the first pass saturates every row it can) while costing a
    // full uncovered-row rescan — 1.6x wall on refute-26 (2026-08-19).
    int node_sweeps = 1;
    int dom_limit = 64;    // dominance-ban n_unc gate (SYPHA_EC_DOM)
    int64_t calls = 0;
    // work counters (printed under SYPHA_EC_STATS)
    int64_t n_scan_rows = 0;   // bound-scan uncovered-row visits
    int64_t n_asc_visits = 0;  // ascent candidate-slack loads
    int64_t n_apply = 0;       // dual_apply invocations
    int64_t n_dom_pairs = 0;   // dominance pairwise word loops
    // rdtsc section cycles (printed under SYPHA_EC_PROF): node bound scan,
    // ascend_pass, ascend_after_ban, dominance scan, child-cover+descend
    bool prof = false;
    int64_t cyc_scan = 0, cyc_asc = 0, cyc_ban_asc = 0, cyc_dom = 0,
            cyc_child = 0, cyc_undo = 0;
    std::vector<int32_t> chosen;
    // per-depth child-cover buffers: the DFS visits millions of nodes and
    // a per-candidate heap allocation for cov2 is pure overhead; siblings
    // at the same depth reuse the same buffer sequentially
    std::vector<std::vector<uint64_t>> cov_pool;
    bool timed_out = false;
    // --- dynamic dual-ascent bound (armed when duals are provided) ---
    // u[r] is a FEASIBLE multiplier vector (redc[i] >= 0 for every active
    // column i), so sum_{r in U} u[r] lower-bounds any completion of an
    // uncovered set U.  Each DFS node runs greedy ascent sweeps (raise u_r
    // by the min reduced cost among r's candidates) on the uncovered rows;
    // mutations go through an undo log popped on backtrack.  redc is NOT
    // updated when rows become covered by a chosen column (that would only
    // RAISE true slacks), so the tracked redc is a conservative
    // underestimate and the bound stays admissible without per-descend
    // bookkeeping.
    bool ascend = false;
    std::vector<double> u;
    // the tracked reduced cost: equals redc[i] for live columns, 1e300 for
    // banned ones (maintained on ban/unban and in dual_apply).  The ascent
    // inner loop is the DFS's dominant cost (measured 14.7e9 candidate
    // visits on the scpnre3 budget-25 face).  There is deliberately NO
    // second "true redc" array: dual_apply/ascend_undo used to mirror
    // every update into one (2x the write traffic of the hottest store
    // path, ~18% of DFS cycles in undo alone) solely so unban_col could
    // restore the shadow exactly; the restore is instead recomputed from
    // the invariant  redc[i] = redc0[i] + u0sum[i] - sum_{r in mask_i} u[r]
    // (redc0 = initial clamped reduced cost incl. static cut deductions,
    // u0sum = initial mask-row dual mass), one ~popcount(mask)-long sum
    // per unban vs millions of mirrored stores between ban/unban pairs.
    std::vector<double> redc_eff;
    std::vector<double> redc0;   // initial reduced costs (static)
    std::vector<double> u0sum;   // sum of initial u over each column's rows
    // per-row zero-slack witness: the candidate last observed at zero
    // slack for row r.  Most gathers on near-saturated plateau faces end
    // at SOME zero-slack candidate; caching which one turns the rescan
    // (front of the cost-sorted list every time) into a single load.
    // Purely an accelerator: a stale witness (slack rose on undo, or the
    // column was banned so redc_eff is 1e300) just fails the <=0 check
    // and the full gather runs — DFS semantics and call counts unchanged.
    std::vector<int32_t> witness;
    // live (non-banned) candidate count per row, maintained by
    // ban_col/unban_col.  Two uses: the most-constrained branch-row pick
    // reflects bans (the static n_cands overcounts deep in the tree,
    // where sibling-exclusion bans thin the real choice set), and a row
    // whose live count hits zero refutes the node at scan time, before
    // any ascent work.
    std::vector<int32_t> live_cands;
    std::vector<std::pair<int32_t, double>> ulog;
    // --- sibling-exclusion branching ---
    // Branching on row r's candidates i_1..i_k partitions the covers by
    // the LOWEST-tried candidate that covers r: inside branch i_t no cover
    // needs i_1..i_{t-1} (any such cover lives in an earlier branch), so
    // they are banned for the whole subtree.  Bans compose down the tree
    // and also sharpen the dual ascent: a banned column's slack no longer
    // caps its rows' multipliers.
    std::vector<uint8_t> banned;
    // --- static cut-row Lagrangian (rank-1 CG closure strength) ---
    // The root LP's dual mass migrates onto appended CG cut rows (the
    // cut-strengthened LP bound EXCEEDS the plain LP bound, e.g. scpnre1
    // 21.38 -> 22.0 after one dual-aggregated cut), and the covering-row
    // ascent alone can never exceed the plain LP bound.  With fixed
    // multipliers w_c >= 0 on cut rows a_c . x >= rho_c and redc_i also
    // deducting w . a_i (joint feasibility scaling at setup), every
    // completion T of a partial cover satisfies
    //   c(T) >= sum_{r in U} u_r + sum_c w_c max(0, rho_res_c) + redc_i
    // for any i in T, where rho_res_c = rho_c - a_c . chosen is tracked
    // down the DFS (restored on backtrack).  ncuts == 0 disables all of
    // it at zero cost.
    int64_t ncuts = 0;
    int64_t kcols = 0;             // sorted-active column count (ca stride)
    const double* cw = nullptr;    // [ncuts] scaled multipliers >= 0
    const double* ca = nullptr;    // [ncuts * kcols] sorted-active coeffs
    double rho[16];                // residual rhs (descend-mutated)
    inline double cut_mass() const {
        double s = 0.0;
        for (int64_t c2 = 0; c2 < ncuts; ++c2)
            if (rho[c2] > 0.0) s += cw[c2] * rho[c2];
        return s;
    }
};

// ban/unban column i, keeping the banned flag, the redc_eff shadow, and
// the per-row live-candidate counts consistent.  Every ban in the DFS is
// node-scoped (pushed to bans_here, released on exit), so the counts
// nest exactly with the search.
inline void ban_col(ExactCoverCtx& ctx, int32_t i) {
    ctx.banned[static_cast<size_t>(i)] = 1;
    ctx.redc_eff[static_cast<size_t>(i)] = 1e300;
    const uint64_t* mi = ctx.masks + static_cast<size_t>(i) * ctx.nwords;
    for (int64_t w = 0; w < ctx.nwords; ++w) {
        uint64_t m = mi[w] & ctx.full[w];
        while (m) {
            const int bit = __builtin_ctzll(m);
            m &= m - 1;
            --ctx.live_cands[static_cast<size_t>((w << 6) + bit)];
        }
    }
}

inline void unban_col(ExactCoverCtx& ctx, int32_t i) {
    ctx.banned[static_cast<size_t>(i)] = 0;
    const uint64_t* mi = ctx.masks + static_cast<size_t>(i) * ctx.nwords;
    if (ctx.ascend) {
        // exact restore from the invariant (see redc_eff comment): initial
        // reduced cost plus how much this column's rows' dual mass moved
        double s = ctx.redc0[static_cast<size_t>(i)] +
                   ctx.u0sum[static_cast<size_t>(i)];
        for (int64_t w = 0; w < ctx.nwords; ++w) {
            uint64_t m = mi[w];
            while (m) {
                const int bit = __builtin_ctzll(m);
                m &= m - 1;
                s -= ctx.u[static_cast<size_t>((w << 6) + bit)];
            }
        }
        ctx.redc_eff[static_cast<size_t>(i)] = s;
    } else {
        // without the ascent no path reads redc_eff (witness/dynamic bans
        // are ascend-gated); keep it finite for hygiene
        ctx.redc_eff[static_cast<size_t>(i)] = 0.0;
    }
    for (int64_t w = 0; w < ctx.nwords; ++w) {
        uint64_t m = mi[w] & ctx.full[w];
        while (m) {
            const int bit = __builtin_ctzll(m);
            m &= m - 1;
            ++ctx.live_cands[static_cast<size_t>((w << 6) + bit)];
        }
    }
}

// apply u[r] += d and redc[by_row[r]] -= d, logged for undo.  Two uses:
// ascent (d > 0: raise a row's multiplier into its candidates' slack) and
// descend (d = -u[r] when row r becomes covered: zero its multiplier and
// RETURN the mass to its candidates' slack so the child's ascent can
// redistribute it onto the still-uncovered rows — the per-node adaptive
// reallocation that makes deep plateau nodes refutable).
inline void dual_apply(ExactCoverCtx& ctx, int32_t r, double d) {
    ++ctx.n_apply;
    ctx.u[static_cast<size_t>(r)] += d;
    for (int32_t i : (*ctx.by_row)[static_cast<size_t>(r)]) {
        // banned columns' shadow stays huge (1e300 absorbs d); unban
        // recomputes it from u exactly, so no drift accumulates
        ctx.redc_eff[static_cast<size_t>(i)] -= d;
    }
    ctx.ulog.emplace_back(r, d);
}

// min reduced-cost gather over a row's candidate list: the DFS's dominant
// inner loop (48.8% of cycles, SYPHA_EC_PROF on the scpnre5 budget-26
// face).  Deliberately SCALAR: an AVX-512 vgatherdpd + masked-min version
// was measured 23% SLOWER end-to-end (3.2s vs 2.6s on that face) — the
// zero-slack early exit ends most gathers within a few candidates (277M
// scalar visits vs 386M vectorized), and an 8-lane gather costs more than
// the handful of L1 loads it replaces.
inline void min_slack_gather(const std::vector<int32_t>& cand,
                             const double* redc_eff, double& d, int32_t& amin,
                             int64_t& seen) {
    d = 1e300;
    amin = -1;
    size_t p = 0;
    const size_t n = cand.size();
    for (; p < n; ++p) {
        const int32_t i = cand[p];
        const double rcij = redc_eff[static_cast<size_t>(i)];
        if (rcij < d) { d = rcij; amin = i; }
        if (d <= 1e-12) { ++p; break; }
    }
    seen += static_cast<int64_t>(p);
}

double ascend_pass(ExactCoverCtx& ctx, const std::vector<uint64_t>& cov,
                   double lb_u, int max_sweeps = 2) {
    for (int sweep = 0; sweep < max_sweeps; ++sweep) {
        double gained = 0.0;
        for (int64_t w = 0; w < ctx.nwords; ++w) {
            uint64_t miss = ctx.full[w] & ~cov[static_cast<size_t>(w)];
            while (miss) {
                const int bit = __builtin_ctzll(miss);
                miss &= miss - 1;
                const int32_t r = static_cast<int32_t>((w << 6) + bit);
                // witness fast path: if the cached zero-slack candidate
                // still has zero slack, the min is 0 and the row gains
                // nothing — skip the gather (one load vs a list rescan)
                const int32_t wv = ctx.witness[static_cast<size_t>(r)];
                if (wv >= 0 && ctx.redc_eff[static_cast<size_t>(wv)] <= 1e-12) {
                    ++ctx.n_asc_visits;
                    continue;
                }
                // redc >= 0 is an ascent invariant, so a zero-slack
                // candidate ends the min-gather exactly: the row can gain
                // nothing this sweep.  The gather is the DFS's dominant
                // cost (60.7e9 visits on the scpnre1 budget-27 face) —
                // AVX-512 inside min_slack_gather.
                const auto& cand = (*ctx.by_row)[static_cast<size_t>(r)];
                double d;
                int32_t amin;
                min_slack_gather(cand, ctx.redc_eff.data(), d, amin,
                                 ctx.n_asc_visits);
                if (d >= 1e290) d = 1e300;  // all banned == uncoverable
                if (d >= 1e300) return 1e300;  // row uncoverable here: prune
                if (d > 1e-12) {
                    dual_apply(ctx, r, d);
                    lb_u += d;
                    gained += d;
                }
                // after the raise the argmin's slack is exactly 0 — it is
                // this row's zero-slack witness either way
                if (amin >= 0) ctx.witness[static_cast<size_t>(r)] = amin;
            }
        }
        if (gained < 1e-9) break;
    }
    return lb_u;
}

// Targeted re-ascent after banning column `ib`: a ban only releases the
// min-slack cap on rows where ib was a candidate, and raising those rows
// only LOWERS other rows' remaining slack, so sweeping rows(ib) ∩
// uncovered saturates the whole gain — a full-uncovered re-sweep per
// refuted sibling was ~80% of all ascent work (21.6e9 candidate visits
// on the scpnre3 budget-25 face, 18k per DFS call).
double ascend_after_ban(ExactCoverCtx& ctx, const std::vector<uint64_t>& cov,
                        double lb_u, int32_t ib) {
    const uint64_t* mi = ctx.masks + static_cast<size_t>(ib) * ctx.nwords;
    for (int64_t w = 0; w < ctx.nwords; ++w) {
        uint64_t miss = mi[w] & ctx.full[w] & ~cov[static_cast<size_t>(w)];
        while (miss) {
            const int bit = __builtin_ctzll(miss);
            miss &= miss - 1;
            const int32_t r = static_cast<int32_t>((w << 6) + bit);
            // witness fast path (see ascend_pass): a still-zero-slack
            // cached candidate proves the row gains nothing from the ban
            const int32_t wv = ctx.witness[static_cast<size_t>(r)];
            if (wv >= 0 && ctx.redc_eff[static_cast<size_t>(wv)] <= 1e-12) {
                ++ctx.n_asc_visits;
                continue;
            }
            // redc_eff is 1e300 for banned columns — one load covers both
            // the ban skip and the slack
            const auto& cand = (*ctx.by_row)[static_cast<size_t>(r)];
            double d;
            int32_t amin;
            min_slack_gather(cand, ctx.redc_eff.data(), d, amin,
                             ctx.n_asc_visits);
            if (d >= 1e290) return 1e300;  // row uncoverable here: prune
            if (d > 1e-12) {
                dual_apply(ctx, r, d);
                lb_u += d;
            }
            if (amin >= 0) ctx.witness[static_cast<size_t>(r)] = amin;
        }
    }
    return lb_u;
}

void ascend_undo(ExactCoverCtx& ctx, size_t mark) {
    while (ctx.ulog.size() > mark) {
        const auto& e = ctx.ulog.back();
        ctx.u[static_cast<size_t>(e.first)] -= e.second;
        for (int32_t i : (*ctx.by_row)[static_cast<size_t>(e.first)])
            ctx.redc_eff[static_cast<size_t>(i)] += e.second;
        ctx.ulog.pop_back();
    }
}

bool exact_cover_dfs(ExactCoverCtx& ctx, std::vector<uint64_t>& cov, double cost,
                     int depth) {
    if ((++ctx.calls & 4095) == 0 &&
        std::chrono::steady_clock::now() >= ctx.deadline) {
        ctx.timed_out = true;
        return false;
    }
    // one pass: lower bounds + most-constrained uncovered row.  With the
    // ascent armed the dynamic u-bound dominates the static spread /
    // row-min / dual-weight bounds at every node (u starts at the
    // theta-scaled LP duals and only ever rises), so their per-row
    // accumulation is skipped — measured ~15% of the per-call cost.
    double lb_spread = 0.0, lb_max = 0.0, lb_dual = 0.0, lb_u = 0.0;
    int32_t r_pick = -1;
    int32_t pick_c = INT32_MAX;
    int32_t n_unc = 0;
    uint64_t t_sec = ctx.prof ? ec_now() : 0;
    for (int64_t w = 0; w < ctx.nwords; ++w) {
        uint64_t miss = ctx.full[w] & ~cov[static_cast<size_t>(w)];
        n_unc += __builtin_popcountll(miss);
        ctx.n_scan_rows += __builtin_popcountll(miss);
        while (miss) {
            const int bit = __builtin_ctzll(miss);
            const int32_t rr = static_cast<int32_t>((w << 6) + bit);
            if (ctx.ascend) {
                lb_u += ctx.u[static_cast<size_t>(rr)];
            } else {
                lb_spread += ctx.spread[rr];
                lb_dual += ctx.dualw[rr];
                if (ctx.row_min[rr] > lb_max) lb_max = ctx.row_min[rr];
            }
            const int32_t lc = ctx.live_cands[static_cast<size_t>(rr)];
            if (lc < pick_c) { pick_c = lc; r_pick = rr; }
            miss &= miss - 1;
        }
    }
    if (ctx.prof) { uint64_t t2 = ec_now(); ctx.cyc_scan += t2 - t_sec; t_sec = t2; }
    if (r_pick < 0) return true;  // covered
    // an uncovered row with no live candidate refutes the node outright
    // (every ban is completion-preserving in this subtree's scope)
    if (pick_c == 0) return false;
    const double cmass = ctx.ncuts ? ctx.cut_mass() : 0.0;
    double lb = lb_spread > lb_max ? lb_spread : lb_max;
    if (lb_dual - ctx.dual_eps > lb) lb = lb_dual - ctx.dual_eps;
    if (ctx.ascend && lb_u + cmass - ctx.dual_eps > lb)
        lb = lb_u + cmass - ctx.dual_eps;
    if (cost + ctx.lbr(lb) > ctx.budget + 1e-9) return false;
    const size_t umark = ctx.ulog.size();
    if (ctx.ascend) {
        // greedy dual ascent on the uncovered rows: feasible-u mass is a
        // per-node-adaptive Lagrangian bound (undone on backtrack)
        if (ctx.prof) t_sec = ec_now();
        lb_u = ascend_pass(ctx, cov, lb_u, ctx.node_sweeps);
        if (ctx.prof) { uint64_t t2 = ec_now(); ctx.cyc_asc += t2 - t_sec; }
        if (lb_u >= 1e299 ||
            cost + ctx.lbr(lb_u + cmass) > ctx.budget + 1e-9) {
            if (ctx.prof) t_sec = ec_now();
            ascend_undo(ctx, umark);
            if (ctx.prof) ctx.cyc_undo += ec_now() - t_sec;
            return false;
        }
    }
    // Sibling-exclusion branching: the branches at this node partition the
    // qualifying completions by the first TRIED candidate they contain, so
    // a candidate whose branch was refuted — or skipped by a "no
    // qualifying completion contains i" Lagrangian argument — is banned
    // for the remaining siblings' subtrees (released on exit).  Bans also
    // feed the ascent: a banned column's slack no longer caps its rows'
    // multipliers, so sibling bounds tighten as the loop advances.
    std::vector<int32_t> bans_here;
    bool found = false;
    // Dominance banning on the branch row's candidates, restricted to the
    // UNCOVERED set: if a non-banned candidate j with c_j <= c_i covers a
    // superset of i's uncovered rows ((mask_i & U & ~mask_j) == 0), any
    // qualifying completion containing i maps to one containing j of <=
    // cost (swap i -> j; rows outside U are covered by the chosen set
    // already) — the same completion-preserving argument as the other
    // bans, so i is banned for this whole node.  Deep in the tree U
    // shrinks and candidates collapse onto each other, so this fires
    // hardest exactly where the plain tree explodes.  Only candidates of
    // the branch row can dominate (a dominator must cover r_pick in U),
    // so the pairwise check over by_row[r_pick] loses nothing.  Candidate
    // lists are cost-sorted: compare each i against earlier non-banned j
    // only (ties broken toward the earlier index).  Gated to small
    // uncovered sets: on wide-open nodes random coverage supersets are
    // vanishingly rare (measured 0 bans on scpnre probes) and the pairwise
    // scan is pure overhead.
    if (ctx.prof) t_sec = ec_now();
    if (n_unc <= ctx.dom_limit) {
        const auto& cand = (*ctx.by_row)[static_cast<size_t>(r_pick)];
        const size_t kc = cand.size();
        for (size_t a = 1; a < kc; ++a) {
            const int32_t i = cand[a];
            if (ctx.banned[static_cast<size_t>(i)]) continue;
            const uint64_t* mi = ctx.masks + static_cast<size_t>(i) * ctx.nwords;
            for (size_t bidx = 0; bidx < a; ++bidx) {
                const int32_t j = cand[bidx];
                if (ctx.banned[static_cast<size_t>(j)]) continue;
                ++ctx.n_dom_pairs;
                const uint64_t* mj = ctx.masks + static_cast<size_t>(j) * ctx.nwords;
                bool subset = true;
                for (int64_t w = 0; w < ctx.nwords; ++w) {
                    const uint64_t u =
                        ctx.full[w] & ~cov[static_cast<size_t>(w)];
                    if (mi[w] & u & ~mj[w]) { subset = false; break; }
                }
                if (subset) {
                    ban_col(ctx, i);
                    bans_here.push_back(i);
                    break;
                }
            }
        }
    }
    if (ctx.prof) { uint64_t t2 = ec_now(); ctx.cyc_dom += t2 - t_sec; }
    for (int32_t i : (*ctx.by_row)[static_cast<size_t>(r_pick)]) {
        if (ctx.banned[static_cast<size_t>(i)]) continue;
        if (cost + ctx.costs[i] > ctx.budget + 1e-9) break;  // cost-sorted
        // picking i leaves uncovered U' with dual weight >= lb_dual -
        // (y-coverage of i) and the completion pays rc_i on top, so ANY
        // qualifying completion containing i costs > budget: ban it
        if (cost + ctx.lbr(lb_dual + ctx.rc[i]) > ctx.budget + 1e-9) {
            ban_col(ctx, i);
            bans_here.push_back(i);
            continue;
        }
        // dynamic variant with the ascended multipliers: the completion
        // through i pays its (conservatively tracked) reduced cost on top
        // of the uncovered u-mass + residual cut mass (redc already
        // deducts w.a_i and the residual counts i's own contribution, so
        // no per-candidate rho adjustment is needed — see ctx comment)
        if (ctx.ascend &&
            cost + ctx.lbr(lb_u + cmass +
                           ctx.redc_eff[static_cast<size_t>(i)]) >
                ctx.budget + 1e-9) {
            ban_col(ctx, i);
            bans_here.push_back(i);
            continue;
        }
        // pool preallocated to nrows+1 depths (each chosen column covers
        // >= 1 new row, so depth <= nrows); resizing here would dangle the
        // cov references held by ancestor frames
        if (ctx.prof) t_sec = ec_now();
        std::vector<uint64_t>& cov2 = ctx.cov_pool[static_cast<size_t>(depth)];
        for (int64_t w = 0; w < ctx.nwords; ++w)
            cov2[static_cast<size_t>(w)] =
                cov[static_cast<size_t>(w)] |
                ctx.masks[static_cast<size_t>(i) * ctx.nwords + w];
        double rho_save[16];
        if (ctx.ncuts) {
            for (int64_t c2 = 0; c2 < ctx.ncuts; ++c2) {
                rho_save[c2] = ctx.rho[c2];
                ctx.rho[c2] -=
                    ctx.ca[static_cast<size_t>(c2) *
                               static_cast<size_t>(ctx.kcols) +
                           static_cast<size_t>(i)];
            }
        }
        const size_t cmark = ctx.ulog.size();
        if (ctx.ascend) {
            // rows newly covered by i: zero their multipliers, returning
            // the mass to their candidates' slack for the child's ascent
            for (int64_t w = 0; w < ctx.nwords; ++w) {
                uint64_t newly =
                    ctx.masks[static_cast<size_t>(i) * ctx.nwords + w] &
                    ctx.full[w] & ~cov[static_cast<size_t>(w)];
                while (newly) {
                    const int bit = __builtin_ctzll(newly);
                    newly &= newly - 1;
                    const int32_t rr = static_cast<int32_t>((w << 6) + bit);
                    const double ur = ctx.u[static_cast<size_t>(rr)];
                    if (ur != 0.0) dual_apply(ctx, rr, -ur);
                }
            }
        }
        ctx.chosen.push_back(i);
        if (ctx.prof) ctx.cyc_child += ec_now() - t_sec;
        const bool child_found =
            exact_cover_dfs(ctx, cov2, cost + ctx.costs[i], depth + 1);
        if (ctx.ncuts)
            for (int64_t c2 = 0; c2 < ctx.ncuts; ++c2)
                ctx.rho[c2] = rho_save[c2];
        if (child_found) {
            found = true;
            break;
        }
        ctx.chosen.pop_back();
        if (ctx.prof) t_sec = ec_now();
        ascend_undo(ctx, cmark);
        if (ctx.prof) ctx.cyc_undo += ec_now() - t_sec;
        if (ctx.timed_out) break;
        // branch refuted: no qualifying completion contains i
        ban_col(ctx, i);
        bans_here.push_back(i);
        // the ban may tighten this node's own bound: re-ascend the rows
        // the ban released (rows(i) only — see ascend_after_ban) and
        // re-check before the next sibling
        if (ctx.ascend) {
            if (ctx.prof) t_sec = ec_now();
            lb_u = ascend_after_ban(ctx, cov, lb_u, i);
            if (ctx.prof) ctx.cyc_ban_asc += ec_now() - t_sec;
            if (lb_u >= 1e299 ||
                cost + ctx.lbr(lb_u + cmass) > ctx.budget + 1e-9)
                break;
        }
    }
    for (int32_t i : bans_here) unban_col(ctx, i);
    ascend_undo(ctx, umark);
    return found;
}

int exact_cover_impl(
    const uint64_t* col_masks, int64_t nwords,
    const double* costs, const uint8_t* active, int64_t ncols,
    const int64_t* col_ptr, const int32_t* col_idx, int64_t nrows,
    double budget, double deadline_sec, const double* row_dual,
    uint8_t* out_sel,
    const double* cut_w, const double* cut_coef, const double* cut_rhs,
    int64_t nc) {
    std::vector<int32_t> act;
    for (int64_t j = 0; j < ncols; ++j)
        if (active[j]) act.push_back(static_cast<int32_t>(j));
    if (act.empty()) return 0;
    std::sort(act.begin(), act.end(), [&](int32_t a, int32_t b) {
        if (costs[a] != costs[b]) return costs[a] < costs[b];
        return a < b;
    });
    const size_t k = act.size();
    std::vector<double> c(k);
    std::vector<uint64_t> m(k * static_cast<size_t>(nwords));
    for (size_t i = 0; i < k; ++i) {
        c[i] = costs[act[i]];
        for (int64_t w = 0; w < nwords; ++w)
            m[i * static_cast<size_t>(nwords) + static_cast<size_t>(w)] =
                col_masks[static_cast<size_t>(act[i]) * static_cast<size_t>(nwords) +
                          static_cast<size_t>(w)];
    }
    std::vector<std::vector<int32_t>> by_row(static_cast<size_t>(nrows));
    for (size_t i = 0; i < k; ++i) {
        const int32_t j = act[i];
        for (int64_t p = col_ptr[j]; p < col_ptr[j + 1]; ++p)
            by_row[static_cast<size_t>(col_idx[p])].push_back(
                static_cast<int32_t>(i));
    }
    std::vector<double> spread(static_cast<size_t>(nrows));
    std::vector<double> row_min(static_cast<size_t>(nrows));
    std::vector<int32_t> n_cands(static_cast<size_t>(nrows));
    for (int64_t r = 0; r < nrows; ++r) {
        if (by_row[static_cast<size_t>(r)].empty()) return 0;  // uncoverable
        double sp = 1e300, mn = 1e300;
        for (int32_t i : by_row[static_cast<size_t>(r)]) {
            const int32_t j = act[static_cast<size_t>(i)];
            const int64_t deg = col_ptr[j + 1] - col_ptr[j];
            const double s = c[static_cast<size_t>(i)] /
                             static_cast<double>(deg > 0 ? deg : 1);
            if (s < sp) sp = s;
            if (c[static_cast<size_t>(i)] < mn) mn = c[static_cast<size_t>(i)];
        }
        spread[static_cast<size_t>(r)] = sp;
        row_min[static_cast<size_t>(r)] = mn;
        n_cands[static_cast<size_t>(r)] =
            static_cast<int32_t>(by_row[static_cast<size_t>(r)].size());
    }
    std::vector<uint64_t> full(static_cast<size_t>(nwords), 0);
    for (int64_t r = 0; r < nrows; ++r)
        full[static_cast<size_t>(r >> 6)] |= (1ULL << (r & 63));

    // LP-dual (Lagrangian) bound.  With y_r = max(0, row_dual[r]) and
    // rc_i = c_i - sum_{r in rows(i)} y_r, any cover x extending a partial
    // cover S whose every added column covers >= 1 then-uncovered row (true
    // of all DFS completions) satisfies
    //   c(x) - c(S) >= sum_{r in U} (y_r + neg_rc),  neg_rc = min(0, min rc)
    // because |x\S| <= |U| and each y_r of U is paid at least once.  This is
    // the depth-cumulative form of reduced-cost fixing: every chosen column
    // with positive reduced cost eats the duality gap, which is what makes
    // plateau faces (budget = LP bound + ~1 integer unit) refutable.  The
    // reference has no counterpart (its enumeration is the B&B itself); the
    // bound is the CFT-style Lagrangian bound specialised to fixed duals.
    std::vector<double> rcv(k, 0.0), dualw(static_cast<size_t>(nrows), 0.0);
    std::vector<double> u0, redc0;
    std::vector<double> cav, cwv, rhov;
    int64_t nce = 0;
    double neg_rc = 0.0;
    bool ascend = false;
    if (row_dual != nullptr) {
        std::vector<double> y(static_cast<size_t>(nrows), 0.0);
        for (int64_t r = 0; r < nrows; ++r) {
            const double v = row_dual[r];
            y[static_cast<size_t>(r)] = (v > 0.0 && v < 1e300) ? v : 0.0;
        }
        std::vector<double> ysum(k, 0.0);
        for (size_t i = 0; i < k; ++i) {
            const int32_t j = act[i];
            double ys = 0.0;
            for (int64_t p = col_ptr[j]; p < col_ptr[j + 1]; ++p)
                ys += y[static_cast<size_t>(col_idx[p])];
            ysum[i] = ys;
            rcv[i] = c[i] - ys;
            if (rcv[i] < neg_rc) neg_rc = rcv[i];
        }
        for (int64_t r = 0; r < nrows; ++r)
            dualw[static_cast<size_t>(r)] = y[static_cast<size_t>(r)] + neg_rc;
        // --- static cut-row Lagrangian setup (see ExactCoverCtx comment) ---
        // Gather each cut's coefficients in sorted-active order BEFORE the
        // feasibility scaling so (y, w) scale JOINTLY.  With duals taken
        // from the cut-strengthened LP optimum, c_i - y.rows(i) - w.a_i is
        // >= -IPM_tol for every active column, so one joint theta stays at
        // ~(1 - 1e-6) and the full cut-LP mass survives.  The previous
        // two-stage scheme (theta on y, then phi on w against the already
        // shaved redc) collapsed phi to ~0 whenever a cut touched an
        // LP-basic column (redc ~ 0 with w.a_i > 0) — measured net-neutral
        // for exactly that reason.  Negative coefficients (objective-cover
        // cuts) never constrain theta upward and contribute no mass once
        // the residual rhs goes nonpositive — harmless by construction.
        std::vector<double> wa(k, 0.0);
        if (nc > 0 && cut_w && cut_coef && cut_rhs) {
            for (int64_t c2 = 0; c2 < nc && nce < 16; ++c2) {
                const double w = cut_w[c2];
                if (!(w > 1e-12) || w > 1e300) continue;
                cwv.push_back(w);
                rhov.push_back(cut_rhs[c2]);
                for (size_t i = 0; i < k; ++i)
                    cav.push_back(
                        cut_coef[static_cast<size_t>(c2) *
                                     static_cast<size_t>(ncols) +
                                 static_cast<size_t>(act[i])]);
                ++nce;
            }
            for (int64_t c2 = 0; c2 < nce; ++c2)
                for (size_t i = 0; i < k; ++i) {
                    const double a =
                        cav[static_cast<size_t>(c2) * k + i];
                    if (a > 0.0)
                        wa[i] += cwv[static_cast<size_t>(c2)] * a;
                }
        }
        // feasible starting multipliers for the per-node dual ascent:
        // u0 = theta*y, w = theta*w_raw with
        // theta = min_i c_i / (y-coverage + positive cut-coverage of i),
        // so every initial reduced cost c_i - theta*(ysum_i + wa_i) >= 0
        // and the ascent only ever raises u while keeping redc >= 0.
        // Negative cut coefficients are EXCLUDED from the deduction (a
        // completion through i only gains residual-rhs mass from them),
        // keeping redc a conservative underestimate.
        double theta = 1.0;
        for (size_t i = 0; i < k; ++i) {
            const double load = ysum[i] + wa[i];
            if (load > 1e-12 && c[i] / load < theta) theta = c[i] / load;
        }
        if (theta < 0.0) theta = 0.0;
        u0.assign(static_cast<size_t>(nrows), 0.0);
        for (int64_t r = 0; r < nrows; ++r)
            u0[static_cast<size_t>(r)] = theta * y[static_cast<size_t>(r)];
        for (int64_t c2 = 0; c2 < nce; ++c2)
            cwv[static_cast<size_t>(c2)] *= theta;
        redc0.resize(k);
        for (size_t i = 0; i < k; ++i) {
            redc0[i] = c[i] - theta * (ysum[i] + wa[i]);
            if (redc0[i] < 0.0) redc0[i] = 0.0;  // numerical guard
        }
        ascend = true;
    }

    ExactCoverCtx ctx;
    ctx.full = full.data();
    ctx.nwords = nwords;
    ctx.costs = c.data();
    ctx.masks = m.data();
    ctx.by_row = &by_row;
    ctx.spread = spread.data();
    ctx.row_min = row_min.data();
    ctx.n_cands = n_cands.data();
    ctx.dualw = dualw.data();
    ctx.rc = rcv.data();
    ctx.ascend = ascend;
    ctx.banned.assign(k, 0);
    if (ascend) {
        ctx.redc0 = std::move(redc0);
        ctx.redc_eff = ctx.redc0;
        ctx.u0sum.resize(k);
        for (size_t i = 0; i < k; ++i) {
            const uint64_t* mi = m.data() + i * static_cast<size_t>(nwords);
            double s = 0.0;
            for (int64_t w = 0; w < nwords; ++w) {
                uint64_t mm = mi[w];
                while (mm) {
                    const int bit = __builtin_ctzll(mm);
                    mm &= mm - 1;
                    s += u0[static_cast<size_t>((w << 6) + bit)];
                }
            }
            ctx.u0sum[i] = s;
        }
        ctx.u = std::move(u0);
        ctx.witness.assign(static_cast<size_t>(nrows), -1);
        ctx.ulog.reserve(1024);
    }
    ctx.ncuts = nce;
    ctx.kcols = static_cast<int64_t>(k);
    ctx.cw = cwv.data();
    ctx.ca = cav.data();
    for (int64_t c2 = 0; c2 < nce; ++c2)
        ctx.rho[c2] = rhov[static_cast<size_t>(c2)];
    ctx.budget = budget;
    ctx.cov_pool.assign(
        static_cast<size_t>(nrows) + 1,
        std::vector<uint64_t>(static_cast<size_t>(nwords), 0));
    if (const char* sw = std::getenv("SYPHA_EC_SWEEPS")) {
        const int v = std::atoi(sw);
        if (v >= 1 && v <= 16) ctx.node_sweeps = v;
    }
    if (const char* dl = std::getenv("SYPHA_EC_DOM")) {
        ctx.dom_limit = std::atoi(dl);
    }
    ctx.dual_eps = 1e-7 * (budget > 1.0 ? budget : 1.0);
    ctx.costs_integral = true;
    for (size_t i = 0; i < k; ++i) {
        if (std::fabs(c[i] - std::round(c[i])) > 1e-9) {
            ctx.costs_integral = false;
            break;
        }
    }
    ctx.deadline = std::chrono::steady_clock::now() +
                   std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                       std::chrono::duration<double>(deadline_sec));
    std::vector<uint64_t> cov(static_cast<size_t>(nwords), 0);
    if (ascend) {
        // Iterated probe-budget reduced-cost filtering.  Ascend u at the
        // root to saturation and drop every column whose Lagrangian
        // completion bound already exceeds the budget: for any cover x
        // whose columns all satisfy redc_i >= 0,
        //   c(x) >= sum_r u_r + redc_i   for every i in x,
        // so a column with sum(u) + redc_i > budget is in NO cover of cost
        // <= budget and can be removed from every candidate list.  Removal
        // makes the NEXT ascent strictly stronger (minima over fewer
        // slacks), so iterate to a fixpoint.  Root mass above the budget,
        // or a row left with no candidates, refutes the probe outright.
        // This is the probe-budget analogue of the driver's
        // incumbent-budget reduced-cost fixing, applied inside the engine
        // where it also sharpens every in-tree ascent and shrinks every
        // DFS candidate loop.
        const bool ec_stats = std::getenv("SYPHA_EC_STATS") != nullptr;
        const char* probe_env = std::getenv("SYPHA_EC_PROBE");
        const bool strong_probe = !(probe_env && probe_env[0] == '0');
        std::vector<uint8_t> dead(k, 0);
        const double cm0 = ctx.ncuts ? ctx.cut_mass() : 0.0;
        for (int round = 0; round < 32; ++round) {
            double lb_u = 0.0;
            for (int64_t r = 0; r < nrows; ++r)
                lb_u += ctx.u[static_cast<size_t>(r)];
            lb_u = ascend_pass(ctx, cov, lb_u, 16);
            if (ctx.lbr(lb_u + cm0) > budget + 1e-9) return 0;  // refuted
            int dropped = 0;
            if (ec_stats)
                std::fprintf(stderr, "[ec] round %d lb_u=%.6f cm=%.6f\n",
                             round, lb_u, cm0);
            for (size_t i = 0; i < k; ++i) {
                if (dead[i]) continue;
                if (ctx.lbr(lb_u + cm0 + ctx.redc_eff[i]) > budget + 1e-9) {
                    dead[i] = 1;
                    ++dropped;
                }
            }
            // Strong probing: for each survivor i, tentatively CHOOSE i —
            // zero the multipliers of i's rows (returning their mass to the
            // candidates' slack) and RE-ASCEND over the remaining rows.  Any
            // cover containing i costs >= c_i + the re-ascended mass, and
            // reallocation makes that strictly stronger than the static
            // lb_u + redc_i test above (which never moves the freed mass).
            // Probes are undone via the ulog, so the baseline u is intact.
            // Cut mass is omitted inside probes (rho would shift with i):
            // dropping a nonnegative term keeps the bound admissible.
            if (strong_probe) {
                std::vector<uint64_t> pcov(static_cast<size_t>(nwords));
                int iprobe = 0;
                for (size_t i = 0; i < k; ++i) {
                    if (dead[i]) continue;
                    if ((++iprobe & 63) == 0 &&
                        std::chrono::steady_clock::now() >= ctx.deadline)
                        break;
                    const uint64_t* mi =
                        ctx.masks + i * static_cast<size_t>(nwords);
                    for (int64_t w = 0; w < nwords; ++w)
                        pcov[static_cast<size_t>(w)] = mi[w];
                    const size_t pmark = ctx.ulog.size();
                    double lb_i = lb_u;
                    for (int64_t w = 0; w < nwords; ++w) {
                        uint64_t hit = mi[w] & full[static_cast<size_t>(w)];
                        while (hit) {
                            const int bit = __builtin_ctzll(hit);
                            hit &= hit - 1;
                            const int32_t rr =
                                static_cast<int32_t>((w << 6) + bit);
                            const double ur = ctx.u[static_cast<size_t>(rr)];
                            if (ur != 0.0) {
                                dual_apply(ctx, rr, -ur);
                                lb_i -= ur;
                            }
                        }
                    }
                    lb_i = ascend_pass(ctx, pcov, lb_i, 2);
                    ascend_undo(ctx, pmark);
                    if (ctx.lbr(c[i] + lb_i) > budget + 1e-9) {
                        dead[i] = 1;
                        ++dropped;
                    }
                }
            }
            if (ec_stats)
                std::fprintf(stderr, "[ec] round %d dropped=%d\n", round, dropped);
            if (dropped == 0) break;
            for (int64_t r = 0; r < nrows; ++r) {
                auto& lst = by_row[static_cast<size_t>(r)];
                lst.erase(std::remove_if(lst.begin(), lst.end(),
                                         [&](int32_t i) {
                                             return dead[static_cast<size_t>(i)] != 0;
                                         }),
                          lst.end());
                if (lst.empty()) return 0;  // row uncoverable within budget
            }
        }
        // the filtered lists change the per-row branching/bound statistics
        for (int64_t r = 0; r < nrows; ++r) {
            double sp = 1e300, mn = 1e300;
            for (int32_t i : by_row[static_cast<size_t>(r)]) {
                const int32_t j = act[static_cast<size_t>(i)];
                const int64_t deg = col_ptr[j + 1] - col_ptr[j];
                const double s = c[static_cast<size_t>(i)] /
                                 static_cast<double>(deg > 0 ? deg : 1);
                if (s < sp) sp = s;
                if (c[static_cast<size_t>(i)] < mn) mn = c[static_cast<size_t>(i)];
            }
            spread[static_cast<size_t>(r)] = sp;
            row_min[static_cast<size_t>(r)] = mn;
            n_cands[static_cast<size_t>(r)] =
                static_cast<int32_t>(by_row[static_cast<size_t>(r)].size());
        }
        // the ascended u is the DFS root baseline, never undone
        ctx.ulog.clear();
    }
    // after the probe filter has rebuilt by_row/n_cands: seed the live
    // (non-banned) per-row candidate counts the DFS maintains via bans
    ctx.live_cands.assign(n_cands.begin(), n_cands.end());
    ctx.prof = std::getenv("SYPHA_EC_PROF") != nullptr;
    const bool found = exact_cover_dfs(ctx, cov, 0.0, 0);
    if (std::getenv("SYPHA_EC_STATS") != nullptr)
        std::fprintf(stderr,
                     "[ec] dfs calls=%lld scan_rows=%lld asc_visits=%lld "
                     "apply=%lld dom_pairs=%lld\n",
                     static_cast<long long>(ctx.calls),
                     static_cast<long long>(ctx.n_scan_rows),
                     static_cast<long long>(ctx.n_asc_visits),
                     static_cast<long long>(ctx.n_apply),
                     static_cast<long long>(ctx.n_dom_pairs));
    if (ctx.prof) {
        const double tot = static_cast<double>(
            ctx.cyc_scan + ctx.cyc_asc + ctx.cyc_ban_asc + ctx.cyc_dom +
            ctx.cyc_child + ctx.cyc_undo);
        std::fprintf(stderr,
                     "[ec] prof cycles: scan=%.1f%% asc=%.1f%% ban_asc=%.1f%% "
                     "dom=%.1f%% child=%.1f%% undo=%.1f%% (total %.3g)\n",
                     100.0 * ctx.cyc_scan / tot, 100.0 * ctx.cyc_asc / tot,
                     100.0 * ctx.cyc_ban_asc / tot, 100.0 * ctx.cyc_dom / tot,
                     100.0 * ctx.cyc_child / tot, 100.0 * ctx.cyc_undo / tot,
                     tot);
    }
    if (found) {
        std::fill(out_sel, out_sel + ncols, 0);
        for (int32_t i : ctx.chosen) out_sel[act[static_cast<size_t>(i)]] = 1;
        return 1;
    }
    return ctx.timed_out ? -1 : 0;
}

}  // namespace

extern "C" int sypha_exact_cover(
    const uint64_t* col_masks, int64_t nwords,
    const double* costs, const uint8_t* active, int64_t ncols,
    const int64_t* col_ptr, const int32_t* col_idx, int64_t nrows,
    double budget, double deadline_sec, const double* row_dual,
    uint8_t* out_sel) {
    return exact_cover_impl(col_masks, nwords, costs, active, ncols,
                            col_ptr, col_idx, nrows, budget, deadline_sec,
                            row_dual, out_sel, nullptr, nullptr, nullptr, 0);
}

// Cut-armed variant: cut_coef is [nc x ncols] dense (input column order),
// cut_w the LP duals of the cut rows, cut_rhs their >=-form right-hand
// sides.  Cuts must be valid for every cover the probe budget admits
// (global CG cuts always; objective-cover cuts for budgets <= incumbent-1,
// which is every probe the driver issues).
extern "C" int sypha_exact_cover_cuts(
    const uint64_t* col_masks, int64_t nwords,
    const double* costs, const uint8_t* active, int64_t ncols,
    const int64_t* col_ptr, const int32_t* col_idx, int64_t nrows,
    double budget, double deadline_sec, const double* row_dual,
    uint8_t* out_sel,
    const double* cut_w, const double* cut_coef, const double* cut_rhs,
    int64_t nc) {
    return exact_cover_impl(col_masks, nwords, costs, active, ncols,
                            col_ptr, col_idx, nrows, budget, deadline_sec,
                            row_dual, out_sel, cut_w, cut_coef, cut_rhs, nc);
}
