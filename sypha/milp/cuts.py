"""Chvátal-Gomory cut separation.

Vectorised rewrite of the reference separators (src/sypha_solver_cuts.cpp):
DualAggregatedCgSeparator (:18-93) and RowPairCgSeparator (:100-216).
Cuts append as relaxation rows via BaseModel.add_cuts (the standard-form
slack column appears automatically when the padded LP is built), replacing
append_cuts_to_base_model's CSR surgery (:228-264).
"""

from __future__ import annotations

from typing import List

import numpy as np

from sypha.milp.base_model import BaseModel, Cut


def _cg_round(agg: np.ndarray, rhs_sum: float, x: np.ndarray, tol: float):
    """CG rounding + violation check shared by the separators.  Returns a
    Cut or None.

    Soundness (learned the hard way): for a >=-aggregation the LHS
    coefficients must round EXACTLY up — ``ceil(agg - tol)`` turns a
    coefficient of k+4e-7 (dual noise) into k, which UNDER-counts the LHS
    and once produced a cut violated by scp44's optimal cover ("proving"
    495 where the optimum is 494).  Only the RHS may take the -tol slack:
    there it merely weakens the cut.  Callers snap their aggregation
    weights to a coarse grid first so float fuzz does not needlessly push
    coefficients to the next integer."""
    f0 = rhs_sum - np.floor(rhs_sum)
    if f0 < tol or f0 > 1.0 - tol:
        return None
    cut_rhs = np.ceil(rhs_sum - tol)
    if cut_rhs <= tol:
        return None
    rounded = np.ceil(agg)
    keep = rounded > tol
    if not keep.any():
        return None
    lhs = rounded[keep] @ x[keep]
    if lhs >= cut_rhs - tol:
        return None
    return Cut(
        indices=np.flatnonzero(keep).astype(np.int32),
        values=rounded[keep],
        rhs=float(cut_rhs),
    )


def _snap(u: np.ndarray, digits: int = 9) -> np.ndarray:
    """Snap aggregation weights to a coarse decimal grid.  Any u >= 0 is a
    valid CG aggregation, so snapping is free; it keeps float fuzz from
    pushing exact-integer aggregation coefficients over the next integer
    (which the now-exact ceil would honor, weakening the cut)."""
    return np.maximum(0.0, np.round(u, digits))


def dual_aggregated_cg(
    model: BaseModel, x: np.ndarray, dual: np.ndarray, tol: float
) -> List[Cut]:
    """Aggregate all rows with positive duals, CG-round, keep if violated
    (reference :18-93)."""
    A, rhs = model.rel_csr()
    nrows = A.shape[0]
    u = _snap(np.maximum(0.0, dual[:nrows]))
    u[u < tol] = 0.0
    if not u.any():
        return []
    agg = A.T @ u
    rhs_sum = float(u @ rhs)
    cut = _cg_round(agg, rhs_sum, x[: model.ncols], tol)
    if cut is None:
        return []
    cut.kind = "cg_dual_aggregated"
    return [cut]


def row_pair_cg(
    model: BaseModel,
    x: np.ndarray,
    dual: np.ndarray,
    tol: float,
    max_rows: int = 40,
    max_cuts: int = 30,
) -> List[Cut]:
    """All pairs among the top-``max_rows`` rows by dual value, CG-rounded,
    at most ``max_cuts`` cuts (reference :100-216)."""
    A, rhs = model.rel_csr()
    nrows = A.shape[0]
    d = dual[:nrows]
    active_rows = np.flatnonzero(d > tol)
    if len(active_rows) < 2:
        return []
    active_rows = active_rows[np.argsort(-d[active_rows], kind="stable")][:max_rows]

    xs = x[: model.ncols]
    cuts: List[Cut] = []
    dense_rows = {i: np.asarray(A[i].todense()).ravel() for i in active_rows}
    for ri in range(len(active_rows)):
        for rj in range(ri + 1, len(active_rows)):
            i1, i2 = int(active_rows[ri]), int(active_rows[rj])
            u1, u2 = float(_snap(np.asarray([d[i1]]))[0]), float(_snap(np.asarray([d[i2]]))[0])
            rhs_agg = u1 * rhs[i1] + u2 * rhs[i2]
            agg = u1 * dense_rows[i1] + u2 * dense_rows[i2]
            cut = _cg_round(agg, rhs_agg, xs, tol)
            if cut is not None:
                cut.kind = "cg_row_pair"
                cuts.append(cut)
                if len(cuts) >= max_cuts:
                    return cuts
    return cuts


def row_triple_zero_half(
    model: BaseModel,
    x: np.ndarray,
    dual: np.ndarray,
    tol: float,
    max_rows: int = 24,
    max_cuts: int = 30,
) -> List[Cut]:
    """{0,1/2}-Chvátal cuts over row triples: aggregate 3 covering rows with
    weight 1/2 (rhs 3/2 -> 2, coefficients ceil(count/2)) and keep violated
    ones.  Extends the reference's pair separator to the odd-subset case
    that weight-1/2 rounding actually strengthens (no reference
    counterpart; targets the 0.5-heavy LP plateaus of SCP)."""
    A, rhs = model.rel_csr()
    nrows_cover = model.nrows_cover  # only unit-rhs covering rows
    d = dual[:nrows_cover] if len(dual) >= nrows_cover else np.zeros(nrows_cover)
    active_rows = np.flatnonzero(d > tol)
    if len(active_rows) < 3:
        return []
    active_rows = active_rows[np.argsort(-d[active_rows], kind="stable")][:max_rows]
    xs = x[: model.ncols]
    dense = {int(i): np.asarray(A[int(i)].todense()).ravel() for i in active_rows}

    cuts: List[Cut] = []
    n_act = len(active_rows)
    for a in range(n_act):
        for b in range(a + 1, n_act):
            ab = dense[int(active_rows[a])] + dense[int(active_rows[b])]
            for c_ in range(b + 1, n_act):
                agg = 0.5 * (ab + dense[int(active_rows[c_])])
                cut = _cg_round(agg, 1.5, xs, tol)
                if cut is not None:
                    cut.kind = "cg_zero_half_triple"
                    cuts.append(cut)
                    if len(cuts) >= max_cuts:
                        return cuts
    return cuts


def zero_half_mod2(
    model: BaseModel,
    x: np.ndarray,
    dual: np.ndarray,
    tol: float,
    max_cuts: int = 30,
    max_rows: int = 512,
    max_cols: int = 4096,
) -> List[Cut]:
    """General {0,1/2}-Chvátal (zerohalf) separation via mod-2 elimination.

    For ANY odd-size subset R of integer >=-rows, the weight-1/2 CG cut
    ``sum_j ceil((sum_{i in R} a_ij)/2) x_j >= ceil(sum_{i in R} b_i / 2)``
    is violated at the LP point x* by exactly
    ``(1 - S_R - sum_{j: parity_j odd} x*_j) / 2`` where ``S_R`` is the
    total row slack over R and parity_j = sum_{i in R} a_ij mod 2.
    Separation therefore reduces to finding an odd row combination of
    small slack+odd-mass weight in GF(2) — the Caprara–Fischetti '96
    problem (SCIP's sepa_zerohalf is the production analogue; the
    reference has no counterpart, its separators stop at row pairs,
    src/sypha_solver_cuts.cpp:100-216).  This subsumes the triple
    enumerator below: any odd |R|, guided by Gaussian elimination that
    cancels the heaviest fractional columns first, instead of
    exhaustive enumeration of |R|=3.

    Soundness: candidates from the elimination are only *guides* — every
    emitted cut is rebuilt from the ORIGINAL rows of R and passes through
    :func:`_cg_round`'s exact-ceil rounding and violation check, so the
    scp44 lesson (exact LHS ceil, RHS-only tolerance) is inherited.
    """
    A, rhs = model.rel_csr()
    nrows = A.shape[0]
    xs = np.clip(x[: model.ncols], 0.0, None)

    # -- candidate rows: integer rows whose slack leaves room for violation
    slack = np.asarray(A @ xs).ravel() - rhs
    rows_ok = slack < 1.0 - tol
    # only rows with (near-)integer coefficients and rhs participate in the
    # parity argument; covering rows are 0/1 and CG cut rows are integer by
    # construction, but guard anyway (objective-cover rows are -1s: fine).
    rhs_int = np.abs(rhs - np.round(rhs)) < 1e-9
    cand_rows = np.flatnonzero(rows_ok & rhs_int)
    if len(cand_rows) < 3:
        return []
    if len(cand_rows) > max_rows:
        cand_rows = cand_rows[np.argsort(slack[cand_rows], kind="stable")[:max_rows]]
    mR = len(cand_rows)

    Asub = A[cand_rows]
    data_round = np.round(Asub.data)
    if np.abs(Asub.data - data_round).max(initial=0.0) > 1e-9:
        return []  # non-integer coefficients somewhere; stay out
    # -- candidate columns for the parity weight: fractional support only.
    frac_cols = np.flatnonzero(xs > 1e-4)
    if len(frac_cols) == 0:
        return []
    if len(frac_cols) > max_cols:
        frac_cols = frac_cols[np.argsort(-xs[frac_cols], kind="stable")[:max_cols]]
    # order columns by decreasing x*: the elimination cancels heavy ones first
    frac_cols = frac_cols[np.argsort(-xs[frac_cols], kind="stable")]
    nC = len(frac_cols)
    xw = xs[frac_cols]

    # -- packed GF(2) incidence over (cand_rows, frac_cols)
    import scipy.sparse

    Modd = Asub[:, frac_cols].tocoo()
    parity = (np.round(Modd.data).astype(np.int64) & 1).astype(bool)
    words = (nC + 63) // 64
    M = np.zeros((mR, words), dtype=np.uint64)
    rr, cc = Modd.row[parity], Modd.col[parity]
    np.bitwise_xor.at(M, (rr, cc // 64), np.uint64(1) << (cc % 64).astype(np.uint64))

    cwords = (mR + 63) // 64
    comb = np.zeros((mR, cwords), dtype=np.uint64)
    comb[np.arange(mR), np.arange(mR) // 64] = np.uint64(1) << (
        np.arange(mR) % 64
    ).astype(np.uint64)
    rhsp = (np.round(rhs[cand_rows]).astype(np.int64) & 1).astype(np.uint8)
    slackw = slack[cand_rows].copy()  # additive proxy (>= exact S_R)

    def row_mass(rows_idx: np.ndarray) -> np.ndarray:
        """Sum of x* over set bits, per row (exact over frac_cols)."""
        bits = np.unpackbits(
            M[rows_idx].view(np.uint8), axis=1, bitorder="little", count=nC
        )
        return bits @ xw

    alive = np.ones(mR, dtype=bool)
    for c in range(min(nC, mR)):
        w, b = c // 64, np.uint64(c % 64)
        has = alive & (((M[:, w] >> b) & np.uint64(1)).astype(bool))
        idx = np.flatnonzero(has)
        if len(idx) == 0:
            continue
        proxy = slackw[idx] + row_mass(idx)
        p = idx[int(np.argmin(proxy))]
        rest = idx[idx != p]
        if len(rest):
            M[rest] ^= M[p]
            comb[rest] ^= comb[p]
            slackw[rest] += slackw[p]
            rhsp[rest] ^= rhsp[p]
        alive[p] = False

    # -- greedy XOR descent (min-weight odd codeword search).  The
    # elimination above guides structured instances, but on uniform
    # fractional points (unicost clr: every x* ~ obj/n) the violated sets
    # are low-weight codewords of the tight-row GF(2) row space — found by
    # hill-climbing: from each seed, repeatedly XOR in the single original
    # row that most reduces slack + odd-column mass, using
    # mass(v^r) = mass(v) + mass(r) - 2*mass(v&r) with mass(v&r) for ALL
    # rows at once as one (mR x nC) matmul.
    M0 = np.zeros((mR, words), dtype=np.uint64)  # pristine row parities
    np.bitwise_xor.at(
        M0, (rr, cc // 64), np.uint64(1) << (cc % 64).astype(np.uint64)
    )
    Mf = np.unpackbits(
        M0.view(np.uint8), axis=1, bitorder="little", count=nC
    ).astype(np.float32)
    xv = xw.astype(np.float32)
    rmass = Mf @ xv
    slack0 = slack[cand_rows].astype(np.float32)

    def climb(v_bits, comb_bits, n_steps=24):
        vb = np.unpackbits(
            v_bits.view(np.uint8), bitorder="little", count=nC
        ).astype(np.float32)
        cur_mass = float(vb @ xv)
        in_comb = np.unpackbits(
            comb_bits.view(np.uint8), bitorder="little", count=mR
        ).astype(bool)
        cur_slack = float(slack0[in_comb].sum())
        for _ in range(n_steps):
            inter = Mf @ (xv * vb)
            sdelta = np.where(in_comb, -slack0, slack0)
            tot = (rmass - 2.0 * inter) + sdelta
            r = int(np.argmin(tot))
            if tot[r] >= -1e-9:
                break
            v_bits = v_bits ^ M0[r]
            comb_bits = comb_bits.copy()
            comb_bits[r // 64] ^= np.uint64(1) << np.uint64(r % 64)
            in_comb = in_comb.copy()
            in_comb[r] = ~in_comb[r]
            cur_mass += float(rmass[r] - 2.0 * inter[r])
            cur_slack += float(sdelta[r])
            vb = np.unpackbits(
                v_bits.view(np.uint8), bitorder="little", count=nC
            ).astype(np.float32)
        return v_bits, comb_bits, in_comb, cur_mass, cur_slack

    # -- gather candidates: elimination output + hill-climbed seeds
    cand_list = []  # (proxy_weight, comb_bitset)
    odd = np.flatnonzero(rhsp == 1)
    if len(odd):
        proxy = slackw[odd] + row_mass(odd)
        for pos in np.argsort(proxy, kind="stable")[: 4 * max_cuts]:
            if slackw[odd[pos]] < 1.0:
                cand_list.append((float(proxy[pos]), comb[odd[pos]].copy()))
    n_seeds = min(16, mR)
    seed_rows = np.argsort(slack0, kind="stable")[:n_seeds]
    seeds = [(M0[r].copy(), _unit_bits(r, cwords)) for r in seed_rows]
    # the best eliminated rows are seeds too (restart from a good basin)
    for _, cb in cand_list[:8]:
        bits = np.unpackbits(cb.view(np.uint8), bitorder="little", count=mR)
        v = np.bitwise_xor.reduce(M0[bits.astype(bool)], axis=0) if bits.any() else np.zeros(words, np.uint64)
        seeds.append((v, cb.copy()))
    rhsp0 = (np.round(rhs[cand_rows]).astype(np.int64) & 1).astype(np.uint8)
    for v0, c0 in seeds:
        v1, c1, in_c, mass1, slack1 = climb(v0, c0)
        if int(rhsp0[in_c].sum()) % 2 == 0:
            # force odd parity with the cheapest single-row flip
            vb = np.unpackbits(
                v1.view(np.uint8), bitorder="little", count=nC
            ).astype(np.float32)
            inter = Mf @ (xv * vb)
            sdelta = np.where(in_c, -slack0, slack0)
            tot = (rmass - 2.0 * inter) + sdelta
            tot[rhsp0 == 0] = np.inf  # flipping an even-rhs row keeps parity
            r = int(np.argmin(tot))
            if not np.isfinite(tot[r]):
                continue
            v1 = v1 ^ M0[r]
            c1 = c1.copy()
            c1[r // 64] ^= np.uint64(1) << np.uint64(r % 64)
            mass1 += float(rmass[r] - 2.0 * inter[r])
            slack1 += float(sdelta[r])
        if mass1 + slack1 < 1.0 - tol:
            cand_list.append((mass1 + slack1, c1))

    if not cand_list:
        return []
    cand_list.sort(key=lambda t: t[0])
    Acsr = A.tocsr()
    cuts: List[Cut] = []
    seen: set = set()
    for _, comb_bits in cand_list[: 6 * max_cuts]:
        bits = np.unpackbits(
            comb_bits.view(np.uint8), bitorder="little", count=mR
        ).astype(bool)
        R = cand_rows[bits]
        if len(R) < 3 or int(np.round(rhs[R].sum())) % 2 == 0:
            continue
        key = tuple(R.tolist())
        if key in seen:
            continue
        seen.add(key)
        agg = 0.5 * np.asarray(Acsr[R].sum(axis=0)).ravel()
        rhs_sum = 0.5 * float(rhs[R].sum())
        cut = _cg_round(agg, rhs_sum, xs, tol)
        if cut is not None:
            cut.kind = "cg_zero_half_mod2"
            cuts.append(cut)
            if len(cuts) >= max_cuts:
                break
    return cuts


def _unit_bits(r: int, nwords: int) -> np.ndarray:
    out = np.zeros(nwords, dtype=np.uint64)
    out[r // 64] = np.uint64(1) << np.uint64(r % 64)
    return out


def mod_k_cuts(
    model: BaseModel,
    x: np.ndarray,
    dual: np.ndarray,
    tol: float,
    k: int = 3,
    max_cuts: int = 30,
    max_rows: int = 768,
    max_cols: int = 1024,
) -> List[Cut]:
    """Mod-k Chvátal cuts (k prime) via GF(k) elimination.

    Generalizes the zerohalf family: for integer multipliers
    ``t_i in {0..k-1}`` over integer >=-rows, the weight-(t/k) CG cut has
    violation ``[((-T) mod k) - sum_i t_i s_i - sum_j d_j x*_j] / k``
    where ``T = sum t_i b_i``, ``d_j = (-sum_i t_i a_ij) mod k`` and
    ``s_i`` the row slacks.  For k=3 the headroom is 2 (vs zerohalf's 1),
    which matters on the dense nrg/nrh instances whose LP spreads small
    fractional mass over hundreds of columns — the mod-2 deficit budget
    is exhausted by 3-4 columns while mod-3 tolerates twice the mass.
    Separation: dense GF(k) Gaussian elimination over the tight-row x
    fractional-column residue matrix, cancelling the heaviest columns
    first, tracking multiplier vectors; every candidate (and its k-1
    scalar multiples) is rebuilt exactly from the original rows through
    :func:`_cg_round` (exact-ceil soundness inherited).  No reference
    counterpart (its separators stop at row pairs,
    src/sypha_solver_cuts.cpp:100-216).
    """
    A, rhs = model.rel_csr()
    xs = np.clip(x[: model.ncols], 0.0, None)
    slack = np.asarray(A @ xs).ravel() - rhs
    rhs_int = np.abs(rhs - np.round(rhs)) < 1e-9
    cand_rows = np.flatnonzero((slack < float(k) - 1.0 + 0.5) & rhs_int)
    if len(cand_rows) < 2:
        return []
    if len(cand_rows) > max_rows:
        cand_rows = cand_rows[np.argsort(slack[cand_rows], kind="stable")[:max_rows]]
    mR = len(cand_rows)
    Asub = A[cand_rows]
    if np.abs(Asub.data - np.round(Asub.data)).max(initial=0.0) > 1e-9:
        return []
    frac_cols = np.flatnonzero(xs > 1e-4)
    if len(frac_cols) == 0:
        return []
    if len(frac_cols) > max_cols:
        frac_cols = frac_cols[np.argsort(-xs[frac_cols], kind="stable")[:max_cols]]
    frac_cols = frac_cols[np.argsort(-xs[frac_cols], kind="stable")]
    nC = len(frac_cols)
    xw = xs[frac_cols]

    M = np.mod(
        np.round(np.asarray(Asub[:, frac_cols].todense())).astype(np.int64), k
    ).astype(np.int16)
    comb = np.zeros((mR, mR), dtype=np.int16)
    np.fill_diagonal(comb, 1)
    bmod = np.mod(np.round(rhs[cand_rows]).astype(np.int64), k).astype(np.int16)
    slack0 = slack[cand_rows].copy()
    swp = slack0.copy()  # additive slack proxy (>= the mod-reduced exact)
    inv = {a: pow(a, -1, k) for a in range(1, k)}

    # deficit proxy per row: additive multiplier-slack + d_j-weighted mass
    def proxy_of(rows_idx: np.ndarray) -> np.ndarray:
        d = np.mod(-M[rows_idx], k).astype(np.float64)
        return swp[rows_idx] + d @ xw

    alive = np.ones(mR, dtype=bool)
    for c in range(min(nC, mR)):
        idx = np.flatnonzero(alive & (M[:, c] != 0))
        if len(idx) == 0:
            continue
        p = idx[int(np.argmin(proxy_of(idx)))]
        s = int(inv[int(M[p, c])])  # scale so the pivot entry becomes 1
        Mp = np.mod(M[p] * s, k)
        combp = np.mod(comb[p] * s, k)
        swp_p = swp[p] * s
        rest = idx[idx != p]
        if len(rest):
            f = M[rest, c][:, None].astype(np.int32)
            M[rest] = np.mod(M[rest] - f * Mp[None, :], k).astype(np.int16)
            comb[rest] = np.mod(
                comb[rest] - f * combp[None, :], k
            ).astype(np.int16)
            bmod[rest] = np.mod(bmod[rest] - f.ravel() * bmod[p], k).astype(
                np.int16
            )
            swp[rest] += f.ravel() * swp_p
        alive[p] = False

    # rank candidates by exact-form proxy; T mod k != 0 required
    # ---- candidate pool: every eliminated row, its scalar multiples, and
    # pairwise combinations of the most promising rows.  The violation of
    # multiplier vector t is estimated EXACTLY over the fractional support:
    #   est = [((-T) mod k) - t.slack - d(t).x*] / k
    # (columns with x* <= 1e-4 contribute at most n*1e-4 of optimism; the
    # final _cg_round check is fully exact anyway).
    def screen(Mrows: np.ndarray, sl: np.ndarray, bm: np.ndarray) -> np.ndarray:
        d = np.mod(-Mrows, k).astype(np.float64)
        head = np.mod(-bm, k).astype(np.float64)
        bad = bm == 0
        est = (head - sl - d @ xw) / float(k)
        est[bad] = -np.inf
        return est

    slack_t = comb.astype(np.float64) @ slack0
    pool_M = [M]
    pool_comb = [comb]
    pool_sl = [slack_t]
    pool_bm = [bmod]
    # pairwise expansion among the top rows by slack+mass
    P = min(64, mR)
    base_rank = np.argsort(slack_t + np.mod(-M, k).astype(np.float64) @ xw)[:P]
    MA, CA = M[base_rank], comb[base_rank]
    for mult in range(1, k):
        MP = np.mod(MA[:, None, :] + mult * MA[None, :, :], k)
        CP = np.mod(CA[:, None, :] + mult * CA[None, :, :], k)
        iu = np.triu_indices(P, 1)
        MP = MP[iu].astype(np.int16)
        CP = CP[iu].astype(np.int16)
        pool_M.append(MP)
        pool_comb.append(CP)
        pool_sl.append(CP.astype(np.float64) @ slack0)
        pool_bm.append(
            np.mod(bmod[base_rank][:, None] + mult * bmod[base_rank][None, :], k)[iu]
        )
    allM = np.concatenate(pool_M)
    allC = np.concatenate(pool_comb)
    allS = np.concatenate(pool_sl)
    allB = np.concatenate(pool_bm)

    ests = []
    for mult in range(1, k):
        ests.append(
            screen(np.mod(allM * mult, k), allS * mult, np.mod(allB * mult, k))
        )
    est = np.stack(ests)  # (k-1, ncand)
    best_mult = np.argmax(est, axis=0)
    best_est = est[best_mult, np.arange(est.shape[1])]
    order = np.argsort(-best_est, kind="stable")

    Acsr = A.tocsr()
    cuts: List[Cut] = []
    seen: set = set()
    for i in order[: 8 * max_cuts]:
        if best_est[i] <= tol:
            break
        mult = int(best_mult[i]) + 1
        t = np.mod(allC[i].astype(np.int64) * mult, k)
        nz = np.flatnonzero(t)
        if len(nz) == 0:
            continue
        key = tuple(t[nz].tolist()) + tuple(nz.tolist())
        if key in seen:
            continue
        seen.add(key)
        T = float(t[nz] @ rhs[cand_rows[nz]])
        if round(T) % k == 0:
            continue
        w = np.zeros(A.shape[0])
        w[cand_rows[nz]] = t[nz]
        agg = (Acsr.T @ w) / float(k)
        cut = _cg_round(agg, T / float(k), xs, tol)
        if cut is not None:
            cut.kind = f"cg_mod{k}"
            cuts.append(cut)
        if len(cuts) >= max_cuts:
            break
    return cuts


def objective_cover_cuts(
    model: BaseModel,
    x: np.ndarray,
    incumbent: float,
    tol: float,
    max_cuts: int = 8,
) -> List[Cut]:
    """Cover cuts from the objective budget (no reference counterpart).

    With integral costs and incumbent U, every IMPROVING solution obeys
    the knapsack c.x <= U-1; any column set C with sum(c_C) > U-1 yields
    the cover inequality sum_C x_j <= |C|-1, encoded as the >=-row
    -sum_C x_j >= 1-|C|.  Like the incumbent-driven column reductions,
    these cuts are valid for solutions strictly better than U — exactly
    the solutions the B&B searches for — and remain valid as U decreases.
    Candidates come from the fractional LP point: prefixes of columns
    sorted by x* (ties: cost) accumulate cost past the budget; the cut is
    kept when x* violates it.  Targets the last-integer-unit plateaus
    (scp48-class) where the LP bound sits ~1 unit under the optimum."""
    if not np.isfinite(incumbent):
        return []
    budget = np.floor(incumbent) - 1.0
    xs = np.clip(x[: model.ncols], 0.0, 1.0)
    act = np.flatnonzero(model.active & (xs > tol))
    if len(act) < 2:
        return []
    cuts: List[Cut] = []
    for order in (
        # largest x* first (cover needs x*_C ~ 1), expensive tie-break so
        # the budget is exceeded with the fewest columns
        act[np.lexsort((-model.costs[act], -np.round(xs[act], 6)))],
        # largest cost contribution first
        act[np.argsort(-(xs[act] * model.costs[act]), kind="stable")],
    ):
        csum = np.cumsum(model.costs[order])
        k = int(np.searchsorted(csum, budget + 0.5)) + 1
        if k < 2 or k > len(order):
            continue
        C = order[:k]
        if float(model.costs[C].sum()) <= budget + tol:
            continue
        if float(xs[C].sum()) <= k - 1 + tol:
            continue  # not violated by the LP point
        cuts.append(
            Cut(
                indices=np.sort(C).astype(np.int32),
                values=-np.ones(k),
                rhs=float(1 - k),
                kind="objective_cover",
            )
        )
        if len(cuts) >= max_cuts:
            break
    return cuts


def separate_cuts(
    model: BaseModel,
    x: np.ndarray,
    dual: np.ndarray,
    tol: float = 1e-6,
    max_cuts: int = 50,
    incumbent: float = np.inf,
    obj_is_integral: bool = False,
) -> List[Cut]:
    """Run all separators in reference order, capped at max_cuts per round
    (reference makeCutSeparators :220-226 + driver cap logic), plus the
    zero-half triple and objective-cover separators."""
    cuts = dual_aggregated_cg(model, x, dual, tol)
    if len(cuts) < max_cuts:
        cuts += row_pair_cg(model, x, dual, tol)
    if len(cuts) < max_cuts:
        cuts += zero_half_mod2(model, x, dual, tol)
    if len(cuts) < max_cuts:
        cuts += mod_k_cuts(model, x, dual, tol, k=3)
    if len(cuts) < max_cuts:
        cuts += row_triple_zero_half(model, x, dual, tol)
    if len(cuts) < max_cuts and obj_is_integral:
        cuts += objective_cover_cuts(model, x, incumbent, tol)
    return cuts[:max_cuts]
