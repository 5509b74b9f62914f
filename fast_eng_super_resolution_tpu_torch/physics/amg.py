"""Smoothed-aggregation AMG preconditioner for the divergence-free projection.

Port of the JAX package's ``physics/amg.py`` (the analogue of the
reference's pyamg smoothed aggregation, dataset/GraphDataset.py:1852-1877).

- The HOST build is scipy, copied: the composite operator A = sum_d G_d G_d
  assembled exactly from the LSQ stencils, the SPD normal operator
  N = A^T A, and a smoothed-aggregation hierarchy on N (strength-filtered
  MIS aggregation, Jacobi-smoothed prolongation, Galerkin coarse operators,
  a dense pinv at the coarsest level).  ``build_hierarchy`` returns numpy
  level dicts with the JAX package's keys, so the two builds compare array
  for array.
- ``levels_from_arrays`` moves a hierarchy (the port's, or the JAX
  package's through ``np.asarray``) to the device, adding the transposed
  tables that make the restriction P^T r a gather: the members of each
  aggregate at an implicit level, P^T in padded ELL form at an explicit
  one.  No step of the V-cycle scatters, so no float atomics run.
- ``make_vcycle`` applies the Chebyshev-smoothed V-cycle on the device, a
  fixed linear operator V ~ N^{-1} (zero initial guess).  The JAX
  package's ``split_levels`` and ``make_vcycle_fn`` exist to pass the level
  arrays as jit arguments; in torch the arrays are plain tensors, so
  ``make_vcycle`` takes the finest-level operator ``matvec0`` directly.
"""

from __future__ import annotations

import numpy as np
import torch


def assemble_composite(nbr, mask, weights):
    """The composite projection operator A = sum_d G_d G_d (scipy CSR)
    from the LSQ weight stencils: (G_d p)_i = sum_k w[i,d,k] (p_j - p_i).
    Exactly ``make_consistent_matvec``'s trace-mode operator."""
    import scipy.sparse as sp

    W = np.asarray(weights, np.float64)      # [N, 3, K]
    nbr = np.asarray(nbr)
    mask = np.asarray(mask, bool)
    n, _, K = W.shape
    r = np.repeat(np.arange(n), K)[mask.ravel()]
    c = nbr[mask]
    A = None
    for d in range(3):
        wd = W[:, d, :]
        Gd = (sp.coo_matrix((wd[mask], (r, c)), shape=(n, n)).tocsr()
              + sp.diags(-wd.sum(1)))
        A = Gd @ Gd if A is None else A + Gd @ Gd
    return A.tocsr()


def drop_small(M, tol: float):
    """Row-relative drop tolerance (keep |m_ij| >= tol * row max and the
    diagonal): bounds the normal operator's fill for the preconditioner
    build; the CG operator itself stays the exact composite matvec."""
    import scipy.sparse as sp

    M = M.tocoo()
    rmax = np.zeros(M.shape[0])
    np.maximum.at(rmax, M.row, np.abs(M.data))
    keep = (np.abs(M.data) >= tol * rmax[M.row]) | (M.row == M.col)
    return sp.coo_matrix((M.data[keep], (M.row[keep], M.col[keep])),
                         shape=M.shape).tocsr()


def assemble_normal(nbr, mask, weights, a_drop: float = 0.02):
    """N = A^T A (SPD, scipy CSR), the operator CGNR inverts.  Rows with a
    zero diagonal become identity rows so the hierarchy build stays
    nonsingular."""
    import scipy.sparse as sp

    A = drop_small(assemble_composite(nbr, mask, weights), a_drop)
    N = (A.T @ A).tocsr()
    d0 = np.asarray(N.diagonal())
    fix = d0 <= 1e-12
    if fix.any():
        N = N + sp.diags(np.where(fix, 1.0, 0.0))
    return N.tocsr()


def _aggregate_csr(S, rng: np.random.Generator) -> tuple[np.ndarray, int]:
    """Vectorized MIS-style aggregation on a strength graph (scipy CSR):
    random-priority seeds, two strongest-seed attachment sweeps, singleton
    stragglers.  Returns (agg [n], n_agg)."""
    n = S.shape[0]
    coo = S.tocoo()
    rows, cols, vals = coo.row, coo.col, np.abs(coo.data)
    keep = rows != cols
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    pri = rng.random(n)
    nb_max = np.zeros(n)
    np.maximum.at(nb_max, rows, pri[cols])
    seeds = pri >= nb_max          # no-neighbour nodes trivially seed
    agg = np.full(n, -1, np.int64)
    seed_ids = np.cumsum(seeds) - 1
    agg[seeds] = seed_ids[seeds]

    for _ in range(2):             # attach to the strongest assigned neighbour
        open_e = (agg[rows] < 0) & (agg[cols] >= 0)
        if not open_e.any():
            break
        r_e, s_e = rows[open_e], vals[open_e]
        best = np.zeros(n)
        np.maximum.at(best, r_e, s_e)
        pick = open_e.copy()
        pick[open_e] = s_e >= best[r_e] - 1e-30
        # later writes win ties: any strongest-neighbour choice is fine
        agg[rows[pick]] = agg[cols[pick]]

    left = agg < 0
    if left.any():
        agg[left] = int(seeds.sum()) + np.arange(int(left.sum()))
    uniq, agg = np.unique(agg, return_inverse=True)
    return agg.astype(np.int64), len(uniq)


def _strength_filter(L, theta: float):
    """Symmetric strength-of-connection graph: keep |l_ij| >=
    theta * sqrt(|l_ii l_jj|) (pyamg's symmetric strength measure)."""
    import scipy.sparse as sp

    coo = L.tocoo()
    d = np.abs(np.asarray(L.diagonal()))
    s = np.abs(coo.data) / np.sqrt(np.maximum(d[coo.row] * d[coo.col],
                                              1e-30))
    keep = (s >= theta) & (coo.row != coo.col)
    return sp.coo_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])),
                         shape=L.shape).tocsr()


def _lambda_max_csr(L, iters: int = 25) -> float:
    """Power-iteration estimate of lambda_max(D^{-1} L)."""
    n = L.shape[0]
    dinv = 1.0 / np.maximum(np.abs(np.asarray(L.diagonal())), 1e-30)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n)
    lam = 1.0
    for _ in range(iters):
        y = dinv * (L @ x)
        lam = np.linalg.norm(y)
        x = y / max(lam, 1e-30)
    return float(max(lam * 1.05, 1e-12))  # 5% safety margin


def _to_ell(M, keep_frac: float = 0.999):
    """CSR -> padded ELL (cols [n, E] int32, vals [n, E] float32):
    ``(M x)_i = sum_e vals[i, e] * x[cols[i, e]]`` is a gather and a
    reduce.  Rows beyond the ``keep_frac`` row-length quantile keep only
    their largest-magnitude entries (a preconditioner tolerance).  Padding
    slots point at the row itself with value 0."""
    M = M.tocsr()
    n = M.shape[0]
    lens = np.diff(M.indptr)
    E = max(int(np.quantile(lens, keep_frac)) if n else 1, 1)
    idx, dat = M.indices.copy(), M.data.copy()
    for i in np.nonzero(lens > E)[0]:   # few rows; reorder largest-first
        seg = slice(M.indptr[i], M.indptr[i + 1])
        order = np.argsort(-np.abs(dat[seg]))
        idx[seg], dat[seg] = idx[seg][order], dat[seg][order]
    take = np.minimum(lens, E)
    rr = np.repeat(np.arange(n), take)
    cc = np.arange(int(take.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(take)[:-1]]), take)
    src = np.repeat(M.indptr[:-1], take) + cc
    cols = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, E))
    vals = np.zeros((n, E))
    cols[rr, cc] = idx[src]
    vals[rr, cc] = dat[src]
    return cols.astype(np.int32), vals.astype(np.float32)


def _level_arrays(L, P, lam_max: float) -> dict:
    """One explicit level as numpy arrays: the operator and the
    prolongation in ELL form, and P's entries (COO) for the restriction."""
    l_cols, l_vals = _to_ell(L)
    p_cols, p_vals = _to_ell(P, keep_frac=1.0)   # P is exact, never capped
    pc = P.tocoo()
    return {
        "cols": l_cols, "vals": l_vals,
        "diag": np.asarray(L.diagonal(), np.float32),
        "p_cols": p_cols, "p_vals": p_vals,
        "pt_rows": pc.row.astype(np.int32),
        "pt_cols": pc.col.astype(np.int32),
        "pt_vals": pc.data.astype(np.float32),
        "n": int(L.shape[0]), "nc": int(P.shape[1]),
        "lam_max": float(lam_max),
    }


def build_hierarchy(L, max_levels: int = 12, coarse_size: int = 800,
                    theta: float = 0.08, seed: int = 0,
                    implicit_level0: bool = False):
    """Smoothed-aggregation setup (pyamg's algorithm, scipy).

    Per level: strength filter -> MIS aggregation -> tentative P ->
    Jacobi-smoothed P = (I - (4/3 lam) D^{-1} L) P_tent -> Galerkin
    L_c = P^T L P.  Returns (levels, coarse_inv): numpy level dicts (see
    ``_level_arrays``) and the dense pinv of the coarsest operator.

    ``implicit_level0=True`` stores no finest-level matrix: the V-cycle gets
    the level-0 operator as a callable (the projection passes the exact
    composite pair), and applies the smoothed P through it
    (P xc = t - w D^{-1} L t, t the tentative gather).
    """
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    L = L.tocsr()
    levels = []
    while L.shape[0] > coarse_size and len(levels) < max_levels:
        n = L.shape[0]
        S = _strength_filter(L, theta)
        agg, nc = _aggregate_csr(S, rng)
        if nc >= n:    # aggregation stalled (pathological graph)
            break
        lam = _lambda_max_csr(L)
        P_tent = sp.coo_matrix((np.ones(n), (np.arange(n), agg)),
                               shape=(n, nc)).tocsr()
        dinv = sp.diags(1.0 / np.maximum(np.abs(np.asarray(L.diagonal())),
                                         1e-30))
        w = 4.0 / (3.0 * lam)
        P = P_tent - w * (dinv @ (L @ P_tent))
        if implicit_level0 and not levels:
            levels.append({
                "agg": agg.astype(np.int32),
                "diag": np.asarray(L.diagonal(), np.float32),
                "n": int(n), "nc": int(nc),
                "lam_max": float(lam), "w": float(w),
            })
        else:
            levels.append(_level_arrays(L, P, lam))
        L = (P.T @ L @ P).tocsr()
        L.eliminate_zeros()
    # rcond 1e-6: the operator is applied in f32 and N is singular (constant
    # null space); the default cutoff would invert f64 assembly noise into
    # directions the f32 matvec cannot represent
    coarse_inv = np.linalg.pinv(L.toarray(), rcond=1e-6).astype(np.float32)
    return levels, coarse_inv


def _padded_rows(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 n_rows: int):
    """Entries (rows, cols, vals) grouped by row into padded [n_rows, E]
    tables (cols, vals), in ascending (row, col) order; padding has col 0
    and value 0."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=n_rows)
    e = max(int(counts.max()) if n_rows else 0, 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(rows)) - starts[rows]
    out_c = np.zeros((n_rows, e), np.int64)
    out_v = np.zeros((n_rows, e), np.float32)
    out_c[rows, pos] = cols
    out_v[rows, pos] = vals
    return out_c, out_v


def levels_from_arrays(levels, coarse_inv, device):
    """A hierarchy of numpy arrays (``build_hierarchy``'s, or the JAX
    package's levels through ``np.asarray``) as device tensors, each level
    with the table that makes its restriction a gather: ``members`` and
    ``member_w`` (each aggregate's nodes) at an implicit level, ``rt_cols``
    and ``rt_vals`` (P^T in padded ELL form) at an explicit one.
    Returns (levels, coarse_inv)."""
    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    out = []
    for lv in levels:
        n, nc = int(lv["n"]), int(lv["nc"])
        d = {"n": n, "nc": nc, "lam_max": float(lv["lam_max"]),
             "diag": t(lv["diag"], torch.float32)}
        if "agg" in lv:
            agg = np.asarray(lv["agg"], np.int64)
            members, member_w = _padded_rows(
                agg, np.arange(n), np.ones(n, np.float32), nc)
            d.update(agg=t(agg, torch.long), w=float(lv["w"]),
                     members=t(members, torch.long),
                     member_w=t(member_w, torch.float32))
        else:
            rt_cols, rt_vals = _padded_rows(
                np.asarray(lv["pt_cols"], np.int64),
                np.asarray(lv["pt_rows"], np.int64),
                np.asarray(lv["pt_vals"], np.float32), nc)
            d.update(cols=t(lv["cols"], torch.long),
                     vals=t(lv["vals"], torch.float32),
                     # P's padding slots point at their own (fine) row,
                     # past nc: clamped, as JAX's gather clamps them
                     p_cols=t(np.minimum(lv["p_cols"], nc - 1), torch.long),
                     p_vals=t(lv["p_vals"], torch.float32),
                     rt_cols=t(rt_cols, torch.long),
                     rt_vals=t(rt_vals, torch.float32))
        out.append(d)
    return out, t(coarse_inv, torch.float32)


def make_vcycle(levels, coarse_inv, cheb_degree: int = 2,
                smooth_band: float = 8.0, matvec0=None):
    """The V-cycle V ~ L^{-1} as a fixed linear operator r -> x on the
    device: Chebyshev smoothing on D^{-1}L over [lam_max / smooth_band,
    lam_max] (zero initial guess), gathered restriction and prolongation,
    the dense solve at the coarsest level.  ``levels`` and ``coarse_inv``
    come from ``levels_from_arrays``; ``matvec0`` is the finest operator,
    required when level 0 is implicit."""
    return lambda r: _cycle_impl(levels, coarse_inv, r, cheb_degree,
                                 smooth_band, matvec0)


def _cycle_impl(levels, coarse_inv, r0, cheb_degree: int,
                smooth_band: float, matvec0=None):
    def matvec(lv, x):
        if "agg" in lv:    # implicit finest level: the exact operator
            return matvec0(x)
        return (lv["vals"] * x[lv["cols"]]).sum(1)        # ELL gather

    def restrict(lv, r):   # P^T r
        if "agg" in lv:
            # P^T = P_tent^T (I - w L D^{-1})  (L symmetric)
            t = r - lv["w"] * matvec0(r / lv["diag"])
            return (lv["member_w"] * t[lv["members"]]).sum(1)
        return (lv["rt_vals"] * r[lv["rt_cols"]]).sum(1)

    def prolong(lv, xc):   # P xc
        if "agg" in lv:
            t = xc[lv["agg"]]
            return t - lv["w"] * (matvec0(t) / lv["diag"])
        return (lv["p_vals"] * xc[lv["p_cols"]]).sum(1)

    def chebyshev(lv, b):
        # Saad Alg. 12.1 on the D^{-1}-preconditioned operator, x0 = 0
        lmax = lv["lam_max"]
        lmin = lmax / smooth_band
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        dinv = 1.0 / lv["diag"]
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        x = (dinv * b) / theta
        d = x
        for _ in range(cheb_degree - 1):
            r = b - matvec(lv, x)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * (dinv * r)
            x = x + d
            rho = rho_new
        return x

    def cycle(li, r):
        if li == len(levels):
            return (coarse_inv * r).sum(1)
        lv = levels[li]
        x = chebyshev(lv, r)
        rc = restrict(lv, r - matvec(lv, x))
        x = x + prolong(lv, cycle(li + 1, rc))
        x = x + chebyshev(lv, r - matvec(lv, x))
        return x

    return cycle(0, r0)


def symmetrize(vcycle):
    """M = (V + V^T) / 2, V^T through ``torch.func.vjp`` (V is linear): an
    exactly symmetric wrapper for CG.  Doubles the cost per application and
    is not on the projection's path (which applies V directly); its
    backward scatters, so on the card its bits may differ between runs."""
    def M(r):
        _, vjp = torch.func.vjp(vcycle, r)
        return 0.5 * (vcycle(r) + vjp(r)[0])

    return M
