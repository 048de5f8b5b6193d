"""Smoothed-aggregation AMG for P1 operators — the scalable h1amg stand-in.

The reference leans on NGSolve's ``h1amg`` for its auxiliary-space coarse
level (/root/reference/templates/NavierStokesSIMPLE_iterative.py:122,310-357).
Round 1 substituted an exact DENSE P1 inverse — O(nv^2) memory and apply,
fine at tens of thousands of vertices, disqualifying at the meshes one
accelerator holds.  This module is the scalable replacement:

* setup (host, scipy.sparse): greedy strength-based aggregation, tentative
  piecewise-constant prolongation, Jacobi-smoothed P, Galerkin coarse
  operators, recursing until the coarsest level is small enough for a
  dense inverse — memory O(nnz) = O(nv);
* apply (device): a symmetric V-cycle with degree-2 Chebyshev smoothing.
  Every level's operator and prolongation is stored in padded ELL form, so
  an SpMV is one gather + one row-wise einsum — fixed shapes, no CSR
  pointer chasing, exactly the layout SURVEY.md section 7 prescribes for
  sparse work on an accelerator.

The V-cycle with matched pre/post Chebyshev smoothing is symmetric and
positive definite, as the Bramble-Pasciak solvers require.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp


def _ell(A: sp.spmatrix, dtype=jnp.float64):
    """Padded ELL tables (idx (n, w), val (n, w)) of a csr matrix.

    Fully vectorized (no per-row Python loop): setup is O(nnz) numpy work,
    so AMG construction stays cheap exactly at the >5000-dof scales where
    it is selected."""
    A = A.tocsr()
    n = A.shape[0]
    counts = np.diff(A.indptr)
    width = max(int(counts.max()) if n else 1, 1)
    # int32 indices: halves the gather-index stream (row counts stay far
    # below 2^31; jnp gathers accept i32 under x64)
    idx = np.zeros((n, width), dtype=np.int32)
    val = np.zeros((n, width))
    rows = np.repeat(np.arange(n), counts)
    slots = np.arange(A.nnz) - np.repeat(A.indptr[:-1], counts)
    idx[rows, slots] = A.indices
    val[rows, slots] = A.data
    return jnp.asarray(idx), jnp.asarray(val, dtype)


def _ell_apply(idx, val, x):
    return jnp.einsum("nw,nw->n", val, x[idx])


def _aggregate(A: sp.csr_matrix) -> np.ndarray:
    """Strength-based aggregation; returns aggregate id per row.

    Fully vectorized: pass 1 seeds aggregates by
    Luby-style rounds — a vertex seeds when its random priority beats every
    other still-candidate vertex within distance 2 of the strong graph
    (seeds' closed neighborhoods stay pairwise disjoint, the same invariant
    the former per-vertex greedy walk maintained), each round two
    ``np.minimum.at`` edge reductions.  Expected O(log n) rounds
    independent of vertex numbering, O(nnz) numpy per round."""
    n = A.shape[0]
    d = np.sqrt(np.maximum(A.diagonal(), 1e-300))
    # strong neighbors: |a_ij| >= theta sqrt(a_ii a_jj), vectorized over nnz
    theta = 0.08
    coo = A.tocoo()
    strong = (coo.row != coo.col) & (
        np.abs(coo.data) >= theta * d[coo.row] * d[coo.col]
    )
    srow, scol = coo.row[strong], coo.col[strong]
    sdata = np.abs(coo.data[strong])
    agg = -np.ones(n, dtype=np.int64)
    n_agg = 0
    # pass 1: deterministic random priorities (seeded) so the aggregation
    # is reproducible yet round-count is O(log n) even on meshes numbered
    # along lines (index-priority rounds degrade to O(n) there)
    prio = np.random.default_rng(0).permutation(n).astype(np.float64)
    INF = np.float64(np.inf)
    has_nbr_assigned = np.zeros(n, bool)
    for _round in range(10000):
        cand = (agg < 0) & ~has_nbr_assigned
        if not cand.any():
            break
        v = np.where(cand, prio, INF)
        # closed-1-neighborhood min of v, then closed-2 via a second pass
        m1 = v.copy()
        np.minimum.at(m1, srow, v[scol])
        m2 = v.copy()
        np.minimum.at(m2, srow, m1[scol])
        win = cand & (m2 == prio)
        seeds = np.where(win)[0]
        agg[seeds] = n_agg + np.arange(len(seeds))
        n_agg += len(seeds)
        # members: strong neighbors of new seeds (first writer wins on the
        # rare two-seed-adjacent-member race — seeds are 2-separated so a
        # member touches at most one seed's closed neighborhood... except
        # ties across rounds; resolve by only writing unassigned slots)
        member_edge = win[srow] & (agg[scol] < 0)
        agg[scol[member_edge]] = agg[srow[member_edge]]
        np.logical_or.at(has_nbr_assigned, srow, agg[scol] >= 0)
    # pass 2 (vectorized): attach each leftover to its strongest strong
    # neighbor among the pass-1 aggregates; remaining isolates become
    # singletons.  (The round-2 serial version let a leftover attach to
    # aggregates formed earlier IN pass 2; restricting to pass-1
    # aggregates changes only which of several valid aggregations is
    # produced.)
    left = agg < 0
    if left.any():
        edge_ok = left[srow] & (agg[scol] >= 0)
        er, ev, ec = srow[edge_ok], sdata[edge_ok], scol[edge_ok]
        best_w = np.zeros(n)
        np.maximum.at(best_w, er, ev)
        # pick an edge achieving the per-row max
        hit = ev >= best_w[er] * (1.0 - 1e-12)
        agg_best = -np.ones(n, dtype=np.int64)
        agg_best[er[hit]] = agg[ec[hit]]
        attach = left & (agg_best >= 0)
        agg[attach] = agg_best[attach]
        isolates = np.where(agg < 0)[0]
        agg[isolates] = n_agg + np.arange(len(isolates))
    return agg


@dataclass
class _Level:
    A_idx: jnp.ndarray
    A_val: jnp.ndarray
    P_idx: jnp.ndarray  # prolongation rows (fine)
    P_val: jnp.ndarray
    R_idx: jnp.ndarray  # restriction rows (coarse)
    R_val: jnp.ndarray
    diag_inv: jnp.ndarray
    lam_max: float


def build_sa_amg(K: sp.spmatrix, free: np.ndarray, dtype=jnp.float64,
                 coarse_size: int = 600, max_levels: int = 6,
                 omega: float = 0.66, cheb_degree: int = 2):
    """Symmetric SA-AMG V-cycle preconditioner for ``K`` on the free dofs.

    Returns apply(r) -> z acting on full-length vectors (zero on
    constrained dofs).  Memory is O(nnz) across levels.
    """
    free_idx = np.where(free)[0]
    n0 = K.shape[0]
    A = K.tocsr()[free_idx][:, free_idx].tocsr()
    levels: list[_Level] = []
    while A.shape[0] > coarse_size and len(levels) < max_levels:
        agg = _aggregate(A)
        n_agg = int(agg.max()) + 1
        P_t = sp.csr_matrix(
            (np.ones(A.shape[0]), (np.arange(A.shape[0]), agg)),
            shape=(A.shape[0], n_agg),
        )
        Dinv = sp.diags(1.0 / np.maximum(A.diagonal(), 1e-300))
        # smoothed prolongation: (I - omega D^-1 A) P_t
        lam = _power_lam(A, Dinv)
        P = (sp.eye(A.shape[0]) - (omega / lam) * (Dinv @ A)) @ P_t
        P = P.tocsr()
        A_c = (P.T @ A @ P).tocsr()
        Ai, Av = _ell(A, dtype)
        Pi, Pv = _ell(P, dtype)
        Ri, Rv = _ell(P.T.tocsr(), dtype)
        levels.append(
            _Level(
                Ai, Av, Pi, Pv, Ri, Rv,
                jnp.asarray(1.0 / np.maximum(A.diagonal(), 1e-300), dtype),
                float(lam),
            )
        )
        A = A_c
    coarse_inv = jnp.asarray(
        np.linalg.inv(A.todense() + 1e-30 * np.eye(A.shape[0])), dtype
    )

    free_j = jnp.asarray(free_idx)

    def cheb_smooth(lv: _Level, r, z):
        """Degree-``cheb_degree`` Chebyshev iteration on D^-1 A targeting
        [0.3, 1.1] * lam_max (symmetric: the same fixed polynomial in
        D^-1 A pre and post, so the V-cycle stays SPD)."""
        lo, hi = 0.3 * lv.lam_max, 1.1 * lv.lam_max
        theta, delta = 0.5 * (hi + lo), 0.5 * (hi - lo)
        sigma1 = theta / delta
        res = r - _ell_apply(lv.A_idx, lv.A_val, z)
        d = lv.diag_inv * res / theta
        z = z + d
        rho_old = 1.0 / sigma1
        for _ in range(cheb_degree - 1):
            rho = 1.0 / (2.0 * sigma1 - rho_old)
            res = r - _ell_apply(lv.A_idx, lv.A_val, z)
            d = rho * rho_old * d + (2.0 * rho / delta) * (lv.diag_inv * res)
            z = z + d
            rho_old = rho
        return z

    def vcycle(lv_i: int, r):
        if lv_i == len(levels):
            return coarse_inv @ r
        lv = levels[lv_i]
        z = cheb_smooth(lv, r, jnp.zeros_like(r))
        res = r - _ell_apply(lv.A_idx, lv.A_val, z)
        rc = _ell_apply(lv.R_idx, lv.R_val, res)
        zc = vcycle(lv_i + 1, rc)
        z = z + _ell_apply(lv.P_idx, lv.P_val, zc)
        return cheb_smooth(lv, r, z)

    def apply1(r):
        rf = r[free_j]
        zf = vcycle(0, rf)
        return jnp.zeros(n0, r.dtype).at[free_j].set(zf)

    def apply(r):
        # (n,) or (n, k): batched right-hand sides (vector-component coarse
        # solves) vmap over the trailing axis
        if r.ndim == 2:
            return jax.vmap(apply1, in_axes=1, out_axes=1)(r)
        return apply1(r)

    return apply


def _power_lam(A: sp.csr_matrix, Dinv: sp.spmatrix, iters: int = 20) -> float:
    rng = np.random.default_rng(0)
    v = rng.standard_normal(A.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    DA = Dinv @ A
    for _ in range(iters):
        w = DA @ v
        lam = np.linalg.norm(w)
        v = w / max(lam, 1e-30)
    return float(max(lam, 1e-12))
