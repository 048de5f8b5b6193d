"""Multi-color block Gauss-Seidel smoothing (the reference's GS=True path).

NGSolve's ``CreateBlockSmoother`` sweeps blocks sequentially
(``Smooth``/``SmoothBack``, used by MypreA at
/root/reference/templates/NavierStokesSIMPLE_iterative.py:375-381).  A
sequential sweep is hostile to batched execution, so the standard substitute
(SURVEY.md section 7) is MULTI-COLOR Gauss-Seidel: blocks are greedily
colored so that same-color blocks share no dof, then each color is updated
as ONE batched dense block-solve (gather -> batched matvec -> scatter) with
a fresh residual per color.  Within a color the updates are independent, so
the sweep is mathematically a block-GS over ``ncolors`` grouped steps; for
the overlapping vertex-star patches used here, dof-disjointness coincides
with operator-decoupling, so the grouped sweep IS a valid multiplicative
Schwarz ordering.

The symmetric preconditioner (forward sweep, coarse correction, backward
sweep) mirrors MypreA.Mult exactly:

    y = 0; Smooth(y, x); r = x - A y; y += coarse(r); SmoothBack(y, x).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def color_blocks(blocks: list[np.ndarray], ndof: int,
                 eldofs: np.ndarray | None = None) -> np.ndarray:
    """Greedy graph coloring of dof blocks for multiplicative sweeps.

    Same color must mean OPERATOR-decoupled, not merely dof-disjoint: two
    blocks that share no dof but touch the same element still couple
    through A, and updating them simultaneously can overshoot exactly like
    undamped block-Jacobi (observed: an indefinite "GS" preconditioner from
    dof-disjoint coloring of 3D edge-star patches — opposite edges of a tet
    share no face).  With ``eldofs`` given, blocks touching a common
    element are forced onto different colors; without it, the criterion
    falls back to shared dofs (sufficient only when dof-disjointness
    implies decoupling, as for 2D vertex stars).
    """
    nb = len(blocks)
    colors = -np.ones(nb, dtype=np.int32)
    if eldofs is not None:
        # dof -> blocks incidence
        dof2blocks: list[list[int]] = [[] for _ in range(ndof)]
        for i, b in enumerate(blocks):
            for d in b:
                dof2blocks[d].append(i)
        # element cliques -> adjacency sets
        adj: list[set] = [set() for _ in range(nb)]
        for row in eldofs:
            touch: set = set()
            for d in row:
                touch.update(dof2blocks[d])
            for i in touch:
                adj[i].update(touch)
        # smallest-last (degeneracy) ordering: on the 3D edge-star graph
        # this colors the bench mesh in 9 colors vs 11 for index order —
        # and without the index-order tail of near-empty colors (3- and
        # 33-block colors whose sweep steps are pure kernel-launch
        # overhead in the row-panel GS, round 5).  Every color-step costs
        # a fixed small-op latency (several kernel launches), so the color
        # count is a direct term in the preA apply time.
        import heapq

        deg = np.array([len(a) - (i in a) for i, a in enumerate(adj)])
        degs = deg.copy()
        removed = np.zeros(nb, bool)
        order: list[int] = []
        h = [(int(degs[i]), i) for i in range(nb)]
        heapq.heapify(h)
        while h:
            d, i = heapq.heappop(h)
            if removed[i] or d != degs[i]:
                continue
            removed[i] = True
            order.append(i)
            for j in adj[i]:
                if not removed[j] and j != i:
                    degs[j] -= 1
                    heapq.heappush(h, (int(degs[j]), j))
        for i in reversed(order):
            taken = {colors[j] for j in adj[i] if colors[j] >= 0}
            c = 0
            while c in taken:
                c += 1
            colors[i] = c
        return colors
    # fallback: dof-sharing adjacency via per-dof color bitmask
    used = np.zeros(ndof, dtype=np.int64)
    for i, b in enumerate(blocks):
        taken = 0
        for d in b:
            taken |= used[d]
        c = 0
        while taken >> c & 1:
            c += 1
        if c >= 63:
            raise ValueError("more than 63 colors; blocks too overlapping")
        colors[i] = c
        for d in b:
            used[d] |= 1 << c
    return colors


class MulticolorGS:
    """Forward/backward multi-color block-GS sweeps over precomputed
    dense block inverses.

    ``dofs``: (nblocks, bmax) padded with -1; ``mats``: matching dense
    blocks (padding rows/cols identity).  Each color sweep costs one
    operator apply plus one batched block solve.
    """

    def __init__(self, dofs: np.ndarray, mats: np.ndarray,
                 colors: np.ndarray, ndof: int, dtype=jnp.float64):
        self.ndof = ndof
        self.ncolors = int(colors.max()) + 1
        inv = np.linalg.inv(np.asarray(mats, np.float64))
        self.groups = []
        for c in range(self.ncolors):
            sel = np.where(colors == c)[0]
            d = dofs[sel]
            pad = d < 0
            self.groups.append(
                (
                    jnp.asarray(np.where(pad, 0, d), jnp.int32),
                    jnp.asarray(pad),
                    jnp.asarray(inv[sel], dtype),
                )
            )

    def _solve_color(self, g, r):
        safe, pad, inv = g
        rb = jnp.where(pad, 0.0, r[safe])
        yb = jnp.einsum("bij,bj->bi", inv, rb)
        yb = jnp.where(pad, 0.0, yb)
        # same-color blocks are dof-disjoint: add == set
        return jnp.zeros(self.ndof, r.dtype).at[safe].add(yb)

    def forward(self, A_apply, x, y):
        for g in self.groups:
            r = x - A_apply(y)
            y = y + self._solve_color(g, r)
        return y

    def backward(self, A_apply, x, y):
        for g in reversed(self.groups):
            r = x - A_apply(y)
            y = y + self._solve_color(g, r)
        return y


def damped_coarse(coarse, A_apply, example, target: float = 0.9,
                  iters: int = 30):
    """Scale an auxiliary-space coarse correction for MULTIPLICATIVE use.

    Inside the symmetric sweep the correction ``y += C (x - A y)`` only
    keeps the preconditioner positive definite when lambda_max(C A) < 2;
    the aux-space coarse is spectrally EQUIVALENT to A^{-1} on coarse
    modes but not scaled (an additive combination doesn't care — BPCG's
    Lanczos rescaling absorbs any factor — but the multiplicative V-cycle
    composition goes indefinite, observed as +-1e3 eigenvalues of preA^-1 A
    on the 3D skeleton system).  Estimates lambda_max(C A) by power
    iteration at setup and scales C to ``target`` (NSTPU_COARSE_TARGET
    overrides; must stay < 2 for SPD)."""
    import os

    import numpy as np

    target = float(os.environ.get("NSTPU_COARSE_TARGET", target))

    # ONE jitted fori_loop, not ``iters`` eager composite applies: the
    # eager form dispatches hundreds of ops and compiles each
    # uniquely-shaped one on every setup.  hoisted_jit keeps the captured
    # operator tables as runtime arguments (utils/jaxtools.py).
    import jax

    from ..utils.jaxtools import hoisted_jit

    def power(v0):
        def body(_, carry):
            v, _lam = carry
            w = coarse(A_apply(v))
            lam_new = jnp.linalg.norm(w)
            return w / jnp.maximum(lam_new, 1e-30), lam_new

        return jax.lax.fori_loop(
            0, iters, body,
            (v0, jnp.asarray(1.0, jnp.result_type(v0))),
        )

    v0 = example / jnp.linalg.norm(example)
    _, lam = hoisted_jit(power, v0)(v0)
    lam = float(lam)
    theta = min(1.0, target / max(lam, 1e-30))
    if not np.isfinite(theta) or theta <= 0:
        theta = 1.0
    return (lambda r: theta * coarse(r)), lam, theta


def symmetric_gs_preconditioner(
    gs: MulticolorGS, A_apply, coarse=None, free=None
):
    """MypreA.Mult with GS=True (reference :375-381): forward block-GS,
    additive coarse correction on the residual, backward block-GS.
    Symmetric by construction (reverse color order + exact coarse)."""

    def preA(x):
        xf = jnp.where(free, x, 0.0) if free is not None else x
        y = gs.forward(A_apply, xf, jnp.zeros_like(xf))
        if coarse is not None:
            r = xf - A_apply(y)
            y = y + coarse(r)
        y = gs.backward(A_apply, xf, y)
        return jnp.where(free, y, x) if free is not None else y

    return preA
