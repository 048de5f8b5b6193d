"""Jacobi / block-Jacobi preconditioners (batched dense block inverses).

Replaces NGSolve's ``Preconditioner(m, 'local')`` (Jacobi, used as the Schur
preconditioner at /root/reference/run.py:62) and ``CreateBlockSmoother``
(facet-block smoother, /root/reference/templates/NavierStokesSIMPLE_iterative.py:253,373).
Block inverses are computed once as a batched ``jnp.linalg.inv`` — elementwise
dense work that maps straight onto the matrix units — and applied as gather->batched
matvec->scatter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def jacobi(diag: jax.Array, free_mask=None):
    """Pointwise Jacobi: x -> x / diag, identity on constrained dofs."""
    if free_mask is not None:
        d = jnp.where(free_mask, diag, 1.0)
    else:
        d = diag
    inv = 1.0 / d
    if free_mask is not None:
        def apply(x):
            return jnp.where(free_mask, inv * x, 0.0)
    else:
        def apply(x):
            return inv * x
    return apply


def block_jacobi(blocks_dofs: np.ndarray, block_mats: jax.Array, ndof: int,
                 counts: jax.Array | None = None):
    """Additive block-Jacobi from padded dof blocks.

    ``blocks_dofs``: (nblocks, bmax) int32, padded with -1.
    ``block_mats``: (nblocks, bmax, bmax) local matrices (rows/cols of the
    global operator restricted to each block; padding rows/cols must be
    identity).  Overlapping blocks are summed (additive Schwarz).

    Block inverses are computed on host in float64 and shipped as a device
    constant.
    """
    inv = jnp.asarray(
        np.linalg.inv(np.asarray(block_mats, np.float64)),
        jnp.asarray(block_mats).dtype,
    )
    dofs = jnp.asarray(blocks_dofs, jnp.int32)
    pad = dofs < 0
    safe = jnp.where(pad, 0, dofs)

    def apply(x):
        xb = x[safe]
        xb = jnp.where(pad, 0.0, xb)
        yb = jnp.einsum("bij,bj->bi", inv, xb)
        yb = jnp.where(pad, 0.0, yb)
        return jnp.zeros(ndof, x.dtype).at[safe].add(yb)

    return apply


def extract_blocks_from_local(
    a_local: np.ndarray, eldofs: np.ndarray, blocks: list[np.ndarray], ndof: int
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side: build padded (dofs, dense block) pairs for ``block_jacobi``
    by restricting the globally-assembled operator to each dof block.

    Uses the native meshkit kernel when available (the per-block scipy
    fancy-indexing loop is the setup hotspot at scale); numpy fallback
    otherwise."""
    from ..ops.assembly import assemble_csr
    from ..utils import native

    A = assemble_csr(a_local, eldofs, ndof)
    bmax = max(len(b) for b in blocks)
    nb = len(blocks)
    dofs = -np.ones((nb, bmax), dtype=np.int32)
    for i, b in enumerate(blocks):
        dofs[i, : len(b)] = np.asarray(b, dtype=np.int32)
    mats = native.extract_blocks_csr(A, dofs)
    return dofs, mats
