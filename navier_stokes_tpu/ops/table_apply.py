"""Batched block matvec over a stored table: the hot stream of the solve.

The flagship iteration (the hot loop of the reference's
solvers/bramblepasciak_new.py:200-241) is dominated by
batched dense block matvecs: the condensed element operator, the
harmonic extension and interior solve of the skeleton preconditioner,
the edge-star block solves and the GS residual row panels.  Each one
streams a (nblk, m, k) table once per apply and is bound by memory
bandwidth; XLA's einsum renders it as one fused batched product.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["make_table_apply"]


def make_table_apply(A, store_dtype=None, soa_io: bool = False):
    """Batched block matvec ``fn`` for an (nblk, m, k) table ``A`` (numpy
    or device array).

    ``fn(x)`` maps (nblk, k) -> (nblk, m).  With ``soa_io=True`` the
    vectors are TRANSPOSED instead — (k, nblk) -> (m, nblk), block index
    minor — which is the layout the GS sweep keeps its iterate in
    (ops/faceblock.py solve_color_rows).

    ``store_dtype`` (default float32) is the table's STORAGE dtype; a
    bfloat16 table halves the stream while the product is accumulated in
    the promoted dtype of table and vector (f32 for bf16 x f32, f64 for
    an f64 vector).  The cast is made once, here, directly from the
    source dtype (an f32 detour would corrupt f64-stored tables).
    """
    sdt = jnp.dtype(store_dtype or jnp.float32)
    if isinstance(A, jax.Array):
        A_j = A.astype(sdt)
    else:
        A_j = jnp.asarray(np.asarray(A)).astype(sdt)

    if soa_io:
        def apply(xT):
            return jnp.einsum("bmk,kb->mb", A_j, xT)

        return apply

    def apply(x):
        return jnp.einsum("bmk,bk->bm", A_j, x)

    return apply
