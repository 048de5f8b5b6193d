"""Preconditioned Lanczos eigenvalue estimation (EigenValues_Preconditioner).

Estimates the spectrum of pre @ A (equivalently of A in the pre^{-1} inner
product), replacing NGSolve's ``EigenValues_Preconditioner`` used to compute
the Bramble-Pasciak scaling k = 1/lambda_min + 1e-3
(/root/reference/bramble_pasciak_cg.py:70-71,
/root/reference/solvers/bramblepasciak_new.py:115-119) and Chebyshev bounds.

Full reorthogonalization is essential: the plain three-term recurrence loses
orthogonality once Ritz values converge and can report spurious (even
negative) lambda_min, which poisons the Bramble-Pasciak scaling.  The basis
is kept in two (m, n) buffers so each reorthogonalization is two matmuls
(matrix-unit work) inside a lax.fori_loop — a small compile graph, unlike an
unrolled O(m^2) chain of dots.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _flatten_ops(A, pre, example_vec):
    leaves, treedef = jax.tree_util.tree_flatten(example_vec)
    sizes = [l.size for l in leaves]
    shapes = [l.shape for l in leaves]
    splits = list(jnp.cumsum(jnp.asarray(sizes))[:-1])

    def unflatten(x):
        parts = jnp.split(x, splits) if splits else [x]
        return jax.tree_util.tree_unflatten(
            treedef, [p.reshape(s) for p, s in zip(parts, shapes)]
        )

    def flatten(t):
        return jnp.concatenate(
            [l.ravel() for l in jax.tree_util.tree_leaves(t)]
        )

    Af = lambda x: flatten(A(unflatten(x)))
    pref = lambda x: flatten(pre(unflatten(x)))
    n = sum(sizes)
    dtype = leaves[0].dtype
    return Af, pref, n, dtype


def lanczos_eigenvalues(A, pre, example_vec, iterations: int = 40, key=None):
    """Ritz values (ascending) of pre @ A for SPD A and SPD pre.

    ``A``/``pre`` are callables on pytree vectors; ``example_vec`` fixes
    shapes/dtypes.  min/max are sharp after ~30-40 iterations.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    Af, pref, n, dtype = _flatten_ops(A, pre, example_vec)
    m = iterations

    z0 = jax.random.normal(key, (n,), dtype)
    v0 = pref(z0)
    beta0 = jnp.sqrt(jnp.abs(jnp.vdot(z0, v0)))
    v = v0 / beta0
    z = z0 / beta0  # z = pre^{-1} v ; <v_i, v_j>_B = v_i . z_j = delta_ij

    Vb = jnp.zeros((m, n), dtype).at[0].set(v)
    Zb = jnp.zeros((m, n), dtype).at[0].set(z)
    diag = jnp.zeros(m, dtype)
    offd = jnp.zeros(m, dtype)

    def body(j, carry):
        Vb, Zb, diag, offd = carry
        v = Vb[j]
        z = Zb[j]
        w = Af(v)
        alpha = jnp.vdot(v, w)
        # full reorthogonalization in the dual: w -= Z^T (V w); rows past j
        # are zero so they contribute nothing.  Two passes ("twice is
        # enough"): one classical Gram-Schmidt pass degrades to O(1e-7)
        # orthogonality within ~20 iterations and garbage Ritz values by 50.
        # HIGHEST precision: a reduced-precision f32 matmul (bf16 or TF32
        # multiplication) destroys the orthogonalization (and the Ritz
        # values with it)
        hp = jax.lax.Precision.HIGHEST
        for _ in range(2):
            proj = jnp.matmul(Vb, w, precision=hp)
            w = w - jnp.matmul(Zb.T, proj, precision=hp)
        v_new = pref(w)
        beta = jnp.sqrt(jnp.abs(jnp.vdot(w, v_new)))
        eps = jnp.asarray(1e-10, dtype) * (jnp.abs(alpha) + 1.0)
        broke = beta < eps
        safe = jnp.where(broke, 1.0, beta)
        diag = diag.at[j].set(alpha)
        offd = offd.at[j].set(jnp.where(broke, 0.0, beta))
        nxt = jnp.minimum(j + 1, m - 1)
        Vb = Vb.at[nxt].set(jnp.where(broke, Vb[nxt], v_new / safe))
        Zb = Zb.at[nxt].set(jnp.where(broke, Zb[nxt], w / safe))
        return (Vb, Zb, diag, offd)

    Vb, Zb, diag, offd = jax.lax.fori_loop(0, m, body, (Vb, Zb, diag, offd))

    T = (
        jnp.diag(diag)
        + jnp.diag(offd[: m - 1], 1)
        + jnp.diag(offd[: m - 1], -1)
    )
    return jnp.linalg.eigvalsh(T)


def condition_estimate(A, pre, example_vec, iterations: int = 40, key=None):
    """(lambda_min, lambda_max, cond) of pre @ A."""
    lams = lanczos_eigenvalues(A, pre, example_vec, iterations, key)
    lmin = jnp.min(lams)
    lmax = jnp.max(lams)
    return lmin, lmax, lmax / lmin
