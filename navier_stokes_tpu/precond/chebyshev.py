"""Chebyshev polynomial preconditioner / smoother.

The batched substitute for sequential Gauss-Seidel sweeps (SURVEY.md
section 7 hard-part 2): a fixed-degree Chebyshev polynomial in a base SPD
smoother (Jacobi/block-Jacobi) is a LINEAR, SPD operator built purely from
operator applies — ideal inside jitted Krylov loops, and usable wherever
the reference plugs a smoother (e.g. as the multiplicative part the GS=True
branch of MypreA provides, NavierStokesSIMPLE_iterative.py:375-381).

Spectral bounds for the scaling come from the Lanczos estimator
(linalg.lanczos) — the same role EigenValues_Preconditioner plays for the
reference's Bramble-Pasciak scaling.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..linalg.lanczos import lanczos_eigenvalues
from ..linalg.pytree import taxpy, tscale, tsub, tzeros_like


def chebyshev_preconditioner(
    A,
    base_pre,
    example_vec,
    degree: int = 4,
    bounds: tuple[float, float] | None = None,
    lanczos_iterations: int = 30,
    lower_fraction: float = 0.1,
):
    """Chebyshev acceleration of ``base_pre`` for the SPD operator ``A``.

    Approximates A^{-1} by the degree-``degree`` Chebyshev polynomial of
    (base_pre A) on [alpha, beta]; with ``bounds`` unset, beta is the
    Lanczos lambda_max estimate (x1.05 safety) and alpha =
    ``lower_fraction`` * beta (the standard smoother regime).  Returns a
    linear SPD apply — safe inside CG/BPCG.
    """
    if bounds is None:
        lams = lanczos_eigenvalues(A, base_pre, example_vec, lanczos_iterations)
        beta = 1.05 * float(jnp.max(lams))
        alpha = lower_fraction * beta
    else:
        alpha, beta = bounds

    theta = 0.5 * (beta + alpha)
    delta = 0.5 * (beta - alpha)
    sigma1 = theta / delta

    def apply(b):
        # standard Chebyshev iteration for M z = b with M = (base_pre A)
        # preconditioned by base_pre; z accumulates the polynomial in
        # base_pre*A applied to base_pre*b
        pb = base_pre(b)
        rho = 1.0 / sigma1
        d = tscale(1.0 / theta, pb)
        z = d
        rho_prev = rho
        for _ in range(degree - 1):
            r = tsub(pb, base_pre(A(z)))
            rho = 1.0 / (2.0 * sigma1 - rho_prev)
            d = taxpy(2.0 * rho / delta, r, tscale(rho * rho_prev, d))
            z = taxpy(1.0, d, z)
            rho_prev = rho
        return z

    return apply
