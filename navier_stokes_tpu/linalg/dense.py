"""Small dense solves in float64.

The reference-parity paths need f64 small solves (the 5x5 projected
evolution matrix of the heat integrator, heat.py:120-124, and the
s*m x s*m Gauss-IRK stage system, runge_kutta_method.py:44-45); XLA's LU
(cuSOLVER on a GPU) factorizes them natively in f64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dense_solve(A: jax.Array, b: jax.Array) -> jax.Array:
    """Solve A x = b for small dense A."""
    return jnp.linalg.solve(A, b)
