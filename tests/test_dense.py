"""Small dense f64 solves (linalg/dense.py) against numpy."""

import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.linalg import dense_solve


@pytest.mark.parametrize("n,nrhs", [(5, None), (12, None), (40, 3)])
def test_dense_solve_f64_matches_numpy(n, nrhs):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    b = rng.standard_normal((n,) if nrhs is None else (n, nrhs))
    x = dense_solve(jnp.asarray(A), jnp.asarray(b))
    assert x.dtype == jnp.float64 and x.shape == b.shape
    want = np.linalg.solve(A, b)
    assert np.abs(np.asarray(x) - want).max() < 1e-13 * np.abs(want).max()
