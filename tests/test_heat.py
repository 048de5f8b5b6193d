"""Heat-equation model: integration tests (analytic-solution convergence,
the formalization of the reference's convergence study, SURVEY.md section 4
item 1)."""

import jax.numpy as jnp
import numpy as np
import scipy.linalg as sla

from navier_stokes_tpu.models.heat import (
    HeatEquation,
    exact_solution,
    sum_of_unit_square_laplace_eigenfunctions,
)
from navier_stokes_tpu.timestepping.orthonormalization import orthonormalize
from navier_stokes_tpu.timestepping.runge_kutta import (
    implicit_runge_kutta_weights,
    linear_implicit_runge_kutta_step,
)


def test_irk_weights_order_conditions():
    for s in [1, 2, 3, 10]:
        w = implicit_runge_kutta_weights(s)
        assert abs(w.b.sum() - 1) < 1e-13
        assert np.abs(w.a.sum(1) - w.c).max() < 1e-13
        if s >= 2:
            assert abs(w.b @ w.c - 0.5) < 1e-13
        if s >= 3:
            assert abs(w.b @ w.c**2 - 1 / 3) < 1e-13


def test_irk_gauss_high_order_on_linear_ode():
    w = implicit_runge_kutta_weights(3)  # order 6
    M = np.array([[-2.0, 1.0], [0.5, -3.0]])
    y0 = np.array([1.0, 2.0])
    errs = []
    for h in [0.5, 0.25]:
        y = linear_implicit_runge_kutta_step(w, jnp.asarray(M), jnp.asarray(y0), h)
        errs.append(np.abs(np.asarray(y) - sla.expm(M * h) @ y0).max())
    assert np.log2(errs[0] / errs[1]) > 5.5


def test_orthonormalize():
    rng = np.random.default_rng(0)
    B = rng.standard_normal((5, 40))
    Q = np.asarray(orthonormalize(jnp.asarray(B)))
    assert np.abs(Q @ Q.T - np.eye(5)).max() < 1e-12
    # span preserved: B projects onto Q exactly
    proj = Q.T @ (Q @ B.T)
    assert np.abs(proj - B.T).max() < 1e-9


def test_heat_exponential_integrator_convergence():
    """L2 error vs exact eigen-decay solution drops at high order in dt.

    Three step sizes and a FITTED slope >= 3, matching the reference's
    own validation lines dt^3/dt^4 (/root/reference/plot_heat.py:13-14) —
    two points cannot distinguish a broken order-2 scheme from the
    high-order integrator."""
    kl = [(1, 1), (2, 1), (1, 3)]
    model = HeatEquation(maxh=0.2, order=8, rk_stages=10)
    init = sum_of_unit_square_laplace_eigenfunctions(kl)
    steps = [0.025, 0.0125, 0.00625]
    errs = []
    for ts in steps:
        T, ft = model.solve(init, 0.05, ts)
        errs.append(model.l2_error(T, exact_solution(kl, ft)))
    assert errs[1] < 1e-7  # absolute accuracy
    slope = np.polyfit(np.log(steps), np.log(errs), 1)[0]
    assert slope >= 3.0, f"fitted order {slope:.2f} < 3 (errors {errs})"
