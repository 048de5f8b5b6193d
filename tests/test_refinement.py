"""Mixed-precision iterative refinement: reaches f64 residuals with f32
inner solves (f32 table streams at f64 accuracy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.mesh import channel_with_cylinder_mesh
from navier_stokes_tpu.models.navier_stokes import NavierStokes
from navier_stokes_tpu.solvers import mixed_precision_saddle_solve


def test_refinement_dense_saddle():
    rng = np.random.default_rng(2)
    n, m = 50, 20
    Q = rng.standard_normal((n, n))
    Ad = Q @ Q.T + n * np.eye(n)
    Bd = rng.standard_normal((m, n))
    f, g = rng.standard_normal(n), rng.standard_normal(m)
    sol = np.linalg.solve(
        np.block([[Ad, Bd.T], [Bd, np.zeros((m, m))]]), np.concatenate([f, g])
    )
    Md = Bd @ np.linalg.inv(Ad) @ Bd.T

    def ops(dt):
        A = jnp.asarray(Ad, dt)
        B = jnp.asarray(Bd, dt)
        dA = jnp.asarray(np.diag(Ad), dt)
        dM = jnp.asarray(np.diag(Md), dt)
        return dict(
            A=lambda x: A @ x, B=lambda x: B @ x, BT=lambda x: B.T @ x,
            preA=lambda x: x / dA, preM=lambda x: x / dM,
        )

    x, r, steps, inner = mixed_precision_saddle_solve(
        ops(jnp.float64), ops(jnp.float32), jnp.asarray(f), jnp.asarray(g),
        tol=1e-10,
    )
    assert float(r) < 1e-10
    assert int(steps) <= 4  # ~5-6 digits per f32 pass
    err = max(
        np.abs(np.asarray(x[0]) - sol[:n]).max(),
        np.abs(np.asarray(x[1]) - sol[n:]).max(),
    )
    assert err < 1e-8


def test_refinement_matches_f64_stokes_solve():
    def uin(p):
        out = np.zeros((len(p), 2))
        out[:, 0] = 1.5 * 4 * p[:, 1] * (0.41 - p[:, 1]) / 0.41**2
        return out

    mesh = channel_with_cylinder_mesh(0.1)
    kw = dict(nu=0.001, inflow="inlet", outflow="outlet", wall="wall|cyl",
              uin=uin, timestep=1e-3, order=2)
    m64 = NavierStokes(mesh, dtype=jnp.float64, preconditioner="jacobi", **kw)
    m32 = NavierStokes(mesh, dtype=jnp.float32, preconditioner="twolevel", **kw)
    ops64 = dict(A=m64.A, B=m64.B, BT=m64.BT)
    ops32 = dict(A=m32.A, B=m32.B, BT=m32.BT, preA=m32.preA, preM=m32.preM)
    f_mod = jnp.where(
        m64.free_s[None], m64.f - m64._stokesA_raw(m64.u_bc), 0.0
    ).reshape(-1)
    g_mod = -m64.B_raw(m64.u_bc.reshape(-1))
    x, r, steps, inner = mixed_precision_saddle_solve(
        ops64, ops32, f_mod, g_mod, tol=1e-8, inner_tol=2e-6,
        inner_maxsteps=2000,
    )
    assert float(r) <= 1e-8
    m64.SolveInitial(iterative=True, tol=1e-10, maxsteps=20000)
    du = m64.u_bc.reshape(-1) + x[0] - m64.u
    assert float(jnp.abs(du).max()) < 1e-6


def test_refined_mcs_solve_initial():
    """Mixed-precision SolveInitial for the MCS flagship: f32 BPCG floor is
    ~1e-5, refinement reaches 1e-8 and matches the pure-f64 solve."""
    from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
    from navier_stokes_tpu.solvers import solve_initial_refined

    def uin(p):
        out = np.zeros((len(p), 2))
        out[:, 0] = 1.5 * 4 * p[:, 1] * (0.41 - p[:, 1]) / 0.41**2
        return out

    mesh = channel_with_cylinder_mesh(0.1)
    kw = dict(nu=0.001, inflow="inlet", outflow="outlet", wall="wall|cyl",
              uin=uin, timestep=1e-3, order=2)
    m64 = NavierStokesMCS(mesh, dtype=jnp.float64, **kw)
    m32 = NavierStokesMCS(mesh, dtype=jnp.float32, **kw)
    r, steps, inner = solve_initial_refined(m64, m32, tol=1e-8)
    assert r <= 1e-8
    m64b = NavierStokesMCS(mesh, dtype=jnp.float64, **kw)
    m64b.SolveInitial(iterative=True, tol=1e-10)
    assert float(jnp.abs(m64.u - m64b.u).max()) < 1e-6
