"""Heat-equation solver with Krylov exponential integrator + Gauss IRK.

Model-level port of the *capability* of /root/reference/heat.py: the 2D heat
equation on the unit square, H1 order 10, all-Dirichlet boundary, advanced by
the Krylov-subspace exponential integrator with an order-10 (5-stage... the
reference uses deg=10 stages) Gauss collocation method, validated against the
exact eigenfunction-decay solution.

Device design: assembly happens once; each large time step is one jitted
function (inner CG solves as lax.while_loop); the whole time loop is a
lax.scan.  The convergence study sweeps time-step sizes and writes the
reference's heat_errors.csv schema (heat.py:161-167).
"""

from __future__ import annotations

from math import pi

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.spaces import H1
from ..mesh.generators import unit_square_mesh
from ..ops import assembly as asm
from ..precond.jacobi import jacobi
from ..solvers.cg import cg
from ..timestepping.exponential import krylov_exponential_step
from ..timestepping.runge_kutta import implicit_runge_kutta_weights

DEFAULT_KL = [(1, 1), (2, 1), (1, 3), (3, 3), (2, 3), (4, 5), (5, 2)]


def sum_of_unit_square_laplace_eigenfunctions(kl):
    """Initial condition of heat.py:13-18: sum of 2 sin(k pi x) sin(l pi y)."""

    def f(p):
        out = np.zeros(len(p))
        for k, l in kl:
            out += 2.0 * np.sin(k * pi * p[:, 0]) * np.sin(l * pi * p[:, 1])
        return out

    return f


def exact_solution(kl, t):
    """Exact decaying solution of heat.py:21-27."""

    def f(p):
        out = np.zeros(len(p))
        for k, l in kl:
            out += (
                2.0
                * np.exp(-(k**2 + l**2) * pi**2 * t)
                * np.sin(k * pi * p[:, 0])
                * np.sin(l * pi * p[:, 1])
            )
        return out

    return f


class HeatEquation:
    """Setup-once heat solver; ``solve`` advances an initial condition.

    Parameters mirror the reference literals: maxh=0.1, order=10, Dirichlet
    on all four sides (heat.py:31-34), subspace dimension 5 (heat.py:74),
    10-stage Gauss IRK (heat.py:76).
    """

    def __init__(
        self,
        maxh: float = 0.1,
        order: int = 10,
        rk_stages: int = 10,
        subspace_dimension: int = 5,
        inner_tol: float = 1e-13,
        inner_maxsteps: int = 4000,
        dtype=jnp.float64,
    ):
        self.mesh = unit_square_mesh(maxh)
        self.space = H1(self.mesh, order, dirichlet="bottom|right|top|left")
        self.tables = asm.make_tables(self.space, dtype=dtype)
        self.mass_local = asm.mass_local(self.tables)
        self.stiff_local = asm.stiffness_local(self.tables)
        self.free = jnp.asarray(self.space.free_mask)
        self.weights = implicit_runge_kutta_weights(rk_stages)
        self.subspace_dimension = subspace_dimension
        self.inner_tol = inner_tol
        self.inner_maxsteps = inner_maxsteps
        self.dtype = dtype
        self.ndof = self.space.ndof

        t, n = self.tables, self.ndof
        self._apply_mass = lambda u: asm.apply_local_matrices(
            self.mass_local, t.eldofs, n, u
        )
        self._apply_stiff = lambda u: asm.apply_local_matrices(
            self.stiff_local, t.eldofs, n, u
        )

    def set_initial(self, initial_temperature) -> jnp.ndarray:
        """Nodal interpolation with Dirichlet rows zeroed (heat.py:63-67)."""
        u = self.space.interpolate(initial_temperature)
        u = np.where(self.space.free_mask, u, 0.0)
        return jnp.asarray(u, self.dtype)

    def _heat_ops(self, dt_sub: float):
        """Masked (M + dt_sub K) operator, its Jacobi preconditioner, solver."""
        free = self.free

        def heat_apply(u):
            uf = jnp.where(free, u, 0.0)
            y = self._apply_mass(uf) + dt_sub * self._apply_stiff(uf)
            return jnp.where(free, y, u)

        diag = asm.diagonal_of_local(
            self.mass_local + dt_sub * self.stiff_local,
            self.tables.eldofs,
            self.ndof,
        )
        pre = jacobi(diag, free)

        def heat_solve(r):
            rf = jnp.where(free, r, 0.0)
            return cg(
                heat_apply, rf, pre=pre, tol=self.inner_tol,
                maxsteps=self.inner_maxsteps,
            ).x

        return heat_apply, heat_solve

    def solve(self, initial_temperature, end_time: float, time_step: float):
        """Advance to >= end_time in steps of ``time_step``.

        Returns (T, final_time); like the reference while-loop
        (heat.py:81), the final time is the first multiple of time_step
        reaching end_time (it may overshoot; errors are evaluated there).
        """
        T0 = self.set_initial(initial_temperature)
        n_steps = int(np.ceil(end_time / time_step - 1e-12))
        final_time = n_steps * time_step
        _, heat_solve = self._heat_ops(time_step / self.subspace_dimension)

        @jax.jit
        def run(T):
            def step(Tc, _):
                Tn = krylov_exponential_step(
                    Tc,
                    self._apply_stiff,
                    self._apply_mass,
                    heat_solve,
                    self.weights,
                    time_step,
                    self.subspace_dimension,
                )
                return Tn, None

            Tf, _ = jax.lax.scan(step, T, None, length=n_steps)
            return Tf

        return run(T0), final_time

    def l2_error(self, T: jnp.ndarray, exact) -> float:
        """sqrt(integral (T_h - exact)^2) via quadrature (heat.py:158-159)."""
        t = self.tables
        u = np.asarray(T)
        uq = np.einsum("qi,ei->eq", np.asarray(t.val), u[self.space.element_dofs])
        exq = exact(np.asarray(t.qpts).reshape(-1, self.mesh.dim)).reshape(uq.shape)
        return float(
            np.sqrt(
                np.einsum("q,eq,e->", np.asarray(t.qw), (uq - exq) ** 2,
                          np.asarray(t.detj))
            )
        )


def heat_convergence_study(
    kl=DEFAULT_KL,
    time_steps=None,
    end_time: float = 0.05,
    data_file: str | None = "heat_errors.csv",
    **heat_kwargs,
):
    """The heat.py:151-167 convergence study: L2 error vs time step.

    Writes the reference CSV schema (columns time_step, error) and
    returns its rows.
    """
    from ..utils.csvio import write_rows

    if time_steps is None:
        time_steps = np.logspace(-1, -4, num=7).tolist()
    model = HeatEquation(**heat_kwargs)
    initial = sum_of_unit_square_laplace_eigenfunctions(kl)
    rows = []
    for ts in time_steps:
        T, final_time = model.solve(initial, end_time, ts)
        err = model.l2_error(T, exact_solution(kl, final_time))
        rows.append({"time_step": ts, "error": float(err)})
    if data_file:
        write_rows(data_file, rows)
    return rows
