"""Steady Stokes: operator setup, BPCG/MINRES drivers, benchmark harness.

Model-level rebuild of /root/reference/run.py:
* forms a = integral grad(u):grad(v), b = integral div(u) q, mp = pressure
  mass (run.py:77-84) as matrix-free masked operators from batched local
  matrices,
* rhs f = integral (x-0.5) v_y (run.py:93), parabolic inlet profile
  1.5*4y(0.41-y)/0.41^2 on the x-component (run.py:101-104),
* Dirichlet lifting: solve for the correction du with homogeneous
  constraints (the reference passes the BC-initialized GridFunction as the
  Krylov start vector and lets BDDC zero constrained dofs — same system),
* solver adapters for Bramble-Pasciak CG and block-preconditioned MINRES
  (run.py:32-56) and the sweep harness writing the exact errors.csv schema
  (run.py:244-262).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import assembly as asm
from ..precond.jacobi import jacobi
from ..solvers.bpcg import bramble_pasciak_cg, bramble_pasciak_cg_opt
from ..solvers.minres import minres
from ..utils.timers import Timer


def default_inlet_profile(height: float = 0.41, mean_factor: float = 1.5):
    """Parabolic inlet u_x = 1.5 * 4 y (H - y) / H^2 (run.py:101)."""

    def uin(p):
        ux = mean_factor * 4.0 * p[:, 1] * (height - p[:, 1]) / (height * height)
        out = np.zeros((len(p), p.shape[1]))
        out[:, 0] = ux
        return out

    return uin


def default_volume_force(p):
    """f = (0, x - 0.5): the reference's benchmark forcing (run.py:93)."""
    out = np.zeros((len(p), p.shape[1]))
    out[:, 1] = p[:, 0] - 0.5
    return out


@dataclass
class StokesSystem:
    """Masked matrix-free operators + rhs for the saddle system
    [[A, B^T], [B, 0]] (du, p) = (f_mod, g_mod), with u = u_bc + du."""

    V: object
    Q: object
    A: Callable
    B: Callable
    BT: Callable
    preA: Callable
    preM: Callable
    f: jax.Array
    g: jax.Array
    u_bc: jax.Array
    ndofs: int

    def lift(self, du: jax.Array) -> jax.Array:
        return self.u_bc + du


def build_stokes_system(
    mesh,
    discretization,
    velocity_dirichlet: str = "wall|inlet|cyl",
    uin=None,
    volume_force=default_volume_force,
    dtype=jnp.float64,
    a_pre: str = "jacobi",
    geometry=None,
) -> StokesSystem:
    """``geometry``: optional CurvedGeometry for isoparametric (curved
    cylinder) elements — the mesh.Curve(3) parity path (run.py:28)."""
    V, Q = discretization(mesh, velocity_dirichlet)
    Vs = V.scalar
    d, n = mesh.dim, Vs.ndof
    qd = 2 * max(Vs.order, Q.order, 1)
    if geometry is not None:
        qd += 2 * (geometry.order - 1)
    tu = asm.make_tables(Vs, qd, dtype, geometry=geometry)
    tp = asm.make_tables(Q, qd, dtype, geometry=geometry)
    K_loc = asm.stiffness_local(tu)
    Mp_loc = asm.mass_local(tp)
    D_loc = asm.divergence_local(tp, tu)

    free_s = jnp.asarray(Vs.free_mask)
    eldofs_u, eldofs_p = tu.eldofs, tp.eldofs

    def A_raw(u2):  # (d, n) -> (d, n), unmasked vector Laplacian
        return jax.vmap(
            lambda uc: asm.apply_local_matrices(K_loc, eldofs_u, n, uc)
        )(u2)

    def B_raw(u2):  # (d, n) -> (Q.ndof,)
        ue = u2[:, Vs.element_dofs]  # (d, ne, nbu)
        pe = jnp.einsum("eijc,cej->ei", D_loc, ue)
        return asm.scatter_add(pe, eldofs_p, Q.ndof)

    def A(u):
        u2 = u.reshape(d, n)
        uf = jnp.where(free_s[None], u2, 0.0)
        y = A_raw(uf)
        y = jnp.where(free_s[None], y, u2)  # identity on constrained dofs
        return y.reshape(-1)

    def B(u):
        u2 = jnp.where(free_s[None], u.reshape(d, n), 0.0)
        return B_raw(u2)

    def BT(p):
        pe = p[eldofs_p]
        ue = jnp.einsum("eijc,ei->cej", D_loc, pe)
        y = jax.vmap(lambda l: asm.scatter_add(l, eldofs_u, n))(ue)
        y = jnp.where(free_s[None], y, 0.0)
        return y.reshape(-1)

    # A-preconditioner: two-level additive Schwarz (the BDDC stand-in) or
    # Jacobi; Schur preconditioner = pressure-mass Jacobi (the reference's
    # 'local', run.py:62)
    if a_pre == "twolevel":
        from ..precond.twolevel import two_level_preconditioner

        pre_s = two_level_preconditioner(
            Vs, K_loc, coefficient=1.0, smoother="patch", dtype=dtype
        )

        def preA(u):
            return jax.vmap(pre_s)(u.reshape(d, n)).reshape(-1)

    elif a_pre == "jacobi":
        diag_K = asm.diagonal_of_local(K_loc, eldofs_u, n)
        diag_K = jnp.where(free_s, diag_K, 1.0)
        inv_diag_K = 1.0 / diag_K

        def preA(u):
            u2 = u.reshape(d, n)
            return (inv_diag_K[None] * u2).reshape(-1)

    else:
        raise ValueError(f"unknown a_pre {a_pre!r}")

    diag_Mp = asm.diagonal_of_local(Mp_loc, eldofs_p, Q.ndof)
    preM = jacobi(diag_Mp)

    # rhs: volume force in each component + Dirichlet lifting
    fq = volume_force(np.asarray(tu.qpts).reshape(-1, d)).reshape(
        tu.qpts.shape[0], tu.qpts.shape[1], d
    )
    f_comp = [
        asm.scatter_add(
            asm.linear_form_local(tu, jnp.asarray(fq[:, :, c], dtype)), eldofs_u, n
        )
        for c in range(d)
    ]
    f_full = jnp.stack(f_comp)  # (d, n)

    if uin is None:
        u_bc = jnp.zeros((d, n), dtype)
    else:
        u_bc = jnp.asarray(
            V.interpolate_boundary(uin, "inlet").reshape(d, n), dtype
        )

    f_mod = jnp.where(free_s[None], f_full - A_raw(u_bc), 0.0).reshape(-1)
    g_mod = -B_raw(u_bc)  # g = 0 in the reference (run.py:96-97)

    return StokesSystem(
        V=V, Q=Q, A=A, B=B, BT=BT, preA=preA, preM=preM,
        f=f_mod, g=g_mod, u_bc=u_bc.reshape(-1), ndofs=V.ndof + Q.ndof,
    )


def _trim_errors(errors: np.ndarray) -> list[float]:
    e = np.asarray(errors)
    return e[~np.isnan(e)].tolist()


def solve_with_bramble_pasciak_cg(
    system: StokesSystem, tolerance: float = 1e-7, max_steps: int = 10000,
    optimized: bool = False,
):
    """run.py:32-41 equivalent; returns (u, p, errors, time, ndofs)."""
    timer = Timer("BramblePasciakCG").Start()
    solver = bramble_pasciak_cg_opt if optimized else bramble_pasciak_cg
    kwargs = (
        dict(tol=tolerance, maxsteps=max_steps)
        if optimized
        else dict(tol=tolerance, max_steps=max_steps)
    )
    res = solver(
        system.A, system.B, system.BT, system.preA, system.preM,
        system.f, system.g, **kwargs,
    )
    timer.Stop(res.x)
    u = system.lift(res.x[0])
    return u, res.x[1], _trim_errors(res.errors), timer.time, system.ndofs


def solve_with_min_res(
    system: StokesSystem, tolerance: float = 1e-7, max_steps: int = 10000
):
    """run.py:44-56 equivalent: block system + block-diagonal preconditioner."""

    def K(x):
        u, p = x
        return (system.A(u) + system.BT(p), system.B(u))

    def C(x):
        return (system.preA(x[0]), system.preM(x[1]))

    timer = Timer("MinRes").Start()
    res = minres(K, (system.f, system.g), pre=C, tol=tolerance,
                 maxsteps=max_steps)
    timer.Stop(res.x)
    u = system.lift(res.x[0])
    return u, res.x[1], _trim_errors(res.errors), timer.time, system.ndofs


def solve(mesh, discretization, solver, **system_kwargs):
    """run.py:71-111 equivalent driver for the standard mixed formulation."""
    if "uin" not in system_kwargs:
        system_kwargs["uin"] = default_inlet_profile()
    system = build_stokes_system(mesh, discretization, **system_kwargs)
    u, p, errors, time, ndofs = solver(system)
    return u, p, errors, time, ndofs


def run(
    mesh_sizes,
    methods,
    solver_factories,
    data_file: str = "errors.csv",
    profiling_enabled: bool = False,
    mesh_factory=None,
):
    """Sweep harness with the exact CSV schema of run.py:227-262; returns
    the rows it wrote."""
    from ..mesh.generators import channel_with_cylinder_mesh
    from ..utils.csvio import write_rows
    from ..utils.profiling import maybe_profile

    if mesh_factory is None:
        mesh_factory = channel_with_cylinder_mesh

    rows = []
    for mesh_size in mesh_sizes:
        mesh = mesh_factory(mesh_size)
        for method_name, method_map in methods.items():
            solve_method = method_map["solve"]
            discretizations = method_map["discretizations"]
            for disc_name, (discretization, order) in discretizations.items():
                for solver_name, solver in solver_factories.items():
                    print(
                        f"solving with {disc_name}, {solver_name}, h={mesh_size}"
                    )
                    with maybe_profile(profiling_enabled):
                        _, _, errors, solver_time, ndofs = solve_method(
                            mesh, discretization, solver
                        )
                    rows.extend(
                        {
                            "mesh_size": mesh_size,
                            "discretization": disc_name,
                            "order": order,
                            "solver": solver_name,
                            "iteration": it,
                            "error": float(err),
                            "solver_time": solver_time,
                            "nvertices": mesh.nv,
                            "nedges": mesh.nedge,
                            "nfaces": mesh.nface,
                            "nfacets": mesh.nfacet,
                            "nelements": mesh.ne,
                            "ndofs": ndofs,
                            "method": method_name,
                        }
                        for it, err in enumerate(errors)
                    )
    write_rows(data_file, rows)
    return rows
