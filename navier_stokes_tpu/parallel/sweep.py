"""Vmapped parameter sweeps: ensembles of solves as one SPMD program.

The reference executes its parameter sweeps serially
(/root/reference/run.py:229-259,
/root/reference/templates/run_navier_stokes_parameter_sweep.py:49-67).  The
batched replacement (SURVEY.md section 2c): make the physical parameter
(viscosity / Reynolds number) a traced argument of the fused time step, vmap
over the ensemble axis and shard it across the device mesh — one compiled
program advances the whole ensemble per step, the BASELINE.json config-5
capability ("3D SIMPLE + vmapped Reynolds-number parameter sweep").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops import assembly as asm
from ..solvers.cg import cg


def make_viscosity_step(model):
    """A fused IMEX step ``step(u, nu) -> u_next`` with TRACED viscosity.

    Built from the nu-independent tables of a NavierStokes model; inner
    solves use Jacobi preconditioners whose diagonals are recomputed from
    the traced nu (cheap), so one jitted function serves every ensemble
    member.
    """
    d, n, dt = model.d, model.n, model.timestep
    free = model.free_s
    f = model.f
    tu = model.tu
    K_loc, M_loc, DD_loc = model.K_loc, model.M_loc, model.DD_loc
    gd = model.grad_div
    eldofs = tu.eldofs
    convection = model.convection
    project = model._project_velocity

    diagK = asm.diagonal_of_local(K_loc, eldofs, n)
    dd_diag = jnp.einsum("eiaia->eia", DD_loc)
    diagDD = jnp.stack(
        [asm.scatter_add(dd_diag[:, :, c], eldofs, n) for c in range(d)]
    )
    diagM = asm.diagonal_of_local(M_loc, eldofs, n)

    def stokesA_raw(u2, nu):
        y = nu * jax.vmap(
            lambda uc: asm.apply_local_matrices(K_loc, eldofs, n, uc)
        )(u2)
        if gd:
            ue = u2[:, eldofs]
            loc = jnp.einsum("eiajb,bej->eia", DD_loc, ue)
            y = y + gd * nu * jax.vmap(
                lambda l: asm.scatter_add(l, eldofs, n),
                in_axes=2, out_axes=0,
            )(loc)
        return y

    def mass_raw(u2):
        return jax.vmap(
            lambda uc: asm.apply_local_matrices(M_loc, eldofs, n, uc)
        )(u2)

    def step(u, nu):
        u2 = u.reshape(d, n)
        temp = convection(u).reshape(d, n) + f - stokesA_raw(u2, nu)
        temp = jnp.where(free[None], temp, 0.0).reshape(-1)

        diag_mstar = diagM[None] + dt * nu * (diagK[None] + gd * diagDD)
        diag_mstar = jnp.where(free[None], diag_mstar, 1.0)
        inv_diag = (1.0 / diag_mstar).reshape(-1)

        def mstar(v):
            v2 = v.reshape(d, n)
            vf = jnp.where(free[None], v2, 0.0)
            y = mass_raw(vf) + dt * stokesA_raw(vf, nu)
            return jnp.where(free[None], y, v2).reshape(-1)

        temp2 = cg(
            mstar, temp, pre=lambda v: inv_diag * v, tol=1e-4, maxsteps=2000
        ).x
        temp2, _ = project(temp2)
        return u + dt * temp2

    return step


def mcs_nu_split_tables(model):
    """Split the condensed MCS operator into nu-independent tables:

        A_cond(nu) = nu * G1 + G2 + (1/nu) * G3.

    The 4-field element system (models/navier_stokes_mcs.py) has
    A_cc(nu) = T_nu @ Abar @ T_nu with T_nu = diag(1/sqrt(2 nu) on sigma,
    sqrt(2 nu) on W) and nu-independent A_rc, so the condensation Schur
    term A_rc A_cc^{-1} A_rc^T splits into (sigma,sigma) ~ 2 nu,
    cross-terms ~ 1, and (W,W) ~ 1/(2 nu); the retained block itself is
    the grad-div term ~ nu.  Three fixed element tables therefore serve
    EVERY viscosity in a sweep — the flagship analogue of the reference's
    serial parameter loop
    (/root/reference/templates/run_navier_stokes_parameter_sweep.py:49-67).
    """
    nu0 = model.nu
    A_rc = np.asarray(model._A_rc)
    Acc_inv = np.asarray(model._Acc_inv)
    nbs = model.sigma_basis.n_basis
    # Abar^{-1} = T_nu0 @ Acc_inv(nu0) @ T_nu0
    a = 1.0 / np.sqrt(2.0 * nu0)
    scale = np.concatenate(
        [np.full(nbs, a), np.full(Acc_inv.shape[1] - nbs, 1.0 / a)]
    )
    Abar_inv = Acc_inv * scale[None, :, None] * scale[None, None, :]
    R_s = A_rc[:, :, :nbs]  # sigma columns
    R_w = A_rc[:, :, nbs:]  # W columns
    S_ss = np.einsum(
        "eic,ecd,ejd->eij", R_s, Abar_inv[:, :nbs, :nbs], R_s, optimize=True
    )
    S_sw = np.einsum(
        "eic,ecd,ejd->eij", R_s, Abar_inv[:, :nbs, nbs:], R_w, optimize=True
    )
    S_ww = np.einsum(
        "eic,ecd,ejd->eij", R_w, Abar_inv[:, nbs:, nbs:], R_w, optimize=True
    )
    # A_ret (pure grad-div ~ nu) recovered from the stored condensed matrix
    schur0 = np.einsum(
        "eic,ecd,ejd->eij", A_rc, Acc_inv, A_rc, optimize=True
    )
    A_ret = np.asarray(model.A_cond_np) + schur0
    G1 = A_ret / nu0 - 2.0 * S_ss
    G2 = -(S_sw + S_sw.transpose(0, 2, 1))
    G3 = -0.5 * S_ww
    return G1, G2, G3


def make_viscosity_step_mcs(model):
    """Fused IMEX step ``step(u, nu) -> u_next`` with TRACED viscosity for
    the flagship NavierStokesMCS model (BASELINE config 5: 3D SIMPLE +
    vmapped Reynolds sweep).  One gather/scatter round trip applies all
    three nu-split tables."""
    G1, G2, G3 = mcs_nu_split_tables(model)
    dt, free, f, n = model.timestep, model.free, model.f, model.n
    dtype = model.dtype
    convection = model.convection
    project = model._project_velocity
    model._mass_chebyshev()  # construct outside traces (concrete Lanczos)
    model._pre_proj_twolevel()  # host setup — must happen outside traces
    model.convection(model.u)  # build conv tables outside traces too
    eldofs = model.Xv.element_dofs
    M_np = np.asarray(model._M_loc_np)

    def diag_of(loc):
        d = np.zeros(n)
        np.add.at(d, np.asarray(eldofs).ravel(),
                  np.einsum("eii->ei", loc).ravel())
        return jnp.asarray(d, dtype)

    dG1, dG2, dG3, dM = (diag_of(x) for x in (G1, G2, G3, M_np))

    if model.fb is not None:
        lay = model.fb
        G1j, G2j, G3j = (
            jnp.asarray(lay.permute_blocks(g), dtype) for g in (G1, G2, G3)
        )
        Mj = model._M_loc  # permuted in 3D

        def apply_tabs(coeffs_and_mats, u):
            return lay.elem_apply_multi(coeffs_and_mats)(u)
    else:
        G1j, G2j, G3j = (jnp.asarray(g, dtype) for g in (G1, G2, G3))
        Mj = model._M_loc
        eldofs_j = jnp.asarray(eldofs)

        def apply_tabs(coeffs_and_mats, u):
            y = 0.0
            for mat, c in coeffs_and_mats:
                t = asm.apply_local_matrices(mat, eldofs_j, n, u)
                y = y + (t if c is None else c * t)
            return y

    def step(u, nu):
        nu = jnp.asarray(nu, dtype)

        def A_raw(v):
            return apply_tabs(
                [(G1j, nu), (G2j, None), (G3j, 1.0 / nu)], v
            )

        temp = convection(u) + f - A_raw(u)
        temp = jnp.where(free, temp, 0.0)

        diag_mstar = dM + dt * (nu * dG1 + dG2 + dG3 / nu)
        diag_mstar = jnp.where(
            free & (jnp.abs(diag_mstar) > 1e-30), jnp.abs(diag_mstar), 1.0
        )

        def mstar(v):
            vf = jnp.where(free, v, 0.0)
            y = apply_tabs([(Mj, None)], vf) + dt * A_raw(vf)
            return jnp.where(free, y, v)

        temp2 = cg(
            mstar, temp, pre=lambda v: jnp.where(free, v / diag_mstar, v),
            tol=1e-4, maxsteps=2000,
        ).x
        temp2, _ = project(temp2)
        return u + dt * temp2

    return step


def run_reynolds_ensemble_mcs(
    model, nus, n_steps: int, device_mesh=None, axis: str = "shard"
):
    """Advance a viscosity ensemble of the flagship MCS model: vmapped
    fused steps, optionally sharded over a device mesh."""
    step = make_viscosity_step_mcs(model)
    nus = jnp.asarray(nus, model.dtype)
    batch_u = jnp.tile(model.u[None, :], (len(nus), 1))

    def advance(u_all, nu_all):
        def one(i, carry):
            return jax.vmap(step)(carry, nu_all)

        return jax.lax.fori_loop(0, n_steps, one, u_all)

    if device_mesh is not None:
        sharding = NamedSharding(device_mesh, P(axis))
        batch_u = jax.device_put(batch_u, sharding)
        nus = jax.device_put(nus, sharding)
        advance = jax.jit(advance, in_shardings=(sharding, sharding),
                          out_shardings=sharding)
    else:
        advance = jax.jit(advance)
    return advance(batch_u, nus)


def run_reynolds_ensemble(
    model, nus, n_steps: int, device_mesh=None, axis: str = "shard"
):
    """Advance one ensemble member per viscosity for ``n_steps`` fused steps.

    Returns (len(nus), V.ndof) final velocities.  With a device mesh the
    ensemble axis is sharded (data parallelism over chips).
    """
    step = make_viscosity_step(model)
    nus = jnp.asarray(nus, model.dtype)
    batch_u = jnp.tile(model.u[None, :], (len(nus), 1))

    def advance(u_all, nu_all):
        def one(i, carry):
            return jax.vmap(step)(carry, nu_all)

        return jax.lax.fori_loop(0, n_steps, one, u_all)

    if device_mesh is not None:
        sharding = NamedSharding(device_mesh, P(axis))
        batch_u = jax.device_put(batch_u, sharding)
        nus = jax.device_put(nus, sharding)
        advance = jax.jit(advance, in_shardings=(sharding, sharding),
                          out_shardings=sharding)
    else:
        advance = jax.jit(advance)
    return advance(batch_u, nus)
