"""3D MCS NavierStokes (the dimension-generic flagship, round 2).

Decisive check: the Poiseuille-between-
plates solution u = (y(1-y),0,0), p = 2nu(1-x) lies exactly in the MCS
space (BDM_2 x facet_1 x HCurlDiv(2,trace 1) x VectorL2_1 x P1dc), so both
the direct solve of the condensed system and the BPCG iterative path must
reproduce it — validating the 3D trace-free stress element, the vorticity
multiplier Skew2Vec pairing (reference
NavierStokesSIMPLE_iterative.py:57-58), the facet terms, and the batched
static condensation in one shot.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from navier_stokes_tpu.fem.quadrature import tetrahedron_rule
from navier_stokes_tpu.mesh.generators import extrude_to_tets, rectangle_mesh
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
from navier_stokes_tpu.ops.assembly import assemble_csr, assemble_csr_rect


def _plates_setup(h=0.5, nz=2):
    base = rectangle_mesh(h, 1.0, 1.0)
    mesh = extrude_to_tets(base, np.linspace(0, 0.5, nz))
    tol = 1e-9
    mesh.tag_boundary_by_predicate(
        "outlet", lambda p: np.abs(p[:, :, 0] - 1.0) < tol
    )
    rest = np.setdiff1d(mesh.boundary_facets, mesh.boundary_tags["outlet"])
    mesh.boundary_tags["diri"] = rest.astype(np.int32)

    def uin(p):
        out = np.zeros((len(p), 3))
        out[:, 0] = p[:, 1] * (1.0 - p[:, 1])
        return out

    return mesh, uin


def _velocity_error(ns, u):
    mesh = ns.mesh
    hd = ns.V
    q3 = tetrahedron_rule(6)
    vals_ref, _ = hd.tabulate_elements(q3.points)
    J, detJ, _ = mesh.element_jacobians
    val_p = np.einsum("ecA,eqiA->eqic", J, vals_ref) / detJ[:, None, None, None]
    uq = np.einsum(
        "eqic,ei->eqc", val_p, u[ns.Xv.element_dofs[:, : hd.n_basis]]
    )
    qpts = mesh.points[mesh.elements[:, 0]][:, None, :] + np.einsum(
        "eab,qb->eqa", J, q3.points
    )
    ex = qpts[..., 1] * (1.0 - qpts[..., 1])
    return max(np.abs(uq[..., 0] - ex).max(), np.abs(uq[..., 1:]).max())


def test_mcs_ns_3d_poiseuille_direct():
    mesh, uin = _plates_setup()
    ns = NavierStokesMCS(
        mesh, nu=1.0, inflow="diri", outflow="outlet", wall="", uin=uin,
        timestep=1e-3, order=2, preconditioner="faceblock",
    )
    K = assemble_csr(ns.A_cond_np, ns.Xv.element_dofs, ns.n)
    Bg = assemble_csr_rect(
        np.asarray(ns._B_loc), ns.Q.element_dofs, ns.Xv.element_dofs,
        ns.Q.ndof, ns.n,
    )
    idx = np.where(np.asarray(ns.free))[0]
    KK = sp.bmat(
        [[K[idx][:, idx], Bg[:, idx].T], [Bg[:, idx], None]]
    ).tocsc()
    u_bc = np.asarray(ns.u_bc)
    rhs = np.concatenate(
        [(np.asarray(ns.f) - K @ u_bc)[idx], -(Bg @ u_bc)]
    )
    sol = spla.spsolve(KK, rhs)
    du = np.zeros(ns.n)
    du[idx] = sol[: len(idx)]
    assert _velocity_error(ns, du + u_bc) < 1e-9

    # eliminated-field reconstruction: sigma = -2 nu eps(u), W multiplier
    xi = ns.reconstruct_stress(du + u_bc)
    nbs = ns.sigma_basis.n_basis
    J, detJ, Jinv = mesh.element_jacobians
    q3 = tetrahedron_rule(6)
    svals, _ = ns.sigma_basis.tabulate(q3.points)
    sp_phys = np.einsum(
        "eai,qnab,ejb->eqnij", Jinv, svals, J
    ) / detJ[:, None, None, None, None]
    sig_q = np.einsum("eqnij,en->eqij", sp_phys, xi[:, :nbs])
    qpts = mesh.points[mesh.elements[:, 0]][:, None, :] + np.einsum(
        "eab,qb->eqa", J, q3.points
    )
    sig_ex = np.zeros_like(sig_q)
    sig_ex[..., 0, 1] = -(1 - 2 * qpts[..., 1])
    sig_ex[..., 1, 0] = -(1 - 2 * qpts[..., 1])
    assert np.abs(sig_q - sig_ex).max() < 1e-8


@pytest.mark.parametrize("pre", ["faceblock", "auxspace"])
def test_mcs_ns_3d_poiseuille_exact(pre):
    """Iterative (BPCG) path reaches the exact solution to ~1e-8."""
    mesh, uin = _plates_setup()
    ns = NavierStokesMCS(
        mesh, nu=1.0, inflow="diri", outflow="outlet", wall="", uin=uin,
        timestep=1e-3, order=2, preconditioner=pre,
    )
    res = ns.SolveInitial(iterative=True, tol=1e-10, maxsteps=5000)
    assert bool(res.converged)
    assert _velocity_error(ns, np.asarray(ns.u)) < 1e-7


def test_mcs_ns_3d_project_divergence_free():
    mesh, uin = _plates_setup()
    ns = NavierStokesMCS(
        mesh, nu=1.0, inflow="diri", outflow="outlet", wall="", uin=uin,
        timestep=1e-3, order=2, preconditioner="faceblock",
    )
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    v = jnp.where(
        ns.free & ns._umask, jnp.asarray(rng.standard_normal(ns.n)), 0.0
    )
    u_new = ns.Project(v)
    assert float(jnp.linalg.norm(ns.B_raw(u_new))) < 1e-5 * float(
        jnp.linalg.norm(ns.B_raw(v))
    )


def _channel3d(maxh=0.35):
    import numpy as np
    from navier_stokes_tpu.mesh.generators import channel_with_cylinder_mesh_3d

    # shortened channel + reduced circle resolution: the full-length
    # reference geometry has a ~3000-tet floor from the cylinder rings
    mesh = channel_with_cylinder_mesh_3d(
        maxh, length=1.2, circle_resolution=8
    )
    H = 0.41

    def uin(p):
        out = np.zeros((len(p), 3))
        out[:, 0] = (
            16 * p[:, 1] * (H - p[:, 1]) * p[:, 2] * (H - p[:, 2]) / H**4
        )
        return out

    return mesh, uin


def test_mcs_ns_3d_channel_steady():
    """SolveInitial converges on the reference 3D channel geometry
    (NavierStokesSIMPLE_test_3D.py:8-28)."""
    import jax.numpy as jnp

    mesh, uin = _channel3d(0.35)
    ns = NavierStokesMCS(
        mesh, nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=uin, timestep=2e-3, order=2, preconditioner="auxspace",
    )
    res = ns.SolveInitial(iterative=True, GS=True, tol=1e-8, maxsteps=20000)
    assert bool(res.converged)
    assert np.all(np.isfinite(np.asarray(ns.u)))
    # H(div) dofs are face MOMENTS (value x area scale), not point values
    umax = np.abs(np.asarray(ns.u[: ns.V.ndof])).max()
    assert 1e-3 < umax < 1e3


def test_mcs_ns_3d_time_stepping():
    import jax.numpy as jnp

    mesh, uin = _channel3d(0.35)
    ns = NavierStokesMCS(
        mesh, nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=uin, timestep=2e-3, order=2, preconditioner="faceblock",
    )
    ns.SolveInitial(iterative=True, GS=False, tol=1e-8, maxsteps=20000)
    u0 = ns.u
    for _ in range(3):
        ns.DoTimeStep()
    assert bool(jnp.all(jnp.isfinite(ns.u)))
    assert float(jnp.abs(ns.u - u0).max()) < 1.0
