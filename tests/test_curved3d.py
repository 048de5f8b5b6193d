"""3D curved (isoparametric) geometry: mesh.Curve(3) parity on the tet
channel (/root/reference/templates/NavierStokesSIMPLE_test_3D.py:16 —
the reference's 3D benchmark geometry)."""

import numpy as np
import pytest

from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.mesh.curved import (
    CurvedGeometry3D,
    curve_to_cylinder_3d,
    geometry_tables_3d,
)
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS

H = 0.41


def uin3(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = 16 * p[:, 1] * (H - p[:, 1]) * p[:, 2] * (H - p[:, 2]) / H**4
    return out


def make_model(mesh, geometry=None, order=2):
    return NavierStokesMCS(
        mesh, nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=uin3, timestep=2e-3, order=order, preconditioner="faceblock",
        geometry=geometry,
    )


@pytest.fixture(scope="module")
def channel3():
    return channel_with_cylinder_mesh_3d(0.35)


def test_curved3d_affine_consistency():
    """The isoparametric tet assembly with an affine (straight) geometry
    map, forced over EVERY element, reproduces the combo-factorized affine
    assembly to rounding — validating Jacobians, curvature terms (zero
    here, up to the ~1e-9 FD-Hessian noise floor), Piola pullbacks and
    facet frames in one shot."""
    from navier_stokes_tpu.fem.reference import lagrange_tet

    mesh = channel_with_cylinder_mesh_3d(0.35, length=1.0,
                                         circle_resolution=8)
    gb = lagrange_tet(3)
    J, _, _ = mesh.element_jacobians
    v0 = mesh.points[mesh.elements[:, 0]]
    coords = v0[:, None, :] + np.einsum("eab,nb->ena", J, gb.nodes)
    geo = CurvedGeometry3D(3, coords, np.arange(mesh.ne))

    m0 = make_model(mesh)
    m1 = make_model(mesh, geometry=geo)
    a0, a1 = np.asarray(m0.A_cond_np), np.asarray(m1.A_cond_np)
    assert np.abs(a1 - a0).max() < 1e-8 * np.abs(a0).max()
    r0, r1 = np.asarray(m0._A_rc), np.asarray(m1._A_rc)
    assert np.abs(r1 - r0).max() < 1e-8 * np.abs(r0).max()


def test_curve_to_cylinder_3d_snaps(channel3):
    """Geometry nodes of tagged cylinder faces land on the true cylinder;
    elements away from it stay exactly affine; all Jacobians positive."""
    mesh = channel3
    geo = curve_to_cylinder_3d(mesh, "cyl", (0.5, 0.2), 0.05, order=3)
    assert len(geo.curved_elements)
    from navier_stokes_tpu.fem.quadrature import tetrahedron_rule

    q = tetrahedron_rule(6)
    _, detJ, _, _ = geometry_tables_3d(geo.coords, geo.basis, q.points)
    assert detJ.min() > 0
    # curved subset is O(surface): a strict minority of elements
    assert len(geo.curved_elements) < mesh.ne / 2
    # affine detJ on the non-curved rest
    _, dJa, _ = mesh.element_jacobians
    rest = np.setdiff1d(np.arange(mesh.ne), geo.curved_elements)
    assert np.abs(detJ[rest] - dJa[rest, None]).max() < 1e-12
    # the curved sideset approximates the cylinder area better than the
    # polygonal one: check total volume approaches brick - cylinder
    exact = 2.5 * H * H - np.pi * 0.05**2 * H
    vol_aff = dJa.sum() / 6.0
    w = q.weights
    vol_cur = np.einsum("q,eq->", w, detJ)
    assert abs(vol_cur - exact) < abs(vol_aff - exact) / 3


def test_curved3d_mcs_channel_solves(channel3):
    """The 3D flagship on the order-3 curved cylinder converges, and
    curving measurably (but modestly) changes the solution."""
    mesh = channel3
    geo = curve_to_cylinder_3d(mesh, "cyl", (0.5, 0.2), 0.05, order=3)
    m_s = make_model(mesh)
    m_c = make_model(mesh, geometry=geo)
    r_s = m_s.SolveInitial(iterative=True, GS=False, tol=1e-8,
                           maxsteps=8000)
    r_c = m_c.SolveInitial(iterative=True, GS=False, tol=1e-8,
                           maxsteps=8000)
    assert bool(r_s.converged) and bool(r_c.converged)
    u_s, u_c = np.asarray(m_s.u), np.asarray(m_c.u)
    delta = np.linalg.norm(u_c - u_s) / np.linalg.norm(u_s)
    assert 1e-5 < delta < 0.2, delta
