"""Curved (isoparametric) geometry: the mesh.Curve(3) parity path."""

import numpy as np
import pytest

from navier_stokes_tpu.fem.quadrature import triangle_rule
from navier_stokes_tpu.mesh import channel_with_cylinder_mesh
from navier_stokes_tpu.mesh.curved import curve_to_circle, geometry_tables
from navier_stokes_tpu.models import stokes as st
from navier_stokes_tpu.models.discretizations import taylor_hood


@pytest.fixture(scope="module")
def channel():
    return channel_with_cylinder_mesh(0.1)


def test_curved_area_beats_polygonal(channel):
    exact = 2 * 0.41 - np.pi * 0.05**2
    _, detJ, _ = channel.element_jacobians
    poly_err = abs(detJ.sum() / 2 - exact) / exact
    geo = curve_to_circle(channel, "cyl", (0.2, 0.2), 0.05, order=3)
    q = triangle_rule(8)
    _, dJ, _, _ = geometry_tables(geo, q.points)
    curved_err = abs(np.einsum("q,eq->", q.weights, dJ) - exact) / exact
    assert curved_err < poly_err / 50


def test_interior_elements_stay_affine(channel):
    geo = curve_to_circle(channel, "cyl", (0.2, 0.2), 0.05, order=2)
    q = triangle_rule(4)
    _, dJ, _, _ = geometry_tables(geo, q.points)
    _, detJ_aff, _ = channel.element_jacobians
    # an element far from the cylinder has constant detJ equal to the affine one
    cent = channel.points[channel.elements].mean(axis=1)
    far = np.argmax(np.hypot(cent[:, 0] - 0.2, cent[:, 1] - 0.2))
    assert np.abs(dJ[far] - detJ_aff[far]).max() < 1e-13


def test_curved_stokes_solves(channel):
    geo = curve_to_circle(channel, "cyl", (0.2, 0.2), 0.05, order=3)
    disc, _ = taylor_hood(2)
    system = st.build_stokes_system(
        channel, disc, uin=st.default_inlet_profile(), geometry=geo,
        a_pre="twolevel",
    )
    u, p, errs, tm, nd = st.solve_with_bramble_pasciak_cg(
        system, tolerance=1e-8, max_steps=20000
    )
    assert errs[-1] < 1e-7
    assert np.all(np.isfinite(np.asarray(u)))


def test_curved_piola_affine_consistency():
    """Curved HDG assembly with an affine geometry map reproduces the
    straight-element assembly."""
    import numpy as np
    from navier_stokes_tpu.fem.reference import lagrange_triangle
    from navier_stokes_tpu.mesh.curved import CurvedGeometry
    from navier_stokes_tpu.mesh.generators import rectangle_mesh
    from navier_stokes_tpu.models.discretizations import bdm_hybrid
    from navier_stokes_tpu.models.stokes_hybrid import (
        assemble_hdg_stokes,
        assemble_hdg_stokes_curved,
    )

    mesh = rectangle_mesh(0.34, 1.0, 1.0)
    disc, _ = bdm_hybrid(2, 10)
    V, Q = disc(mesh, "wall")
    A0, B0, _ = assemble_hdg_stokes(V, Q)
    gb = lagrange_triangle(3)
    J, _, _ = mesh.element_jacobians
    v0 = mesh.points[mesh.elements[:, 0]]
    coords = v0[:, None, :] + np.einsum("eab,nb->ena", J, gb.nodes)
    A1, B1, _ = assemble_hdg_stokes_curved(V, Q, CurvedGeometry(3, coords))
    assert np.abs(A0 - A1).max() < 1e-8 * np.abs(A0).max()
    assert np.abs(B0 - B1).max() < 1e-12 * np.abs(B0).max()


def test_curved_piola_channel_solves():
    """HDG BDM 2 on the order-3 curved cylinder (the reference's active
    benchmark geometry, run.py:28) converges, and curving measurably
    changes the solution (delta ~1e-2 at maxh=0.1)."""
    import numpy as np
    from navier_stokes_tpu.mesh.curved import curve_to_circle
    from navier_stokes_tpu.mesh.generators import channel_with_cylinder_mesh
    from navier_stokes_tpu.models import stokes as st
    from navier_stokes_tpu.models.discretizations import bdm_hybrid
    from navier_stokes_tpu.models.stokes_hybrid import (
        build_hybrid_stokes_system,
    )

    mesh = channel_with_cylinder_mesh(0.15)
    disc, _ = bdm_hybrid(2, 10)
    geo = curve_to_circle(mesh, "cyl", (0.2, 0.2), 0.05, 3)

    def run(geometry):
        system = build_hybrid_stokes_system(
            mesh, disc, geometry=geometry, a_pre="vertexstar",
            uin=st.default_inlet_profile(),
        )
        u, p, errs, t, nd = st.solve_with_bramble_pasciak_cg(
            system, tolerance=1e-8, max_steps=20000
        )
        return np.asarray(u), errs

    u_s, errs_s = run(None)
    u_c, errs_c = run(geo)
    assert errs_c[-1] < 1e-7
    delta = np.linalg.norm(u_c - u_s) / np.linalg.norm(u_s)
    assert 1e-4 < delta < 0.2, delta


def test_curved_mcs_channel_solves():
    """The MCS flagship on the order-3 curved cylinder."""
    import numpy as np
    from navier_stokes_tpu.mesh.curved import curve_to_circle
    from navier_stokes_tpu.mesh.generators import channel_with_cylinder_mesh
    from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS

    mesh = channel_with_cylinder_mesh(0.15)
    geo = curve_to_circle(mesh, "cyl", (0.2, 0.2), 0.05, 3)

    def uin(p):
        return np.stack(
            [1.5 * 4 * p[:, 1] * (0.41 - p[:, 1]) / 0.41**2,
             np.zeros(len(p))], 1,
        )

    def run(g):
        ns = NavierStokesMCS(
            mesh, nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
            uin=uin, timestep=1e-3, order=2, geometry=g,
        )
        res = ns.SolveInitial(iterative=True, GS=False, tol=1e-8,
                              maxsteps=20000)
        assert bool(res.converged)
        return np.asarray(ns.u)

    u_s = run(None)
    u_c = run(geo)
    delta = np.linalg.norm(u_c - u_s) / np.linalg.norm(u_s)
    assert 1e-4 < delta < 0.2, delta
