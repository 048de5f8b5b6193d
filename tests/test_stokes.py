"""Stokes integration tests: cross-solver agreement, direct-solve validation,
discretization catalog, CSV-schema harness (SURVEY.md section 4 items 2-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from navier_stokes_tpu.mesh import channel_with_cylinder_mesh, unit_square_mesh
from navier_stokes_tpu.models import stokes as st
from navier_stokes_tpu.models.discretizations import (
    P1_nonconforming_velocity_constant_pressure,
    P2_velocity_constant_pressure,
    bdm_hybrid,
    mini,
    taylor_hood,
)
from navier_stokes_tpu.ops import assembly as asm


@pytest.fixture(scope="module")
def channel():
    return channel_with_cylinder_mesh(0.1)


@pytest.fixture(scope="module")
def th_system(channel):
    disc, _ = taylor_hood(2)
    return st.build_stokes_system(channel, disc, uin=st.default_inlet_profile())


def _direct_solution(mesh, disc, system):
    V, Q = disc(mesh, "wall|inlet|cyl")
    Vs = V.scalar
    qd = 2 * max(Vs.order, Q.order, 1)
    tu = asm.make_tables(Vs, qd)
    tp = asm.make_tables(Q, qd)
    K = asm.assemble_csr(
        np.asarray(asm.stiffness_local(tu)), Vs.element_dofs, Vs.ndof
    )
    D = np.asarray(asm.divergence_local(tp, tu))
    Bx = asm.assemble_csr_rect(D[:, :, :, 0], Q.element_dofs, Vs.element_dofs,
                               Q.ndof, Vs.ndof)
    By = asm.assemble_csr_rect(D[:, :, :, 1], Q.element_dofs, Vs.element_dofs,
                               Q.ndof, Vs.ndof)
    A2 = sp.block_diag([K, K]).tocsr()
    B2 = sp.hstack([Bx, By]).tocsr()
    free = np.concatenate([Vs.free_mask, Vs.free_mask])
    idx = np.where(free)[0]
    KK = sp.bmat([[A2[idx][:, idx], B2[:, idx].T], [B2[:, idx], None]]).tocsc()
    rhs = np.concatenate([np.asarray(system.f)[idx], np.asarray(system.g)])
    sol = spla.spsolve(KK, rhs)
    du = np.zeros(2 * Vs.ndof)
    du[idx] = sol[: len(idx)]
    return du + np.asarray(system.u_bc), sol[len(idx):]


def test_bpcg_matches_direct(channel, th_system):
    u, p, errors, t, ndofs = st.solve_with_bramble_pasciak_cg(
        th_system, tolerance=1e-9, max_steps=10000
    )
    disc, _ = taylor_hood(2)
    u_d, p_d = _direct_solution(channel, disc, th_system)
    assert np.abs(np.asarray(u) - u_d).max() < 1e-6
    assert np.abs(np.asarray(p) - p_d).max() < 1e-4
    assert errors[-1] < 1e-9


def test_cross_solver_agreement(channel, th_system):
    """BPCG and MINRES on identical systems agree (run.py:1 docstring)."""
    u1, p1, e1, _, _ = st.solve_with_bramble_pasciak_cg(
        th_system, tolerance=1e-8, max_steps=10000
    )
    u2, p2, e2, _, _ = st.solve_with_min_res(
        th_system, tolerance=1e-8, max_steps=10000
    )
    assert np.abs(np.asarray(u1) - np.asarray(u2)).max() < 1e-5
    assert np.abs(np.asarray(p1) - np.asarray(p2)).max() < 1e-3


def test_bpcg_optimized_same_iterations(channel, th_system):
    _, _, e1, _, _ = st.solve_with_bramble_pasciak_cg(
        th_system, tolerance=1e-7, max_steps=10000
    )
    _, _, e2, _, _ = st.solve_with_bramble_pasciak_cg(
        th_system, tolerance=1e-7, max_steps=10000, optimized=True
    )
    assert abs(len(e1) - len(e2)) <= 3


@pytest.mark.parametrize(
    "disc_factory",
    [taylor_hood(2), mini(), P2_velocity_constant_pressure(),
     P1_nonconforming_velocity_constant_pressure()],
    ids=["th2", "mini", "p2p0", "p1nc"],
)
def test_discretization_catalog_solves(disc_factory):
    """Each implemented pair produces a converging solve on a small channel."""
    mesh = channel_with_cylinder_mesh(0.15)
    disc, order = disc_factory
    system = st.build_stokes_system(mesh, disc, uin=st.default_inlet_profile())
    u, p, errors, t, ndofs = st.solve_with_bramble_pasciak_cg(
        system, tolerance=1e-7, max_steps=20000
    )
    assert errors[-1] < 1e-6
    # velocity at the inlet keeps its boundary value
    V, Q = disc(mesh, "wall|inlet|cyl")
    inlet = V.scalar.boundary_dof_mask("inlet")
    if V.scalar.basis.nodes is not None:
        u_np = np.asarray(u)[: V.scalar.ndof]
        bc = V.interpolate_boundary(st.default_inlet_profile(), "inlet")
        assert np.abs(u_np[inlet] - bc[: V.scalar.ndof][inlet]).max() < 1e-10


def test_run_harness_csv_schema(tmp_path):
    """The sweep harness writes the exact errors.csv schema of run.py:244-259."""
    out = tmp_path / "errors.csv"
    methods = {
        "mixed": {
            "solve": st.solve,
            "discretizations": {"taylor hood 2": taylor_hood(2)},
        }
    }
    solvers = {
        "bramble pasciak cg": lambda s: st.solve_with_bramble_pasciak_cg(
            s, tolerance=1e-6, max_steps=5000
        )
    }
    data = st.run([0.15], methods, solvers, str(out), False)
    import csv

    with open(out, newline="") as fh:
        read = list(csv.DictReader(fh))
    expected = [
        "mesh_size", "discretization", "order", "solver", "iteration",
        "error", "solver_time", "nvertices", "nedges", "nfaces", "nfacets",
        "nelements", "ndofs", "method",
    ]
    assert list(read[0]) == [""] + expected  # leading index column
    assert len(read) == len(data)
    assert float(read[-1]["error"]) < 1e-6
    assert read[0]["method"] == "mixed"


def test_catalog_is_complete():
    """All 9 discretization-catalog entries construct their spaces
    (discretizations.py:6-88 parity)."""
    from navier_stokes_tpu.models import discretizations as dc

    mesh = channel_with_cylinder_mesh(0.2)
    for factory in [
        dc.taylor_hood(2), dc.P1_nonconforming_velocity_constant_pressure(),
        dc.P2_velocity_constant_pressure(), dc.P2_velocity_linear_pressure(),
        dc.P2_velocity_with_cubic_bubbles_linear_pressure(), dc.mini(),
        dc.bdm_hybrid(2, 10), dc.rt_hybrid(1, 10),
    ]:
        disc, order = factory
        V, Q = disc(mesh, "wall|inlet|cyl")
        assert V.ndof > 0 and Q.ndof > 0
    disc, order = dc.hcurldiv(2)
    V, S, Q = disc(mesh, "wall|inlet|cyl", "outlet")
    assert V.ndof > 0 and S.ndof > 0 and Q.ndof > 0
