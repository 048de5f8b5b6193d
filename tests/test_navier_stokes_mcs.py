"""NavierStokesMCS: the reference's MCS discretization with static
condensation, upwind-DG convection and the SIMPLE-style API."""

import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.fem.quadrature import triangle_rule
from navier_stokes_tpu.mesh import channel_with_cylinder_mesh
from navier_stokes_tpu.mesh.generators import rectangle_mesh
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS


def uin(p):
    out = np.zeros((len(p), 2))
    out[:, 0] = 1.5 * 4 * p[:, 1] * (0.41 - p[:, 1]) / 0.41**2
    return out


def _eval_velocity(ns):
    mesh, V = ns.mesh, ns.V
    q = triangle_rule(6)
    vals_ref, _ = V.basis.tabulate(q.points)
    J, detJ, _ = mesh.element_jacobians
    ue = ns.velocity[V.element_dofs] * V.element_signs
    val_p = np.einsum("ecA,qiA->eqic", J, vals_ref) / detJ[:, None, None, None]
    uq = np.einsum("eqic,ei->eqc", val_p, ue)
    qpts = mesh.points[mesh.elements[:, 0]][:, None, :] + np.einsum(
        "eab,qb->eqa", J, q.points
    )
    return uq, qpts


def test_mcs_ns_poiseuille_exact():
    """Steady Stokes solve reproduces Poiseuille exactly: validates the
    4-field assembly, static condensation, reduced-trace stress element and
    the BC machinery in one shot."""
    mesh = rectangle_mesh(0.1, length=1.0, height=0.41)
    ns = NavierStokesMCS(
        mesh, nu=0.01, inflow="inlet", outflow="outlet", wall="wall",
        uin=uin, timestep=1e-3, order=2,
    )
    res = ns.SolveInitial(iterative=True, tol=1e-11, maxsteps=50000)
    assert bool(res.converged)
    assert ns.stokes_bpcg_iterations > 0 and ns.stokes_bpcg_time > 0
    uq, qpts = _eval_velocity(ns)
    exact_x = 1.5 * 4 * qpts[..., 1] * (0.41 - qpts[..., 1]) / 0.41**2
    assert np.abs(uq[..., 0] - exact_x).max() < 1e-6
    assert np.abs(uq[..., 1]).max() < 1e-6
    assert float(jnp.linalg.norm(ns.B_raw(ns.u))) < 1e-7


@pytest.fixture(scope="module")
def ns_channel():
    mesh = channel_with_cylinder_mesh(0.15)
    model = NavierStokesMCS(
        mesh, nu=0.001, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=uin, timestep=1e-3, order=2,
    )
    model.SolveInitial(iterative=True, tol=1e-9, maxsteps=100000)
    return model


def test_mcs_ns_channel_steady(ns_channel):
    ns = ns_channel
    assert float(jnp.linalg.norm(ns.B_raw(ns.u))) < 1e-5
    uq, _ = _eval_velocity(ns)
    assert 1.0 < np.abs(uq).max() < 20.0


def test_mcs_ns_time_stepping(ns_channel):
    ns = ns_channel
    u0 = ns.u
    for _ in range(3):
        ns.DoTimeStep()
    assert bool(jnp.all(jnp.isfinite(ns.u)))
    # near steady state the step change is small
    assert float(jnp.abs(ns.u - u0).max()) < 0.5
    assert float(jnp.linalg.norm(ns.B_raw(ns.u))) < 1e-4
    ns.u = u0


def test_mcs_ns_project(ns_channel):
    ns = ns_channel
    rng = np.random.default_rng(0)
    v = jnp.where(
        ns.free & ns._umask,
        jnp.asarray(rng.standard_normal(ns.n)), 0.0,
    )
    v_proj = ns.Project(v)
    assert float(jnp.linalg.norm(ns.B_raw(v_proj))) < 1e-5 * float(
        jnp.linalg.norm(ns.B_raw(v))
    )


def test_mcs_ns_step_fn_builds_tables_eagerly(ns_channel):
    """make_step_fn must materialize the convection tables (and the other
    host-setup pieces) BEFORE any caller traces the returned step: tables
    first touched inside a jit/make_jaxpr trace embed in the compiled
    module as constants instead of staying runtime device buffers, and an
    otherwise identical fused step then runs many times slower."""
    ns = ns_channel
    ns._conv_v = None  # reset the lazy slot
    ns.make_step_fn(project_tol=1e-5)
    assert ns._conv_v is not None, (
        "convection tables must be built eagerly by make_step_fn"
    )


def test_mcs_ns_stress_reconstruction(ns_channel):
    ns = ns_channel
    sw = ns.reconstruct_stress()
    assert sw.shape == (ns.mesh.ne, ns.sigma_basis.n_basis + ns.Wspace.basis.n_basis)
    assert np.all(np.isfinite(sw))


def test_mcs_ns_gauss_seidel_reduces_iterations():
    """GS=True (symmetric multi-color block-GS, reference MypreA.Mult
    :375-381) must actually change the preconditioner and cut the BPCG
    iteration count vs the additive variant (the reference's sweep shows
    GS materially better)."""
    mesh = channel_with_cylinder_mesh(0.15)
    ns = NavierStokesMCS(
        mesh, nu=0.001, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=uin, timestep=1e-3, order=2,
    )
    ns.SolveInitial(iterative=True, GS=False, tol=1e-9, maxsteps=20000)
    its_add = ns.stokes_bpcg_iterations
    ns.SolveInitial(iterative=True, GS=True, tol=1e-9, maxsteps=20000)
    its_gs = ns.stokes_bpcg_iterations
    assert its_gs < 0.75 * its_add, (its_gs, its_add)


def test_mcs_ns_order5_poiseuille():
    """High-order sanity: the MCS pipeline —
    basis tabulation, 4-field assembly, condensation, vertex-star/aux
    preconditioner — works at order 5 (the reference sweeps orders 7..2,
    run_navier_stokes_parameter_sweep.py:45); Poiseuille (quadratic) is in
    the order-5 space, so the solve is exact.

    maxh=0.15, NOT coarser: the 6-element maxh=0.3 mesh is genuinely
    singular — B restricted to the free velocity dofs drops rank by one
    (a spurious pressure mode survives the boundary constraints), so BPCG
    diverges there at EVERY order.  Measured svd(B_free): rank deficiency
    1 at maxh=0.3, full rank from maxh=0.2."""
    mesh = rectangle_mesh(0.15, length=1.0, height=0.41)
    ns = NavierStokesMCS(
        mesh, nu=0.01, inflow="inlet", outflow="outlet", wall="wall",
        uin=uin, timestep=1e-3, order=5,
    )
    res = ns.SolveInitial(iterative=True, GS=False, tol=1e-10,
                          maxsteps=20000)
    assert bool(res.converged)
    uq, qpts = _eval_velocity(ns)
    exact_x = 1.5 * 4 * qpts[..., 1] * (0.41 - qpts[..., 1]) / 0.41**2
    assert np.abs(uq[..., 0] - exact_x).max() < 1e-6
    assert np.abs(uq[..., 1]).max() < 1e-6
