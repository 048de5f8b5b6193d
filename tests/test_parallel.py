"""Multi-device sharding tests on the 8-way virtual CPU mesh
(SURVEY.md section 4: single-host multi-device via
xla_force_host_platform_device_count)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.fem.spaces import H1
from navier_stokes_tpu.mesh import unit_square_mesh
from navier_stokes_tpu.ops import assembly as asm
from navier_stokes_tpu.parallel.sharding import (
    device_mesh,
    sharded_batch_step,
    sharded_local_operator,
)


@pytest.fixture(scope="module")
def poisson():
    mesh = unit_square_mesh(0.2)
    V = H1(mesh, 2, dirichlet="bottom|right|top|left")
    t = asm.make_tables(V)
    K = asm.stiffness_local(t)
    return V, t, K


def test_sharded_operator_matches_single_device(poisson):
    V, t, K = poisson
    assert len(jax.devices()) >= 8
    mesh = device_mesh(8)
    A_sharded = sharded_local_operator(K, t.eldofs, V.ndof, mesh)
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.standard_normal(V.ndof))
    y_ref = asm.apply_local_matrices(K, t.eldofs, V.ndof, u)
    y_sh = A_sharded(u)
    assert np.abs(np.asarray(y_sh) - np.asarray(y_ref)).max() < 1e-11


def test_sharded_cg_solves(poisson):
    from navier_stokes_tpu.solvers.cg import cg

    V, t, K = poisson
    mesh = device_mesh(8)
    A = sharded_local_operator(K, t.eldofs, V.ndof, mesh)
    free = jnp.asarray(V.free_mask)

    def A_masked(u):
        uf = jnp.where(free, u, 0.0)
        return jnp.where(free, A(uf), u)

    rhs = jnp.where(free, 1.0, 0.0)
    res = cg(A_masked, rhs, tol=1e-10, maxsteps=500)
    assert bool(res.converged)
    # validate against unsharded solve
    def A1(u):
        uf = jnp.where(free, u, 0.0)
        y = asm.apply_local_matrices(K, t.eldofs, V.ndof, uf)
        return jnp.where(free, y, u)

    res1 = cg(A1, rhs, tol=1e-10, maxsteps=500)
    assert np.abs(np.asarray(res.x) - np.asarray(res1.x)).max() < 1e-8


def test_sharded_batch_step():
    mesh = device_mesh(8)
    step = lambda u: u * 2.0 + 1.0
    run = sharded_batch_step(step, mesh)
    batch = jnp.ones((8, 16))
    out = run(batch)
    assert np.allclose(np.asarray(out), 3.0)


def test_graft_entry_single_chip():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert np.all(np.isfinite(np.asarray(out)))


def test_graft_entry_multichip():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_flagship_matches_single_device():
    """Dof-SHARDED flagship BPCG (halo-exchange operators) reproduces the single-device SolveInitial solution."""
    import jax.numpy as jnp

    from navier_stokes_tpu.mesh.generators import channel_with_cylinder_mesh
    from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
    from navier_stokes_tpu.parallel.ddshard import sharded_flagship_solve
    from navier_stokes_tpu.parallel.sharding import device_mesh

    def uin(p):
        return np.stack(
            [1.5 * 4 * p[:, 1] * (0.41 - p[:, 1]) / 0.41**2,
             np.zeros(len(p))], 1,
        )

    mesh2 = channel_with_cylinder_mesh(0.3)
    ns = NavierStokesMCS(
        mesh2, nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=uin, timestep=1e-3, order=2, preconditioner="vertexstar",
    )
    mesh = device_mesh(8)
    res, pu, pp = sharded_flagship_solve(ns, mesh, tol=1e-9, maxsteps=3000)
    assert bool(res.converged)
    ns.SolveInitial(iterative=True, GS=False, tol=1e-9, maxsteps=3000)
    assert abs(int(res.iterations) - ns.stokes_bpcg_iterations) <= 3
    u_sh = pu.to_global(np.asarray(res.x[0])) + np.asarray(ns.u_bc)
    diff = np.abs(u_sh - np.asarray(ns.u)).max()
    assert diff < 1e-6, diff


def test_sharded_flagship_3d_matches_single_device():
    """The 3D flagship (tet MCS channel) through the dof-sharded halo
    machinery — fatter facet halos and the face-block smoother — matches
    the single-device solve."""
    import jax.numpy as jnp

    from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
    from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
    from navier_stokes_tpu.parallel.ddshard import sharded_flagship_solve
    from navier_stokes_tpu.parallel.sharding import device_mesh

    H = 0.41

    def uin(p):
        out = np.zeros((len(p), 3))
        out[:, 0] = (
            16 * p[:, 1] * (H - p[:, 1]) * p[:, 2] * (H - p[:, 2]) / H**4
        )
        return out

    mesh3 = channel_with_cylinder_mesh_3d(0.35)
    ns = NavierStokesMCS(
        mesh3, nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=uin, timestep=2e-3, order=2, preconditioner="faceblock",
    )
    mesh = device_mesh(8)
    res, pu, pp = sharded_flagship_solve(ns, mesh, tol=1e-8, maxsteps=6000)
    assert bool(res.converged)
    ns.SolveInitial(iterative=True, GS=False, tol=1e-8, maxsteps=6000)
    # same preconditioner, different fp summation order (halo-packed vs
    # flat applies): iteration counts drift ~1% at 2000+ its (observed
    # 2099 vs 2079); the solution-parity check below is the real assert
    single = ns.stokes_bpcg_iterations
    assert abs(int(res.iterations) - single) <= max(5, 0.02 * single)
    u_sh = pu.to_global(np.asarray(res.x[0])) + np.asarray(ns.u_bc)
    diff = np.abs(u_sh - np.asarray(ns.u)).max()
    scale = np.abs(np.asarray(ns.u)).max()
    # solution delta is SOLVER accuracy, not an operator mismatch: the
    # unequilibrated condensed 3D operator's conditioning amplifies the
    # 1e-8 residual to ~1.7e-4 pointwise, and tightening tol to 1e-10
    # shrinks the delta to 9.5e-6 (measured) — it scales with tol, which
    # a halo/packing bug would not
    assert diff / scale < 2e-3, (diff, scale)
