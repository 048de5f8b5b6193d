"""Sharded fast-path parity: the production split-f32 solver (face-sharded
halo-exchange operators, parallel/faceshard.py) against the single-device
equilibrated operator stack it mirrors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
from navier_stokes_tpu.parallel.faceshard import (
    build_sharded_fast_ops,
    sharded_fast_flagship_solve,
)
from navier_stokes_tpu.parallel.sharding import device_mesh
from navier_stokes_tpu.solvers.refinement import (
    equilibrated_f32_ops,
    mixed_precision_minres_refinement,
)

H = 0.41


def _uin(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = 16 * p[:, 1] * (H - p[:, 1]) * p[:, 2] * (H - p[:, 2]) / H**4
    return out


def _build_ns(maxh):
    mesh3 = channel_with_cylinder_mesh_3d(maxh)
    return NavierStokesMCS(
        mesh3, nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=_uin, timestep=2e-3, order=2, preconditioner="faceblock",
    )


@pytest.fixture(scope="module")
def sharded_setup():
    ns = _build_ns(0.45)
    mesh = device_mesh(8)
    ops32_s, ops64_s, D_sh, plan, aux = build_sharded_fast_ops(ns, mesh)
    return ns, ops32_s, ops64_s, D_sh, plan, aux


def test_faceshard_operators_match_single_device(sharded_setup):
    """Every sharded operator (split-f32 A/B/BT, f64 residual ops, the
    skeleton preconditioner, preM) reproduces its single-device
    counterpart on random vectors up to f32 reduction-order noise."""
    ns, ops32_s, ops64_s, D_sh, plan, aux = sharded_setup
    ops32_1, D1 = equilibrated_f32_ops(ns, gs=False, split=True)
    mQ = aux["mQ"]

    rng = np.random.default_rng(3)
    u = rng.standard_normal(ns.n)
    p = rng.standard_normal(ns.Q.ndof)
    u32 = jnp.asarray(u, jnp.float32)
    p32 = jnp.asarray(p, jnp.float32)
    u_sh32 = jnp.asarray(plan.vel_to_sharded(u.astype(np.float32)))
    p_sh32 = jnp.asarray(plan.p_to_sharded(p.astype(np.float32), mQ))

    # equilibration diagonals agree on real slots
    D_back = plan.vel_to_global(np.asarray(D_sh))
    assert np.allclose(D_back, np.asarray(D1), rtol=0, atol=0)

    def back_v(y_sh):
        return plan.vel_to_global(np.asarray(y_sh))

    def back_p(y_sh):
        return plan.p_to_global(np.asarray(y_sh), mQ)

    for name, conv in (("A", back_v), ("preA", back_v)):
        y1 = np.asarray(ops32_1[name](u32))
        ys = conv(ops32_s[name](u_sh32))
        scale = np.abs(y1).max()
        assert np.abs(ys - y1).max() < 5e-5 * scale, (
            name, np.abs(ys - y1).max(), scale)

    y1 = np.asarray(ops32_1["B"](u32))
    ys = back_p(ops32_s["B"](u_sh32))
    assert np.abs(ys - y1).max() < 5e-5 * np.abs(y1).max()

    y1 = np.asarray(ops32_1["BT"](p32))
    ys = back_v(ops32_s["BT"](p_sh32))
    assert np.abs(ys - y1).max() < 5e-5 * np.abs(y1).max()

    y1 = np.asarray(ops32_1["preM"](p32))
    ys = back_p(ops32_s["preM"](p_sh32))
    assert np.abs(ys - y1).max() < 5e-6 * np.abs(y1).max()

    # f64 residual operators match the model's unequilibrated applies
    u64 = jnp.asarray(u)
    p64 = jnp.asarray(p)
    u_sh64 = jnp.asarray(plan.vel_to_sharded(u))
    p_sh64 = jnp.asarray(plan.p_to_sharded(p, mQ))
    for y1, ys in (
        (ns.A(u64), back_v(ops64_s["A"](u_sh64))),
        (ns.B(u64), back_p(ops64_s["B"](u_sh64))),
        (ns.BT(p64), back_v(ops64_s["BT"](p_sh64))),
    ):
        y1 = np.asarray(y1)
        assert np.abs(ys - y1).max() < 1e-10 * np.abs(y1).max()


def test_faceshard_solve_matches_single_device():
    """The full sharded production solve (split-f32 MINRES refinement with
    the row-panel multicolor-GS skeleton sweep — the bench's algorithm —
    on 8 virtual devices) reaches the same tolerance in the same
    refinement structure as the single-device fast path, with iteration
    parity up to fp reduction-order drift."""
    ns = _build_ns(0.35)
    mesh = device_mesh(8)

    # two_phase=False: this test pins PARITY of the sharded phase-1 driver
    # against the identical single-device driver (the 2-phase endgame has
    # its own tolerance test below)
    tol = 1e-6
    (xu, xp), r_sh, passes_sh, inner_sh, plan = sharded_fast_flagship_solve(
        ns, mesh, tol=tol, inner_tol=5e-7, inner_maxsteps=800, gs=True,
        two_phase=False)
    assert r_sh <= tol

    ops32, D = equilibrated_f32_ops(ns, gs=True, split=True)
    ops64 = dict(A=ns.A, B=ns.B, BT=ns.BT)
    f_mod = jnp.where(ns.free, ns.f - ns.A_raw(ns.u_bc), 0.0)
    g_mod = -ns.B_raw(ns.u_bc)
    x1, r1, passes1, inner1 = jax.jit(
        lambda f, g: mixed_precision_minres_refinement(
            ops64, ops32, D, f, g, tol=tol, inner_tol=5e-7,
            inner_maxsteps=800)
    )(f_mod, g_mod)
    assert float(r1) <= tol

    # iteration parity: same math, different fp summation order
    assert abs(inner_sh - int(inner1)) <= max(10, 0.1 * int(inner1)), (
        inner_sh, int(inner1))
    # solution parity at the solver-accuracy level (both at ~tol)
    du = np.abs(xu - np.asarray(x1[0])).max()
    scale = max(np.abs(np.asarray(x1[0])).max(), 1e-30)
    assert du / scale < 2e-3, (du, scale)


def test_faceshard_solve_reaches_production_tolerance():
    """The sharded solve certifies the FULL production tolerance 1e-8:
    split-f32 refinement passes (whose old
    ~4e-7 'floor' was the inner MINRES's absolute stopping test firing on
    the shrinking per-pass rhs — fixed by abs_test=False) chained with the
    phase-2 true-f64 equilibrated correction passes
    (mixed_precision_minres_refinement_2phase)."""
    ns = _build_ns(0.45)
    mesh = device_mesh(8)
    (xu, xp), rel, passes, inner, plan = sharded_fast_flagship_solve(
        ns, mesh, tol=1e-8, inner_tol=5e-7, inner_maxsteps=800, gs=True)
    assert rel <= 1e-8, (rel, passes, inner)
    # the solution really solves the unsharded system
    f_mod = jnp.where(ns.free, ns.f - ns.A_raw(ns.u_bc), 0.0)
    g_mod = -ns.B_raw(ns.u_bc)
    r0 = f_mod - ns.A(jnp.asarray(xu)) - ns.BT(jnp.asarray(xp))
    r1 = g_mod - ns.B(jnp.asarray(xu))
    rel_true = float(
        jnp.sqrt(jnp.vdot(r0, r0) + jnp.vdot(r1, r1))
        / jnp.sqrt(jnp.vdot(f_mod, f_mod) + jnp.vdot(g_mod, g_mod))
    )
    assert rel_true <= 2e-8, rel_true
