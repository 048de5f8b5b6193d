"""Iteration-count regression guard for the production solver stack.

The bench's round-3 gains (354 inner its at 243k dofs) rest on a stack of
knobs (GS row-panel sweep, coarse damping target, split-f32 operators,
adaptive tolerances).  This CPU-measurable guard pins the total inner
iteration count of the SAME operator/preconditioner stack at a small
bench config, so a knob or preconditioner regression shows up in CI
before a hardware bench does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
from navier_stokes_tpu.solvers.refinement import (
    equilibrated_f32_ops,
    mixed_precision_minres_refinement,
)

H = 0.41


def _uin(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = 16 * p[:, 1] * (H - p[:, 1]) * p[:, 2] * (H - p[:, 2]) / H**4
    return out


def test_bench_iteration_count_guard(monkeypatch):
    """The 3D MCS channel at maxh=0.45 with the bench's defaults (GS
    row-panel sweep, NSTPU_COARSE_TARGET=1.6, ext+inv bf16 tables,
    split-f32 operators) must reach 1e-6 within the pinned inner-iteration
    budget.  (1e-6, not the bench's 1e-8: the fixed-tol refinement driver
    used here floors near 4e-7 at this coarse mesh — the bench's
    adaptive-pass logic goes deeper at bench scale.)  Measured 351
    inner its on the guard config (round 4); the bound carries ~30%
    headroom for fp drift across jax versions — an algorithmic regression
    (lost coarse damping, broken sweep, bad knob default) costs 2-5x
    iterations and trips it immediately."""
    monkeypatch.setenv("NSTPU_COARSE_TARGET", "1.6")
    monkeypatch.setenv("NSTPU_SMOOTHER_BF16", "ext,inv")

    mesh3 = channel_with_cylinder_mesh_3d(0.45)
    ns = NavierStokesMCS(
        mesh3, nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=_uin, timestep=2e-3, order=2, preconditioner="faceblock",
    )
    ops32, D = equilibrated_f32_ops(ns, gs=True, split=True)
    ops64 = dict(A=ns.A, B=ns.B, BT=ns.BT)
    f_mod = jnp.where(ns.free, ns.f - ns.A_raw(ns.u_bc), 0.0)
    g_mod = -ns.B_raw(ns.u_bc)
    x, r, passes, inner = jax.jit(
        lambda f, g: mixed_precision_minres_refinement(
            ops64, ops32, D, f, g, tol=1e-6, inner_tol=5e-7,
            inner_maxsteps=2000)
    )(f_mod, g_mod)
    assert float(r) <= 1e-6, float(r)
    assert int(inner) <= 460, int(inner)
