"""Parity: device-derived preconditioner tables vs host-built ones.

With device tables on (the default wherever the default device is an
accelerator; NSTPU_DEVICE_TABLES=force here on the CPU) the ENTIRE setup derivation downstream
of the model's already-uploaded f64 operator runs on device — the Jacobi
equilibration and hi/lo split (solvers/refinement.py
_equilibrated_split_device), the interior Schur complement
A_ii^-1 / A_ii^-1 A_is / S (models/auxspace3d._device_schur_fb, batched
f32 LU + matmuls), the edge-star block inverses, the GS residual row
panels, and the extension transpose (ops/faceblock.py
FaceStarSmoother._device_bucket_inverses + color_row_groups).  The host
path makes 4-5 single-core numpy passes over the GB-scale table and
uploads ~3 full-S equivalents of panels plus ~GB inverse tables.

Expected deltas: the equilibrated hi/lo OPERATOR split is bitwise (same
IEEE f64 expression, device vs host); the preconditioner differs at the
f32-Schur level — eps32 * kappa(A_ii) on the interior inverse, f32 matmul
accumulation on S — a fixed-linear-operator perturbation (measured ~3e-4
relative at maxh=0.45) that must stay iteration-neutral, which the
slow-tier full-solve test pins.
"""

import os

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


@pytest.fixture(scope="module")
def model():
    mesh = channel_with_cylinder_mesh_3d(0.45)
    return NavierStokesMCS(
        mesh, nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=_uin, timestep=2e-3, order=2, preconditioner="faceblock",
    )


@pytest.mark.parametrize("gs", [False, True])
def test_device_tables_match_host(model, gs, monkeypatch):
    m = model
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(m.n), jnp.float32)
    monkeypatch.setenv("NSTPU_DEVICE_TABLES", "0")
    ops_h, _ = equilibrated_f32_ops(m, gs=gs, split=True)
    monkeypatch.setenv("NSTPU_DEVICE_TABLES", "force")
    ops_d, _ = equilibrated_f32_ops(m, gs=gs, split=True)
    # operator tables are derived on host vs device but hold identical
    # f32 values
    ya, yb = ops_h["A"](x), ops_d["A"](x)
    assert float(jnp.linalg.norm(yb - ya)) == 0.0
    # preconditioner: the device path computes the interior Schur chain in
    # f32 (batched LU + matmuls) vs the host's f64 — measured 3.4e-4
    # relative at this config, a fixed perturbation of a PRECONDITIONER
    # (iteration neutrality is pinned by the slow-tier test below)
    yh, yd = ops_h["preA"](x), ops_d["preA"](x)
    rel = float(jnp.linalg.norm(yd - yh) / jnp.linalg.norm(yh))
    assert rel < 5e-3, rel


def test_device_tables_iteration_parity(model, monkeypatch):
    """Full production solve with device-derived tables stays within a few
    iterations of the host-built stack (measured 347 vs 351 on this
    config on the CPU)."""
    monkeypatch.setenv("NSTPU_COARSE_TARGET", "1.6")
    monkeypatch.setenv("NSTPU_SMOOTHER_BF16", "ext,inv")
    ns = model
    ops64 = dict(A=ns.A, B=ns.B, BT=ns.BT)
    f_mod = jnp.where(ns.free, ns.f - ns.A_raw(ns.u_bc), 0.0)
    g_mod = -ns.B_raw(ns.u_bc)
    inners = {}
    for mode in ("0", "force"):
        monkeypatch.setenv("NSTPU_DEVICE_TABLES", mode)
        ops32, D = equilibrated_f32_ops(ns, gs=True, split=True)
        x, r, passes, inner = jax.jit(
            lambda f, g, ops32=ops32, D=D: mixed_precision_minres_refinement(
                ops64, ops32, D, f, g, tol=1e-6, inner_tol=5e-7,
                inner_maxsteps=2000)
        )(f_mod, g_mod)
        assert float(r) <= 1e-6, (mode, float(r))
        inners[mode] = int(inner)
    assert inners["force"] <= 1.15 * inners["0"], inners
