"""Parity: face-block (fast) skeleton preconditioner vs the dof-level
gather/scatter formulation — same math, different index machinery."""

import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS


H = 0.41


def uin(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = 16 * p[:, 1] * (H - p[:, 1]) * p[:, 2] * (H - p[:, 2]) / H**4
    return out


@pytest.fixture(scope="module")
def model():
    mesh = channel_with_cylinder_mesh_3d(0.35)
    return NavierStokesMCS(
        mesh, nu=0.001, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=uin, timestep=2e-3, order=2, dtype=jnp.float64,
    )


@pytest.mark.parametrize("gs", [False, True])
def test_skeleton_fast_matches_slow(model, gs):
    from navier_stokes_tpu.models.auxspace3d import (
        build_skeleton_preconditioner_3d,
    )

    m = model
    pre_fast = build_skeleton_preconditioner_3d(
        m.Xv, m.A_cond_np, m._dirich, jnp.float64,
        coarse_coefficient=m.nu, gs=gs, fast=True,
    )
    pre_slow = build_skeleton_preconditioner_3d(
        m.Xv, m.A_cond_np, m._dirich, jnp.float64,
        coarse_coefficient=m.nu, gs=gs, fast=False,
    )
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal(m.n))
    yf = pre_fast(x)
    ys = pre_slow(x)
    rel = float(jnp.linalg.norm(yf - ys) / jnp.linalg.norm(ys))
    if gs:
        # the GS sweep depends on the block/color ORDER, and the fast path
        # buckets blocks by size before coloring — the two preconditioners
        # are the same construction but not the same operator.  Check the
        # fast one is in the same ballpark and exactly SYMMETRIC (the SPD
        # property BPCG needs), rather than bitwise parity.
        assert rel < 0.5
        a = x * m.free
        b = jnp.asarray(rng.standard_normal(m.n)) * m.free
        lhs = float(jnp.vdot(pre_fast(a), b))
        rhs_ = float(jnp.vdot(a, pre_fast(b)))
        assert abs(lhs - rhs_) < 1e-8 * max(abs(lhs), 1.0)
    else:
        # the two formulations invert each block in a different dof order;
        # on the UNequilibrated condensed operator (diagonal spans ~1e12)
        # the LU rounding difference shows up at ~kappa(block)*eps.
        assert rel < 1e-7


@pytest.mark.parametrize("gs", [False, True])
def test_auxspace3d_gs_builder(model, gs):
    """build_auxspace_preconditioner_3d's gs=True path builds and yields a
    symmetric operator that contracts the A-residual."""
    from navier_stokes_tpu.models.auxspace3d import (
        build_auxspace_preconditioner_3d,
    )

    m = model
    pre = build_auxspace_preconditioner_3d(
        m.Xv, m.A_cond_np, m._dirich, jnp.float64,
        coarse_coefficient=m.nu, blocks="face", gs=gs,
        A_apply=m.A if gs else None,
    )
    rng = np.random.default_rng(11)
    a = jnp.asarray(rng.standard_normal(m.n)) * m.free
    b = jnp.asarray(rng.standard_normal(m.n)) * m.free
    lhs = float(jnp.vdot(pre(a), b))
    rhs_ = float(jnp.vdot(a, pre(b)))
    assert abs(lhs - rhs_) < 1e-8 * max(abs(lhs), 1.0)
    # positive definiteness of pre(A).A — the property BPCG needs
    from navier_stokes_tpu.linalg.lanczos import lanczos_eigenvalues

    lams = lanczos_eigenvalues(m.A, pre, a, 20)
    assert float(jnp.min(lams)) > 0.0, np.asarray(lams)


def test_model_applies_match_flat(model):
    """The model's face-block A/B/BT equal the flat gather/scatter ones."""
    from navier_stokes_tpu.ops import assembly as asm

    m = model
    rng = np.random.default_rng(6)
    u = jnp.asarray(rng.standard_normal(m.n))
    p = jnp.asarray(rng.standard_normal(m.Q.ndof))
    eldofs = jnp.asarray(m.Xv.element_dofs)
    A_flat = jnp.asarray(m.A_cond_np)
    y_ref = asm.apply_local_matrices(A_flat, eldofs, m.n, u)
    rel = float(jnp.linalg.norm(m.A_raw(u) - y_ref) / jnp.linalg.norm(y_ref))
    assert rel < 1e-12

    B_flat = jnp.asarray(np.asarray(m._B_loc))
    ue = u[eldofs]
    pe_ref = jnp.einsum("epi,ei->ep", B_flat, ue).reshape(-1)
    rel = float(
        jnp.linalg.norm(m.B_raw(u) - pe_ref) / jnp.linalg.norm(pe_ref)
    )
    assert rel < 1e-12


def test_gs_row_sweep_matches_recompute(model):
    """The row-panel GS sweep (color_row_groups/solve_color_rows — fresh
    per-color residual from row panels of S, 3 S-streams per direction)
    is algebraically IDENTICAL to the recompute sweep (full S apply before
    every color) given the same colors: parity to fp roundoff."""
    from navier_stokes_tpu.ops.faceblock import (
        FaceBlockLayout,
        face_star_smoother,
    )
    from navier_stokes_tpu.precond.multicolor import color_blocks

    m = model
    V = m.Xv
    hd = V.hdiv
    nbv = hd.n_basis
    n_face_tot = 4 * hd.n_face_dofs
    nfac = V.facet.n_face * 4
    loc_int = np.arange(n_face_tot, nbv)
    loc_skel = np.concatenate(
        [np.arange(n_face_tot), np.arange(nbv, nbv + nfac)]
    )
    A_np = m.A_cond_np
    A_ii = A_np[:, loc_int[:, None], loc_int[None, :]]
    A_is = A_np[:, loc_int[:, None], loc_skel[None, :]]
    A_ss = A_np[:, loc_skel[:, None], loc_skel[None, :]]
    S_loc = A_ss - np.matmul(
        A_is.transpose(0, 2, 1), np.matmul(np.linalg.inv(A_ii), A_is)
    )
    lay = FaceBlockLayout(V)
    S_perm = lay.permute_skel_blocks(S_loc)
    sm = face_star_smoother(lay, S_perm, np.asarray(V.free_mask),
                            jnp.float64)
    nfb = lay.nfb
    blocks_fb = [
        (np.asarray(f)[:, None] * nfb + np.arange(nfb)[None, :]).ravel()
        for f in sm.block_faces
    ]
    colors = color_blocks(blocks_fb, lay.nface * nfb, lay.eldofs_fb)
    groups_old = sm.color_groups(colors)
    groups_new = sm.color_row_groups(colors, S_perm, jnp.float64)
    S_perm_j = jnp.asarray(S_perm)
    freeF = sm.freeF

    def S_faces(xF):
        xF = jnp.where(freeF, xF, 0.0)
        ue = xF[lay.efaces].reshape(lay.ne, lay.n_skel)
        ye = jnp.einsum("eij,ej->ei", S_perm_j, ue)
        return jnp.where(freeF, lay.scatter_skel(ye), 0.0)

    rng = np.random.default_rng(3)
    xF = jnp.asarray(rng.standard_normal((lay.nface, nfb))) * freeF

    y_old = jnp.zeros_like(xF)
    for g in groups_old:
        y_old = y_old + sm.solve_color(g, xF - S_faces(y_old))
    for g in reversed(groups_old):
        y_old = y_old + sm.solve_color(g, xF - S_faces(y_old))

    # transposed (SoA) padded convention (round 5): the iterate is
    # (nfb, nface+1) with one trailing zero column
    xPT = jnp.concatenate([xF, jnp.zeros((1, nfb), xF.dtype)]).T
    y_new = None
    for g in groups_new:
        dy = sm.solve_color_rows(g, xPT, y_new)
        y_new = dy if y_new is None else y_new + dy
    for g in reversed(groups_new):
        y_new = y_new + sm.solve_color_rows(g, xPT, y_new)
    y_new = y_new.T[:-1]

    rel = float(jnp.linalg.norm(y_new - y_old) / jnp.linalg.norm(y_old))
    assert rel < 1e-10, f"row-panel sweep deviates {rel:.3e}"


@pytest.mark.parametrize("gs", [False, True])
def test_skeleton_bf16_store(model, gs):
    """bf16-stored smoother tables (NSTPU_SMOOTHER_BF16 in the bench path)
    keep the preconditioner symmetric and within ~1% of the f32-stored one
    — arithmetic stays f32 via mixed-precision einsums, the table stream
    halves."""
    from navier_stokes_tpu.models.auxspace3d import (
        build_skeleton_preconditioner_3d,
    )

    m = model
    pre32 = build_skeleton_preconditioner_3d(
        m.Xv, m.A_cond_np, m._dirich, jnp.float32,
        coarse_coefficient=m.nu, gs=gs,
    )
    pre_bf = build_skeleton_preconditioner_3d(
        m.Xv, m.A_cond_np, m._dirich, jnp.float32,
        coarse_coefficient=m.nu, gs=gs, store_dtype=jnp.bfloat16,
    )
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal(m.n), jnp.float32)
    y32 = pre32(x)
    ybf = pre_bf(x)
    assert ybf.dtype == jnp.float32
    rel = float(jnp.linalg.norm(ybf - y32) / jnp.linalg.norm(y32))
    # the GS sweep composes several bf16-table applies (forward sweep,
    # coarse, backward sweep), compounding the ~0.4% per-table rounding;
    # measured 5.4% at maxh=0.35 — preconditioner-quality noise, not a
    # correctness issue (symmetry, checked below, is what SPD needs)
    assert rel < (0.15 if gs else 0.05), f"bf16 tables deviate {rel:.3f}"
    # symmetry (SPD requirement for the Krylov preconditioner)
    a = (x * m.free).astype(jnp.float32)
    b = (jnp.asarray(rng.standard_normal(m.n)) * m.free).astype(jnp.float32)
    lhs = float(jnp.vdot(pre_bf(a), b))
    rhs_ = float(jnp.vdot(a, pre_bf(b)))
    assert abs(lhs - rhs_) < 1e-4 * max(abs(lhs), 1.0)


def test_skeleton_ext_bf16(model):
    """ext_store_dtype=bf16 (the bench default, NSTPU_SMOOTHER_BF16=ext):
    only the once-per-apply harmonic-extension/interior tables are bf16 —
    measured iteration-count-neutral (650 vs 628 on the 3D channel) where
    full-table bf16 doubled the count.  The operator stays symmetric and
    close to the f32-stored one."""
    from navier_stokes_tpu.models.auxspace3d import (
        build_skeleton_preconditioner_3d,
    )

    m = model
    pre32 = build_skeleton_preconditioner_3d(
        m.Xv, m.A_cond_np, m._dirich, jnp.float32,
        coarse_coefficient=m.nu, gs=True,
    )
    pre_e = build_skeleton_preconditioner_3d(
        m.Xv, m.A_cond_np, m._dirich, jnp.float32,
        coarse_coefficient=m.nu, gs=True, ext_store_dtype=jnp.bfloat16,
    )
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal(m.n), jnp.float32)
    rel = float(jnp.linalg.norm(pre_e(x) - pre32(x))
                / jnp.linalg.norm(pre32(x)))
    assert rel < 0.02, f"ext-bf16 deviates {rel:.4f}"
    a = (x * m.free).astype(jnp.float32)
    b = (jnp.asarray(rng.standard_normal(m.n)) * m.free).astype(jnp.float32)
    lhs = float(jnp.vdot(pre_e(a), b))
    rhs_ = float(jnp.vdot(a, pre_e(b)))
    assert abs(lhs - rhs_) < 1e-4 * max(abs(lhs), 1.0)
