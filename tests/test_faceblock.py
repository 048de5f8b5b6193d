"""Parity tests for the scatter-free face-block applies (ops/faceblock.py)
against the reference gather/scatter formulations on a small 3D mesh."""

import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.fem.hdiv3d import HDiv3D
from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.models.stokes_hybrid3d import (
    HybridVelocitySpace3D,
    VectorFacet3D,
)
from navier_stokes_tpu.ops import assembly as asm
from navier_stokes_tpu.ops.faceblock import FaceBlockLayout, face_star_smoother


@pytest.fixture(scope="module")
def setup():
    mesh = channel_with_cylinder_mesh_3d(0.35)
    V = HDiv3D(mesh, 2, dirichlet="inlet|wall|cyl")
    F = VectorFacet3D(mesh, 1, dirichlet="inlet|wall|cyl|outlet")
    Xv = HybridVelocitySpace3D(V, F)
    lay = FaceBlockLayout(Xv)
    rng = np.random.default_rng(3)
    return mesh, Xv, lay, rng


def test_layout_roundtrip(setup):
    _, Xv, lay, rng = setup
    u = jnp.asarray(rng.standard_normal(Xv.ndof))
    uF, ui = lay.split(u)
    assert np.allclose(np.asarray(lay.join(uF, ui)), np.asarray(u))


def test_elem_apply_matches_gather_scatter(setup):
    _, Xv, lay, rng = setup
    ne, nb = np.asarray(Xv.element_dofs).shape
    A = rng.standard_normal((ne, nb, nb))
    u = jnp.asarray(rng.standard_normal(Xv.ndof))
    y_ref = asm.apply_local_matrices(
        jnp.asarray(A), jnp.asarray(Xv.element_dofs), Xv.ndof, u
    )
    y = lay.elem_apply(jnp.asarray(lay.permute_blocks(A)))(u)
    assert float(jnp.linalg.norm(y - y_ref) / jnp.linalg.norm(y_ref)) < 1e-13


def test_elem_apply_multi(setup):
    _, Xv, lay, rng = setup
    ne, nb = np.asarray(Xv.element_dofs).shape
    A1 = rng.standard_normal((ne, nb, nb))
    A2 = rng.standard_normal((ne, nb, nb))
    u = jnp.asarray(rng.standard_normal(Xv.ndof))
    ed = jnp.asarray(Xv.element_dofs)
    y_ref = asm.apply_local_matrices(
        jnp.asarray(A1), ed, Xv.ndof, u
    ) + 0.5 * asm.apply_local_matrices(jnp.asarray(A2), ed, Xv.ndof, u)
    ap = lay.elem_apply_multi(
        [
            (jnp.asarray(lay.permute_blocks(A1)), None),
            (jnp.asarray(lay.permute_blocks(A2)), 0.5),
        ]
    )
    y = ap(u)
    assert float(jnp.linalg.norm(y - y_ref) / jnp.linalg.norm(y_ref)) < 1e-13


def test_skel_apply(setup):
    _, Xv, lay, rng = setup
    hd = Xv.hdiv
    nbv, nfd_v = hd.n_basis, hd.n_face_dofs
    n_int = hd.bases[0].n_cell
    nfac = Xv.facet.n_face * 4
    loc_skel = np.concatenate(
        [np.arange(4 * nfd_v), np.arange(nbv, nbv + nfac)]
    )
    eldofs_skel = np.asarray(Xv.element_dofs)[:, loc_skel]
    ne = lay.ne
    ns = len(loc_skel)
    S = rng.standard_normal((ne, ns, ns))
    u = jnp.asarray(rng.standard_normal(Xv.ndof))
    # reference: zero interiors, gather/scatter on skeleton dofs
    y_ref = asm.apply_local_matrices(
        jnp.asarray(S), jnp.asarray(eldofs_skel), Xv.ndof, u
    )
    y = lay.skel_apply(jnp.asarray(lay.permute_skel_blocks(S)))(u)
    # y has zero interiors; y_ref too (S only touches skeleton dofs)
    assert float(jnp.linalg.norm(y - y_ref) / jnp.linalg.norm(y_ref)) < 1e-13


def test_rect_apply(setup):
    _, Xv, lay, rng = setup
    ne, nb = np.asarray(Xv.element_dofs).shape
    m = 4
    B_loc = rng.standard_normal((ne, m, nb))
    eldofs_p = np.arange(ne * m).reshape(ne, m)
    u = jnp.asarray(rng.standard_normal(Xv.ndof))
    p = jnp.asarray(rng.standard_normal(ne * m))
    ue = u[jnp.asarray(Xv.element_dofs)]
    pe_ref = jnp.einsum("epi,ei->ep", jnp.asarray(B_loc), ue).reshape(-1)
    B, BT = lay.rect_apply(
        jnp.asarray(lay.permute_cols(B_loc)), eldofs_p, ne * m
    )
    assert float(jnp.linalg.norm(B(u) - pe_ref) / jnp.linalg.norm(pe_ref)) < 1e-13
    yt_ref = asm.scatter_add(
        jnp.einsum("epi,ep->ei", jnp.asarray(B_loc), p.reshape(ne, m)),
        jnp.asarray(Xv.element_dofs), Xv.ndof,
    )
    assert float(jnp.linalg.norm(BT(p) - yt_ref) / jnp.linalg.norm(yt_ref)) < 1e-13


def test_face_star_smoother_matches_block_jacobi(setup):
    from navier_stokes_tpu.models.auxspace3d import _edge_star_skeleton_blocks
    from navier_stokes_tpu.precond.jacobi import (
        block_jacobi,
        extract_blocks_from_local,
    )

    _, Xv, lay, rng = setup
    hd = Xv.hdiv
    nbv, nfd_v = hd.n_basis, hd.n_face_dofs
    nfac = Xv.facet.n_face * 4
    loc_skel = np.concatenate(
        [np.arange(4 * nfd_v), np.arange(nbv, nbv + nfac)]
    )
    eldofs_skel = np.asarray(Xv.element_dofs)[:, loc_skel]
    ne, ns = eldofs_skel.shape
    S_half = rng.standard_normal((ne, ns, ns))
    S = S_half + S_half.transpose(0, 2, 1) + 60.0 * np.eye(ns)[None]

    fmask = Xv.free_mask
    blks = [
        np.asarray([d for d in b if fmask[d]], np.int32)
        for b in _edge_star_skeleton_blocks(Xv)
    ]
    blks = [b for b in blks if len(b)]
    dofs, mats = extract_blocks_from_local(S, eldofs_skel, blks, Xv.ndof)
    ref_smooth = block_jacobi(dofs, jnp.asarray(mats), Xv.ndof)

    sm = face_star_smoother(
        lay, lay.permute_skel_blocks(S), Xv.free_mask, jnp.float64
    )
    x = jnp.asarray(rng.standard_normal(Xv.ndof) * fmask)
    y_ref = ref_smooth(x) * jnp.asarray(fmask)
    y = sm.smooth(x)
    assert float(jnp.linalg.norm(y - y_ref) / jnp.linalg.norm(y_ref)) < 1e-12


def _cancelling_split(T64, xe):
    """Make columns 0 and 1 of every block cancel against the element
    vector ``xe`` (each element's row sum ~1e-5 of its terms), and split
    the table into an f32 (hi, lo) pair."""
    T64 = T64.copy()
    T64[:, :, 0] *= 1e5
    T64[:, :, 1] = -T64[:, :, 0] * (xe[:, 0] / xe[:, 1])[:, None]
    hi = T64.astype(np.float32)
    lo = (T64 - hi.astype(np.float64)).astype(np.float32)
    return T64, hi, lo


def test_elem_apply_comp_cancellation(setup):
    """The phase-2 f64 apply of a split (hi, lo) pair keeps f64 accuracy
    under heavy row cancellation — the failure mode that floors a plain
    3x-f32 double-single apply near 1e-6 — against a host f64 CSR matvec
    of the same operator."""
    _, Xv, lay, rng = setup
    ed = np.asarray(Xv.element_dofs)[:, lay.perm]  # face-major columns
    ne, nb = ed.shape
    u = rng.standard_normal(Xv.ndof)
    A64, A_hi, A_lo = _cancelling_split(rng.standard_normal((ne, nb, nb)),
                                        u[ed])
    got = np.asarray(lay.elem_apply_comp(A_hi, A_lo)(jnp.asarray(u)))
    want = asm.assemble_csr(A64, ed, Xv.ndof) @ u
    scale = asm.assemble_csr(np.abs(A64), ed, Xv.ndof) @ np.abs(u)
    err = np.abs(got - want) / np.maximum(scale, 1e-300)
    assert err.max() < 1e-13, err.max()


def test_rect_apply_comp_cancellation(setup):
    """(B, BT) of the phase-2 f64 pressure coupling, same cancellation
    test against host f64 CSR products."""
    _, Xv, lay, rng = setup
    ed = np.asarray(Xv.element_dofs)[:, lay.perm]
    ne, nb = ed.shape
    m = 4
    eldofs_p = np.arange(ne * m).reshape(ne, m)
    u = rng.standard_normal(Xv.ndof)
    p = rng.standard_normal(ne * m)
    B64, B_hi, B_lo = _cancelling_split(rng.standard_normal((ne, m, nb)),
                                        u[ed])
    B, BT = lay.rect_apply_comp(B_hi, B_lo, eldofs_p, ne * m)
    Bc = asm.assemble_csr_rect(B64, eldofs_p, ed, ne * m, Xv.ndof)
    Bs = asm.assemble_csr_rect(np.abs(B64), eldofs_p, ed, ne * m, Xv.ndof)
    err = np.abs(np.asarray(B(jnp.asarray(u))) - Bc @ u) / np.maximum(
        Bs @ np.abs(u), 1e-300)
    assert err.max() < 1e-13, err.max()
    errT = np.abs(np.asarray(BT(jnp.asarray(p))) - Bc.T @ p) / np.maximum(
        Bs.T @ np.abs(p), 1e-300)
    assert errT.max() < 1e-13, errT.max()
