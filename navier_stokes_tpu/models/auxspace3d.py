"""Auxiliary-space P1 coarse correction for 3D [H(div) | facet] systems.

3D counterpart of the 2D transfer in models/stokes_hybrid.py (the
reference's MypreA structure): embed a continuous vector-P1 field into the
BDM+facet space by
  * face dofs: moments of the linear field (exact),
  * facet dofs: frame coefficients of its tangential trace (exact),
  * interior dofs: per-element L2-optimal completion (reproduces vector
    linears exactly, so the Galerkin coarse operator is exactly the vector
    P1 Laplacian),
plus the exact transpose, combined additively with a face-block smoother.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.quadrature import tetrahedron_rule, triangle_rule
from ..fem.reference import triangle_modal
from ..fem.spaces import H1
from ..ops import assembly as asm
from ..precond.twolevel import coarse_p1_solver


def hybrid_h1_embedding_3d(V, dtype=jnp.float64):
    """(T, TT) for a HybridVelocitySpace3D; coarse vectors are (3*nv,)
    component-major."""
    mesh = V.mesh
    hd = V.hdiv
    k = hd.order
    nfd_v = hd.n_face_dofs
    nss = V.facet.n_scalar
    nfd_f = V.facet.n_face
    nv = mesh.nv
    nV = V.ndof

    # c_{j,v} = int_T phi_j lambda_v over the unit triangle.  Tabulated
    # separately per order: triangle_modal's mode ordering means the first
    # columns of a higher-order tabulation are NOT the lower-order modes.
    rule2 = triangle_rule(2 * max(k, V.facet.order) + 2)
    phi_v, _ = triangle_modal(rule2.points, k)
    phi_f, _ = triangle_modal(rule2.points, V.facet.order)
    lam2 = np.concatenate(
        [1 - rule2.points.sum(1, keepdims=True), rule2.points], axis=1
    )
    cjv = np.einsum("q,qj,qv->jv", rule2.weights, phi_v, lam2)  # (nphi, 3)
    cjv_fac = np.einsum("q,qj,qv->jv", rule2.weights, phi_f, lam2)

    pts = mesh.points
    faces = mesh.faces  # sorted vertices
    fv = pts[faces]
    E1 = fv[:, 1] - fv[:, 0]
    E2 = fv[:, 2] - fv[:, 0]
    nsc = np.cross(E1, E2)  # (nface, 3) scaled normal (Piola moment normal)
    G = np.stack(
        [
            np.stack([np.einsum("fc,fc->f", E1, E1), np.einsum("fc,fc->f", E1, E2)], -1),
            np.stack([np.einsum("fc,fc->f", E2, E1), np.einsum("fc,fc->f", E2, E2)], -1),
        ],
        axis=1,
    )  # (nface, 2, 2)
    Ginv = np.linalg.inv(G)
    nhat = nsc / np.linalg.norm(nsc, axis=1, keepdims=True)

    del nhat  # (unit normals not needed: moments use the scaled normal)

    # ---- interior completion tables ----------------------------------
    n_int = hd.bases[0].n_cell
    nbv = hd.n_basis
    n_face_tot = 4 * nfd_v
    J, detJ, _ = mesh.element_jacobians
    vol = tetrahedron_rule(2 * k + 2)
    vals_ref, _ = hd.tabulate_elements(vol.points)  # (ne, nq, nb, 3)
    M_e = np.einsum("eca,ecb->eab", J, J) / detJ[:, None, None]
    Gm = np.einsum(
        "q,eqia,eab,eqjb->eij", vol.weights, vals_ref, M_e, vals_ref,
        optimize=True,
    )
    lam3 = np.concatenate(
        [1 - vol.points.sum(1, keepdims=True), vol.points], axis=1
    )  # (nq, 4)
    t_mat = np.einsum(
        "q,eqia,eca,qv->eicv", vol.weights, vals_ref, J, lam3, optimize=True
    ).reshape(mesh.ne, nbv, 12)  # (c, v) flattened c*4+v

    # S[e, local-face-dof, (c,v)]: global face moments from element vertex
    # values (vertex positions of each face's sorted-global vertices)
    els = mesh.elements
    S = np.zeros((mesh.ne, n_face_tot, 12))
    for lf in range(4):
        fid = mesh.element_faces[:, lf]
        gvert = faces[fid]  # (ne, 3) sorted global ids
        # position of each face vertex among the element's vertices
        pos = np.argmax(els[:, :, None] == gvert[:, None, :], axis=1)  # (ne,3)
        for j in range(nfd_v):
            for v in range(3):
                for c in range(3):
                    S[np.arange(mesh.ne), lf * nfd_v + j, c * 4 + pos[:, v]] += (
                        cjv[j, v] * nsc[fid, c]
                    )
    G_ii = Gm[:, n_face_tot:, n_face_tot:]
    G_ie = Gm[:, n_face_tot:, :n_face_tot]
    rhs_int = t_mat[:, n_face_tot:, :] - np.einsum(
        "eij,ejv->eiv", G_ie, S, optimize=True
    )
    M_int = np.linalg.solve(G_ii, rhs_int)  # (ne, n_int, 12)
    off_c = mesh.nface * nfd_v
    nface = mesh.nface
    ne = mesh.ne
    nhd = hd.ndof

    # ---- padded-ELL sparse transfer (host-assembled) -------------------
    # T is a FIXED sparse operator (<= 12 nnz per fine row: one face's 3
    # vertices x 3 components, or one element's 4 x 3), so both transfer
    # directions are single gather->einsum ELL streams.  The previous
    # closure formulation scattered with .at[].add/.set, whose colliding
    # scalar updates made the transfer, not the coarse SOLVE, the cost of
    # the coarse correction.
    import scipy.sparse as sp

    from ..precond.amg import _ell

    # part 1: hdiv face-moment rows  T[f*nfd_v+j, c*nv+faces[f,v]]
    #         = cjv[j,v] * nsc[f,c]
    r1 = (np.arange(nface)[:, None, None, None] * nfd_v
          + np.arange(nfd_v)[None, :, None, None])            # (f,j,1,1)
    c1 = (np.arange(3)[None, None, None, :] * nv
          + faces[:, None, :, None])                          # (f,1,v,c)
    v1 = (cjv[:nfd_v][None, :, :, None]
          * nsc[:, None, None, :])                            # (f,j,v,c)
    r1b, c1b, v1b = np.broadcast_arrays(r1, c1, v1)

    # part 2: facet frame rows  T[nhd+f*nfd_f+(j*2+d), c*nv+faces[f,v]]
    #         = cjv_fac[j,v] * (Ginv[f] @ E[f])[d,c]
    E = np.stack([E1, E2], axis=1)                            # (f,2,3)
    W = np.einsum("fde,fec->fdc", Ginv, E)                    # (f,2,3)
    r2 = (nhd + np.arange(nface)[:, None, None, None, None] * nfd_f
          + (np.arange(nss)[None, :, None, None, None] * 2
             + np.arange(2)[None, None, :, None, None]))      # (f,j,d,1,1)
    c2 = (np.arange(3)[None, None, None, None, :] * nv
          + faces[:, None, None, :, None])                    # (f,1,1,v,c)
    v2 = (cjv_fac[:nss][None, :, None, :, None]
          * W[:, None, :, None, :])                           # (f,j,d,v,c)
    r2b, c2b, v2b = np.broadcast_arrays(r2, c2, v2)

    # part 3: interior completion rows  T[off_c+e*n_int+i, c*nv+els[e,v]]
    #         = M_int[e,i,c*4+v]
    r3 = (off_c + np.arange(ne)[:, None, None, None] * n_int
          + np.arange(n_int)[None, :, None, None])            # (e,i,1,1)
    c3 = (np.arange(3)[None, None, :, None] * nv
          + els[:, None, None, :])                            # (e,1,c,v)
    v3 = M_int.reshape(ne, n_int, 3, 4)                       # (e,i,c,v)
    r3b, c3b, v3b = np.broadcast_arrays(r3, c3, v3)

    Tm = sp.coo_matrix(
        (
            np.concatenate([v1b.ravel(), v2b.ravel(), v3b.ravel()]),
            (
                np.concatenate([r1b.ravel(), r2b.ravel(), r3b.ravel()]),
                np.concatenate([c1b.ravel(), c2b.ravel(), c3b.ravel()]),
            ),
        ),
        shape=(nV, 3 * nv),
    ).tocsr()
    Tm.eliminate_zeros()
    Ti, Tv = _ell(Tm, dtype)
    Tt = Tm.T.tocsr()
    Tt.eliminate_zeros()
    Ri, Rv = _ell(Tt, dtype)

    def T(c):
        return jnp.einsum("nw,nw->n", Tv, c[Ti])

    def TT(x):
        return jnp.einsum("nw,nw->n", Rv, x[Ri])

    return T, TT


def hybrid_h1_face_transfer(V, lay, dtype=jnp.float64):
    """Face-layout P1 transfer for the SKELETON coarse correction:
    ``TF (nv, 3) -> (nface, nfb)`` and its exact transpose ``TFt``.

    The skeleton preconditioner only ever uses the FACE rows of the
    embedding (interiors enter as zeros and leave discarded — the harmonic
    extension owns them), and those rows are per-face dense maps from the
    face's 3 vertices x 3 components: yF[f] = M_F[f] @ c[faces[f]].  So
    the transfer is ONE table stream (ops/table_apply.make_table_apply,
    ~0.7 MB of tables) plus a 48k-index vertex gather — no dof-granular
    index ops.  (A padded-ELL dof-level rendering measured 47 ms per
    coarse apply at 243k dofs — millions of scalar gathers; the closure
    form with .at[].add scatters measured 7.2 ms; this one is ~1 ms.)
    """
    from ..ops.table_apply import make_table_apply

    mesh = V.mesh
    hd = V.hdiv
    k = hd.order
    nfd_v = hd.n_face_dofs
    nss = V.facet.n_scalar
    nface = mesh.nface
    nfb = lay.nfb

    rule2 = triangle_rule(2 * max(k, V.facet.order) + 2)
    phi_v, _ = triangle_modal(rule2.points, k)
    phi_f, _ = triangle_modal(rule2.points, V.facet.order)
    lam2 = np.concatenate(
        [1 - rule2.points.sum(1, keepdims=True), rule2.points], axis=1
    )
    cjv = np.einsum("q,qj,qv->jv", rule2.weights, phi_v, lam2)
    cjv_fac = np.einsum("q,qj,qv->jv", rule2.weights, phi_f, lam2)

    pts = mesh.points
    faces = np.asarray(mesh.faces)
    fv = pts[faces]
    E1 = fv[:, 1] - fv[:, 0]
    E2 = fv[:, 2] - fv[:, 0]
    nsc = np.cross(E1, E2)
    E = np.stack([E1, E2], axis=1)  # (nface, 2, 3)
    G = np.einsum("fdc,fec->fde", E, E)
    W = np.einsum("fde,fec->fdc", np.linalg.inv(G), E)  # (nface, 2, 3)

    # M_F[f, row, v*3+c]: hdiv moment rows then facet frame rows (matching
    # FaceBlockLayout's face-block column order [nfd_v hdiv | nfd_f facet])
    M_F = np.zeros((nface, nfb, 9))
    M_F[:, :nfd_v] = np.einsum(
        "jv,fc->fjvc", cjv[:nfd_v], nsc
    ).reshape(nface, nfd_v, 9)
    M_F[:, nfd_v: nfd_v + 2 * nss] = np.einsum(
        "jv,fdc->fjdvc", cjv_fac[:nss], W
    ).reshape(nface, 2 * nss, 9)

    MF_apply = make_table_apply(M_F, store_dtype=dtype)
    MFt_apply = make_table_apply(
        np.ascontiguousarray(M_F.transpose(0, 2, 1)), store_dtype=dtype)

    # vertex accumulation plan for the transpose: (face, slot) pairs per
    # vertex, padded to the max valence (pad index -> appended zero row)
    nv = mesh.nv
    flat_v = faces.ravel()
    order = np.argsort(flat_v, kind="stable")
    counts = np.bincount(flat_v, minlength=nv)
    maxval = int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)])
    vs_idx = np.full((nv, maxval), 3 * nface, np.int64)
    for s in range(maxval):
        has = counts > s
        vs_idx[has, s] = order[starts[:-1][has] + s]
    faces_j = jnp.asarray(faces, jnp.int32)
    vs_idx_j = jnp.asarray(vs_idx, jnp.int32)

    def TF(z):
        """(nv, 3) coarse vertex values -> (nface, nfb) face-block rows."""
        cloc = z[faces_j].reshape(nface, 9)
        return MF_apply(cloc.astype(dtype))

    def TFt(rF):
        g = MFt_apply(rF.astype(dtype))  # (nface, 9)
        g3 = jnp.concatenate(
            [g.reshape(3 * nface, 3), jnp.zeros((1, 3), g.dtype)]
        )
        return g3[vs_idx_j].sum(axis=1)  # (nv, 3)

    return TF, TFt


def _edge_star_skeleton_blocks(V) -> list[np.ndarray]:
    """Edge-star patches on the skeleton: all face + facet dofs of the
    faces containing each mesh edge.  Edges are the codim-2 entities of a
    tet mesh, so these are the 3D analogue of the 2D vertex-star patches;
    patch sizes stay O(faces-around-an-edge * dofs-per-face), small enough
    for batched dense inverses at scale (3D vertex patches are not)."""
    mesh = V.mesh
    nfd_v, nfd_f = V.hdiv.n_face_dofs, V.facet.n_face
    # face -> its 3 edges, via the sorted-pair edge table
    edge_key = {tuple(e): i for i, e in enumerate(mesh.edges.tolist())}
    blocks: list[list[int]] = [[] for _ in range(mesh.nedge)]
    for f, (a, b, c) in enumerate(mesh.faces.tolist()):
        dofs_f = list(range(f * nfd_v, (f + 1) * nfd_v)) + list(
            range(V.hdiv.ndof + f * nfd_f, V.hdiv.ndof + (f + 1) * nfd_f)
        )
        for pair in ((a, b), (a, c), (b, c)):
            blocks[edge_key[pair]].extend(dofs_f)
    return blocks


def _device_schur_fb(A_dev, ns: int, chunk_bytes: float = 4e8):
    """Interior Schur complement of a FACE-MAJOR condensed element table,
    computed ON DEVICE (the setup-time lever).

    In face-major order the skeleton dofs are the leading ``ns = 4*nfb``
    block of every element matrix and the interiors the trailing block, so
    A_ii / A_is / A_ss are plain slices and the whole derivation is batched
    f32 LU + two batched matmuls — no host pass over the GB-scale table,
    no upload of the three derived tables (the host path's inv+matmul
    chain is about a minute of single-core numpy at bench scale, and its
    products 2-3 full-table-equivalents of upload).

    f32 instead of the host path's f64: the products only ever feed
    f32/bf16-STORED preconditioner tables, so the new error is the f32
    LU/matmul rounding (~eps32 * kappa(A_ii) on the inverse) — measured
    iteration-neutral on the flagship solve (tests/test_device_tables.py).

    Returns (A_ii_inv, AinvAis, S) — all f32 device, face-major.
    """
    ne, nb, _ = A_dev.shape
    hp = jax.lax.Precision.HIGHEST

    @jax.jit
    def chunk_schur(Ac):
        A_ii = Ac[:, ns:, ns:]
        A_is = Ac[:, ns:, :ns]
        X = jnp.linalg.inv(A_ii)
        AiA = jnp.matmul(X, A_is, precision=hp)
        S = Ac[:, :ns, :ns] - jnp.matmul(
            jnp.swapaxes(A_is, 1, 2), AiA, precision=hp
        )
        return X, AiA, S

    chunk = max(1, int(chunk_bytes / max(1, nb * nb * 4)))
    outs = [chunk_schur(A_dev[c0: c0 + chunk].astype(jnp.float32))
            for c0 in range(0, ne, chunk)]
    if len(outs) == 1:
        return outs[0]
    return tuple(jnp.concatenate([o[k] for o in outs]) for k in range(3))


def build_skeleton_preconditioner_3d(
    V, A_np, velocity_dirichlet: str, dtype=jnp.float64,
    coarse_coefficient: float = 1.0, gs: bool = False,
    dof_scale: np.ndarray | None = None,
    store_dtype=None,
    ext_store_dtype=None,
    panel_store_dtype=None,
    inv_store_dtype=None,
    fast: bool = True,
):
    """Condensation-aware preconditioner for the 3D condensed MCS/HDG
    operator: exact batched solve of the element-interior block, an
    edge-star block smoother on the skeleton Schur complement, and the
    vector-P1 auxiliary-space coarse correction — the batched rendering of
    the reference's ``ext @ MypreA @ extT + inner_solve`` with BDM interior
    dofs condensed (NavierStokesSIMPLE_iterative.py:93-96,188-192,364-391).

    preA = E (smooth_S + T coarse T^T) E^T + I_i A_ii^{-1} I_i^T, with
    E the harmonic extension of skeleton values into element interiors and
    S the skeleton Schur complement; ``gs=True`` replaces the additive
    smoother+coarse by the symmetric multi-color block-GS sweep around the
    coarse correction (MypreA.Mult, :375-381) applied to S.
    """
    from ..ops import assembly as asm
    from ..precond.jacobi import block_jacobi, extract_blocks_from_local

    mesh = V.mesh
    nV = V.ndof
    hd = V.hdiv
    nbv = hd.n_basis
    nfd_v = hd.n_face_dofs
    n_face_tot = 4 * nfd_v
    n_int = hd.bases[0].n_cell
    nfac = V.facet.n_face * 4
    ne = mesh.ne

    loc_int = np.arange(n_face_tot, nbv)
    loc_skel = np.concatenate(
        [np.arange(n_face_tot), np.arange(nbv, nbv + nfac)]
    )
    eldofs = V.element_dofs
    eldofs_skel = np.ascontiguousarray(eldofs[:, loc_skel])
    int_dofs = np.ascontiguousarray(eldofs[:, loc_int])

    dev_in = isinstance(A_np, jax.Array)
    if dev_in:
        # ``A_np`` is the FACE-MAJOR equilibrated table already on device
        # (solvers/refinement.py device split): in that order the
        # skeleton dofs lead and the interiors trail, so the whole interior
        # Schur derivation is device slices + batched f32 LU/matmuls
        assert fast, "device-table Schur requires the fast (face-block) path"
        A_ii_inv, AinvAis, S_loc = _device_schur_fb(
            A_np, 4 * (nfd_v + V.facet.n_face)
        )
    else:
        A_ii = A_np[:, loc_int[:, None], loc_int[None, :]]
        A_is = A_np[:, loc_int[:, None], loc_skel[None, :]]
        A_ss = A_np[:, loc_skel[:, None], loc_skel[None, :]]
        A_ii_inv = np.linalg.inv(A_ii)
        AinvAis = np.matmul(A_ii_inv, A_is)  # (ne, n_int, n_skel)
        S_loc = A_ss - np.matmul(A_is.transpose(0, 2, 1), AinvAis)

    free = jnp.asarray(V.free_mask)
    fmask = V.free_mask

    space = H1(mesh, 1, dirichlet=velocity_dirichlet)
    solve1 = coarse_p1_solver(space, coarse_coefficient, dtype)
    nv = mesh.nv

    # ``store_dtype``: table STORAGE precision.  f32-stored tables applied
    # in f64 vector arithmetic stay a FIXED linear operator (a
    # preconditioner with rounded coefficients is harmless), halving the
    # device footprint of the big skeleton tables — unlike f32 ARITHMETIC,
    # whose nonlinear rounding noise floors the true residual of the outer
    # Bramble-Pasciak iteration near 1e-6.
    sdt = store_dtype or dtype
    if not fast:  # only the slow (dof-level) path applies this table
        A_ii_inv_j = jnp.asarray(A_ii_inv, sdt)

    if fast:
        # scatter-free face-block formulation (ops/faceblock.py): every
        # index op a block-row gather, where the dof-level gather/scatter
        # formulation below moves scalar indices and colliding
        # scatter-adds.  The coarse
        # correction runs at FACE level (interiors are never consulted by
        # the skeleton smoother; the harmonic extension owns them).
        from ..ops.faceblock import FaceBlockLayout

        lay = FaceBlockLayout(V)
        TF, TFt = hybrid_h1_face_transfer(V, lay, dtype)
        if dof_scale is None:
            def coarse_vc(rF):
                return TF(solve1(TFt(rF)))
        else:
            # equilibrated system A~ = D A D: the aux-space transfer
            # becomes D^{-1} T (the correction must approximate
            # A~^{-1} = D^{-1} A^{-1} D^{-1} on coarse modes)
            dinv = 1.0 / np.asarray(dof_scale)
            DinvF = jnp.asarray(
                np.concatenate(
                    [
                        dinv[: lay.off_c].reshape(lay.nface, lay.nfd_v),
                        dinv[lay.nhd:].reshape(lay.nface, lay.nfd_f),
                    ],
                    axis=1,
                ),
                dtype,
            )

            def coarse_vc(rF):
                return DinvF * TF(solve1(TFt(DinvF * rF)))

        return _build_skeleton_fast(
            V, free, fmask, AinvAis, A_ii_inv, S_loc, coarse_vc, gs, sdt,
            lay=lay, ext_sdt=ext_store_dtype or sdt,
            panel_sdt=panel_store_dtype or sdt,
            inv_sdt=inv_store_dtype or sdt,
        )

    # coarse: vector-P1 embedding (full-space transfer; the extension E
    # overwrites its interior completion with the exact harmonic one)
    T, TT = hybrid_h1_embedding_3d(V, dtype)

    if dof_scale is None:
        def coarse(r):
            rt = TT(r).reshape(3, nv).T  # (nv, 3)
            zt = solve1(rt)  # one batched solve for all 3 components
            return T(zt.T.reshape(-1))
    else:
        Dinv = jnp.asarray(1.0 / dof_scale, dtype)

        def coarse(r):
            rt = TT(Dinv * r).reshape(3, nv).T
            zt = solve1(rt)
            return Dinv * T(zt.T.reshape(-1))

    blks = [
        np.asarray([d for d in b if fmask[d]], np.int32)
        for b in _edge_star_skeleton_blocks(V)
    ]
    blks = [b for b in blks if len(b)]
    dofs, mats = extract_blocks_from_local(S_loc, eldofs_skel, blks, nV)

    eldofs_skel_j = jnp.asarray(eldofs_skel)
    int_dofs_j = jnp.asarray(int_dofs)
    AinvAis_j = jnp.asarray(AinvAis, sdt)
    S_loc_j = jnp.asarray(S_loc, sdt)

    def ext(y):
        """Harmonic extension: overwrite interiors from skeleton values."""
        ys = y[eldofs_skel_j]
        yi = -jnp.einsum("eis,es->ei", AinvAis_j, ys)
        return y.at[int_dofs_j].set(yi)

    def extT(x):
        """Transpose: fold interior residual into skeleton, zero interiors."""
        xi = x[int_dofs_j]
        rs = -jnp.einsum("eis,ei->es", AinvAis_j, xi)
        out = x.at[int_dofs_j].set(0.0)
        return out.at[eldofs_skel_j].add(rs)

    def inner(x):
        xi = x[int_dofs_j]
        yi = jnp.einsum("eij,ej->ei", A_ii_inv_j, xi)
        return jnp.zeros_like(x).at[int_dofs_j].set(yi)

    if gs:
        from ..precond.multicolor import (
            MulticolorGS,
            color_blocks,
            damped_coarse,
        )

        def S_apply(x):
            xf = jnp.where(free, x, 0.0)
            y = asm.apply_local_matrices(S_loc_j, eldofs_skel_j, nV, xf)
            return jnp.where(free, y, 0.0)

        colors = color_blocks(blks, nV, eldofs_skel)
        mgs = MulticolorGS(dofs, mats, colors, nV, dtype)
        rng = np.random.default_rng(7)
        example = jnp.asarray(rng.standard_normal(nV), dtype) * free
        coarse_gs, _, _ = damped_coarse(coarse, S_apply, example)

        def pre_skel(xs):
            y = mgs.forward(S_apply, xs, jnp.zeros_like(xs))
            r = xs - S_apply(y)
            y = y + coarse_gs(r)
            return mgs.backward(S_apply, xs, y)

    else:
        smooth = block_jacobi(dofs, jnp.asarray(mats, sdt), nV)

        def pre_skel(xs):
            return smooth(xs) + coarse(xs)

    def preA(x):
        xf = jnp.where(free, x, 0.0)
        rs = jnp.where(free, extT(xf), 0.0)
        y = ext(pre_skel(rs)) + inner(xf)
        return jnp.where(free, y, x)

    return preA


def _build_skeleton_fast(V, free, fmask, AinvAis, A_ii_inv, S_loc,
                         coarse_vc, gs, sdt, lay=None,
                         ext_sdt=None, panel_sdt=None, inv_sdt=None):
    """Face-block (scatter-free) rendering of the skeleton preconditioner:
    same math as the slow path — exact interior solve + edge-star smoother
    (additive or symmetric multi-color GS) + aux-space coarse on the
    skeleton Schur complement — with every gather a block-row slice.

    Every batched block matvec (harmonic extension + transpose, interior
    solve, skeleton operator, edge-star solves, GS row panels) streams its
    table through ops/table_apply.make_table_apply.  ``sdt`` (e.g. bfloat16) is the table STORAGE dtype;
    arithmetic stays f32.  ``ext_sdt`` overrides storage for the harmonic
    extension + interior tables only: those are applied ONCE per preA (a
    ~0.4% bf16 rounding is a mild operator perturbation), while the GS
    sweep COMPOSES many table applies and measured ~2x the Krylov
    iterations with bf16 sweep tables — so 'ext-only' bf16 keeps the
    iteration count and still drops the largest single stream."""
    import os as _os
    import sys as _sys
    import time as _time

    from ..ops.faceblock import FaceBlockLayout, face_star_smoother
    from ..ops.table_apply import make_table_apply
    from ..utils.jaxtools import device_tables_enabled

    _t0 = _time.perf_counter()

    def _plog(msg):
        if _os.environ.get("NSTPU_SETUP_LOG"):
            print(f"      [skel] {msg} {_time.perf_counter() - _t0:.1f}s",
                  file=_sys.stderr, flush=True)

    if lay is None:
        lay = FaceBlockLayout(V)
    ext_sdt = ext_sdt or sdt
    panel_sdt = panel_sdt or sdt
    inv_sdt = inv_sdt or sdt

    # DEVICE-DERIVED tables (the setup-time lever): upload (or derive,
    # see below) the f32 skeleton table ONCE and compute everything
    # downstream of it — edge-star block inverses, GS residual row panels,
    # the extension transpose — on the device.  The host path builds
    # ~3 full-S equivalents of panels + ~1-2 GB of inverses in
    # single-core numpy and uploads them.  On wherever the default device
    # is an accelerator (utils/jaxtools.device_tables_enabled).
    #
    # When ``S_loc``/``AinvAis``/``A_ii_inv`` arrive as DEVICE arrays
    # (already face-major, from _device_schur_fb), nothing GB-scale is
    # built on the host or copied in either direction.
    dev_in = isinstance(S_loc, jax.Array)
    _f32ish = {jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16)}
    use_dev = dev_in or (
        device_tables_enabled()
        # the f32 master table can only feed storage dtypes <= f32 wide;
        # f64-stored paths (the unequilibrated f64 model preconditioner)
        # keep the host f64 derivation
        and {jnp.dtype(sdt), jnp.dtype(ext_sdt), jnp.dtype(panel_sdt),
             jnp.dtype(inv_sdt)} <= _f32ish
    )
    if dev_in:
        S_perm_np = None  # never touched with S_dev set
        S_dev = S_loc
    else:
        S_perm_np = lay.permute_skel_blocks(S_loc)
        S_dev = jnp.asarray(S_perm_np.astype(np.float32)) if use_dev \
            else None

    sm = face_star_smoother(lay, S_perm_np, np.asarray(fmask), sdt,
                            S_dev=S_dev)
    _plog("edge-star smoother inverses")
    freeF = sm.freeF
    ne, n_int = lay.ne, lay.n_int
    if dev_in:
        # device-derived extension: already face-major, cast in place
        ext_dev = AinvAis.astype(ext_sdt)
        ext_apply = make_table_apply(ext_dev, store_dtype=ext_sdt)
        extT_apply = make_table_apply(jnp.swapaxes(ext_dev, 1, 2),
                                      store_dtype=ext_sdt)
        inner_apply = make_table_apply(A_ii_inv.astype(ext_sdt),
                                       store_dtype=ext_sdt)
    elif use_dev:
        # ONE upload (host-cast to the storage dtype first, so the upload
        # moves the stored bytes); the transpose table is a device
        # derivation of it instead of a second full upload
        import ml_dtypes as _mld

        AinvAis_perm_np = np.ascontiguousarray(AinvAis[:, :, lay.perm_skel])
        _np_ext = (np.float32 if jnp.dtype(ext_sdt) == jnp.dtype(jnp.float32)
                   else _mld.bfloat16)
        ext_dev = jnp.asarray(AinvAis_perm_np.astype(_np_ext))
        ext_apply = make_table_apply(ext_dev, store_dtype=ext_sdt)
        extT_apply = make_table_apply(jnp.swapaxes(ext_dev, 1, 2),
                                      store_dtype=ext_sdt)
        inner_apply = make_table_apply(
            jnp.asarray(np.asarray(A_ii_inv).astype(_np_ext)),
            store_dtype=ext_sdt)
    else:
        AinvAis_perm_np = np.ascontiguousarray(AinvAis[:, :, lay.perm_skel])
        ext_apply = make_table_apply(AinvAis_perm_np, store_dtype=ext_sdt)
        extT_apply = make_table_apply(
            np.ascontiguousarray(AinvAis_perm_np.transpose(0, 2, 1)),
            store_dtype=ext_sdt)
        inner_apply = make_table_apply(np.asarray(A_ii_inv),
                                       store_dtype=ext_sdt)

    def ext_fb(yF, yi_ignored=None):
        """Interiors from skeleton values (face layout)."""
        ys = yF[lay.efaces].reshape(ne, lay.n_skel)
        return -ext_apply(ys)

    def extT_fb(xF, xi):
        """Fold interior residual into the skeleton (face layout)."""
        rs = -extT_apply(xi)
        return xF + lay.scatter_skel(rs)

    if gs:
        from ..precond.multicolor import color_blocks, damped_coarse

        S_elem_apply = make_table_apply(
            S_dev if use_dev else S_perm_np, store_dtype=sdt)

        def S_faces(xF):
            """Skeleton operator purely in face layout (free-masked)."""
            xF = jnp.where(freeF, xF, 0.0)
            ue = xF[lay.efaces].reshape(ne, lay.n_skel)
            ye = S_elem_apply(ue)
            return jnp.where(freeF, lay.scatter_skel(ye), 0.0)

        # color edge-stars so same-color blocks are operator-decoupled
        # (they must not touch a common element; see precond/multicolor.py)
        nfb = lay.nfb
        blocks_fb = [
            (np.asarray(f)[:, None] * nfb + np.arange(nfb)[None, :]).ravel()
            for f in sm.block_faces
        ]
        colors = color_blocks(blocks_fb, lay.nface * nfb, lay.eldofs_fb)
        # row-panel groups: each color's residual is computed fresh from
        # ROW PANELS of S at just that color's faces (3 full-S streams per
        # sweep direction, color-count independent) instead of a full
        # skeleton apply per color (2 x ncolors streams — the dominant
        # cost of the recompute sweep; see color_row_groups)
        _plog("coloring")
        groups = sm.color_row_groups(colors, S_perm_np, panel_sdt, inv_sdt)
        _plog("row-panel groups")

        def coarse_faces(rF):
            return jnp.where(freeF, coarse_vc(rF), 0.0)

        rng = np.random.default_rng(7)
        # example vector in the COMPUTE dtype (>= f32): with bf16-stored
        # tables the mixed-precision einsums still produce f32, and the
        # damping power iteration needs that accuracy
        exF = jnp.asarray(
            rng.standard_normal((lay.nface, nfb)),
            jnp.promote_types(sdt, jnp.float32),
        ) * freeF
        coarse_gs, _, _ = damped_coarse(coarse_faces, S_faces, exF)
        _plog("coarse damping power iteration")

        def pre_skel_faces(xF):
            # TRANSPOSED (SoA) padded sweep: the iterate lives
            # as (nfb, nface+1) so its minor dim is the wide face axis
            # and every color-step is pure gathers + SoA kernels — see
            # solve_color_rows.  Transposes happen only here, at the
            # sweep's boundary with the row-major face layout.
            zrow = jnp.zeros((1, xF.shape[1]), xF.dtype)
            xPT = jnp.concatenate([xF, zrow]).T
            y = None  # zero iterate: the first color reads xPT directly
            for g in groups:  # forward sweep
                dy = sm.solve_color_rows(g, xPT, y)
                y = dy if y is None else y + dy
            yF = y.T[:-1]
            r = xF - S_faces(yF)
            yF = yF + coarse_gs(r)
            yPT = jnp.concatenate([yF, zrow]).T
            for g in reversed(groups):  # backward sweep
                yPT = yPT + sm.solve_color_rows(g, xPT, yPT)
            return yPT.T[:-1]

    else:

        def pre_skel_faces(xF):
            yF = sm.smooth_faces(xF)
            return yF + jnp.where(freeF, coarse_vc(xF), 0.0)

    def preA(x):
        xf = jnp.where(free, x, 0.0)
        xF, xi = lay.split(xf)
        rF = jnp.where(freeF, extT_fb(xF, xi), 0.0)
        yF = pre_skel_faces(rF)
        yi = ext_fb(yF) + inner_apply(xi)
        y = lay.join(yF, yi)
        return jnp.where(free, y, x)

    return preA


def build_auxspace_preconditioner_3d(
    V, A_np, velocity_dirichlet: str, dtype=jnp.float64,
    coarse_coefficient: float = 1.0, blocks: str = "vertexstar",
    gs: bool = False, A_apply=None,
):
    """Overlapping block smoother + vector-P1 coarse correction, the 3D
    counterpart of the reference's MypreA structure.  ``gs=True`` switches
    to the symmetric multi-color block-GS variant (MypreA.Mult with
    GS=True, reference :375-381); needs ``A_apply``."""
    from ..precond.jacobi import block_jacobi, extract_blocks_from_local
    from .stokes_hybrid3d import hybrid_blocks_3d

    mesh = V.mesh
    nV = V.ndof
    free = jnp.asarray(V.free_mask)
    fmask = V.free_mask
    blks = [
        np.asarray([d for d in blk if fmask[d]], np.int32)
        for blk in hybrid_blocks_3d(V, blocks)
    ]
    blks = [b for b in blks if len(b)]
    dofs, mats = extract_blocks_from_local(A_np, V.element_dofs, blks, nV)

    T, TT = hybrid_h1_embedding_3d(V, dtype)
    space = H1(mesh, 1, dirichlet=velocity_dirichlet)
    solve1 = coarse_p1_solver(space, coarse_coefficient, dtype)
    nv = mesh.nv

    def coarse(r):
        rt = TT(r).reshape(3, nv).T
        return T(solve1(rt).T.reshape(-1))

    if gs:
        from ..precond.multicolor import (
            MulticolorGS,
            color_blocks,
            symmetric_gs_preconditioner,
        )

        assert A_apply is not None, "gs=True needs the masked operator"
        colors = color_blocks(blks, nV, np.asarray(V.element_dofs))
        mgs = MulticolorGS(dofs, mats, colors, nV, dtype)
        return symmetric_gs_preconditioner(mgs, A_apply, coarse, free)

    smooth = block_jacobi(dofs, jnp.asarray(mats, dtype), nV)

    def preA(u):
        uf = jnp.where(free, u, 0.0)
        y = smooth(uf) + coarse(uf)
        return jnp.where(free, y, u)

    return preA
