"""Scatter-free face-block applies for 3D hybrid [H(div) | facet] operators.

The hot loop of the flagship solve (the BPCG/MINRES iteration of
/root/reference/solvers/bramblepasciak_new.py:200-241) applies per-element
dense blocks through gather -> batched matvec -> scatter-add.  The
0.4M scalar gathers and colliding scatter-adds of that formulation (atomics
on a GPU, serialized index streams elsewhere) cost several times the
bandwidth bound of streaming the element blocks themselves.

This module removes every scalar index op from the apply by exploiting the
structure of the 3D hybrid dof layout:

* H(div) face dofs are CONTIGUOUS per mesh face (fem/hdiv3d.py), facet
  dofs are contiguous per face, and element-interior dofs are contiguous
  per element.  Viewing the dof vector as a (nface, nfb) face-block matrix
  (nfb = hdiv-face + facet dofs) plus an (ne, n_int) interior matrix, the
  element gather becomes FOUR block-row gathers (slice size nfb) and the
  interior part a plain reshape.
* the scatter-add is replaced by its transpose gather: every face receives
  contributions from at most TWO (element, local-face) slots, so the
  assembled result is two block-row gathers and an add — no scatter, no
  collision serialization.

The element-local matrices are permuted ONCE at setup into face-major
order (columns grouped per face), so at apply time the whole operator is:
reshape -> 4-row block gather -> one batched dense matvec (streams the
element blocks at HBM bandwidth) -> 2-row block gather -> reshape.
"""

from __future__ import annotations

from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np

from .table_apply import make_table_apply

__all__ = ["FaceBlockLayout", "face_star_smoother", "FaceStarSmoother"]


class FaceBlockLayout:
    """Index plan for scatter-free applies on a HybridVelocitySpace3D.

    All jnp members are device constants captured by the apply closures;
    all construction is host-side numpy.
    """

    def __init__(self, Xv):
        mesh = Xv.mesh
        V, F = Xv.hdiv, Xv.facet
        self.mesh = mesh
        self.nfd_v = V.n_face_dofs
        self.n_int = V.bases[0].n_cell
        self.nfd_f = F.n_face
        self.nfb = self.nfd_v + self.nfd_f
        self.ne, self.nface = mesh.ne, mesh.nface
        self.off_c = self.nface * self.nfd_v
        self.nhd = V.ndof
        self.n = Xv.ndof
        self.nb = 4 * self.nfd_v + self.n_int + 4 * self.nfd_f
        self.n_skel = 4 * self.nfb

        nfd_v, n_int, nfd_f, nfb = self.nfd_v, self.n_int, self.nfd_f, self.nfb

        # element-local permutation: flat order [4 x nfd_v hdiv | n_int |
        # 4 x nfd_f facet] -> face-major [face0 (hdiv+facet) ... face3 | int]
        self.perm = np.concatenate(
            [
                np.concatenate(
                    [lf * nfd_v + np.arange(nfd_v),
                     4 * nfd_v + n_int + lf * nfd_f + np.arange(nfd_f)]
                )
                for lf in range(4)
            ]
            + [4 * nfd_v + np.arange(n_int)]
        )
        # skeleton-only permutation: [4 x nfd_v | 4 x nfd_f] -> face-major
        self.perm_skel = np.concatenate(
            [
                np.concatenate(
                    [lf * nfd_v + np.arange(nfd_v),
                     4 * nfd_v + lf * nfd_f + np.arange(nfd_f)]
                )
                for lf in range(4)
            ]
        )

        efaces = np.asarray(mesh.element_faces)
        # transpose-gather plan: face -> its <=2 (element*4+lf) slots
        flat = efaces.ravel()
        order = np.argsort(flat, kind="stable").astype(np.int64)
        counts = np.bincount(flat, minlength=self.nface)
        starts = np.concatenate([[0], np.cumsum(counts)])
        pos = np.full((self.nface, 2), self.ne * 4, np.int64)
        pos[counts >= 1, 0] = order[starts[:-1][counts >= 1]]
        pos[counts >= 2, 1] = order[starts[:-1][counts >= 2] + 1]
        # host copies kept: setup code reads these without a device->host
        # copy
        self.efaces_np = efaces
        self.pos_np = pos
        self.efaces = jnp.asarray(efaces, jnp.int32)
        self.pos = jnp.asarray(pos, jnp.int32)

    # -- host helpers ---------------------------------------------------

    def permute_blocks(self, A_np: np.ndarray) -> np.ndarray:
        """(ne, nb, nb) flat-order element blocks -> face-major order."""
        p = self.perm
        return np.ascontiguousarray(A_np[:, p[:, None], p[None, :]])

    def permute_skel_blocks(self, S_np: np.ndarray) -> np.ndarray:
        """(ne, 48, 48) skeleton blocks (loc_skel order) -> face-major."""
        p = self.perm_skel
        return np.ascontiguousarray(S_np[:, p[:, None], p[None, :]])

    def permute_cols(self, B_np: np.ndarray) -> np.ndarray:
        """(ne, m, nb) rectangular blocks: permute the element axis only."""
        return np.ascontiguousarray(B_np[:, :, self.perm])

    @cached_property
    def eldofs_fb(self) -> np.ndarray:
        """(ne, 4*nfb) skeleton element dofs in FACE-BLOCK numbering
        (dof = face * nfb + j), face-major order — for host assembly of
        skeleton operators in the face numbering."""
        ef = np.asarray(self.mesh.element_faces)
        out = np.empty((self.ne, 4 * self.nfb), np.int64)
        for lf in range(4):
            out[:, lf * self.nfb: (lf + 1) * self.nfb] = (
                ef[:, lf][:, None] * self.nfb + np.arange(self.nfb)[None, :]
            )
        return out

    # -- layout conversions (jit-safe) ----------------------------------

    def split(self, u):
        """Flat (n,) -> (uF (nface, nfb), ui (ne, n_int))."""
        uF = jnp.concatenate(
            [
                u[: self.off_c].reshape(self.nface, self.nfd_v),
                u[self.nhd:].reshape(self.nface, self.nfd_f),
            ],
            axis=1,
        )
        ui = u[self.off_c: self.nhd].reshape(self.ne, self.n_int)
        return uF, ui

    def join(self, uF, ui):
        return jnp.concatenate(
            [
                uF[:, : self.nfd_v].reshape(-1),
                ui.reshape(-1),
                uF[:, self.nfd_v:].reshape(-1),
            ]
        )

    def gather_elem(self, uF, ui):
        """(ne, nb) element vectors in face-major (permuted) order."""
        ue_f = uF[self.efaces].reshape(self.ne, self.n_skel)
        return jnp.concatenate([ue_f, ui], axis=1)

    def scatter_elem(self, ye):
        """Transpose of gather_elem: (ne, nb) face-major element results ->
        (yF, yi) via the two-sibling gather (no scatter)."""
        yf = ye[:, : self.n_skel].reshape(self.ne * 4, self.nfb)
        yf = jnp.concatenate([yf, jnp.zeros((1, self.nfb), yf.dtype)])
        yF = yf[self.pos[:, 0]] + yf[self.pos[:, 1]]
        return yF, ye[:, self.n_skel:]

    def scatter_skel(self, yf4):
        """(ne, 4*nfb) skeleton-only results -> yF (nface, nfb)."""
        yf = yf4.reshape(self.ne * 4, self.nfb)
        yf = jnp.concatenate([yf, jnp.zeros((1, self.nfb), yf.dtype)])
        return yf[self.pos[:, 0]] + yf[self.pos[:, 1]]

    # -- operator factories ---------------------------------------------

    def elem_apply(self, A_perm):
        """y = A u from face-major element blocks (ne, nb, nb)."""

        def apply(u):
            uF, ui = self.split(u)
            ue = self.gather_elem(uF, ui)
            ye = jnp.einsum("eij,ej->ei", A_perm, ue)
            yF, yi = self.scatter_elem(ye)
            return self.join(yF, yi)

        return apply

    def elem_apply_multi(self, mats_and_scales):
        """y = sum_k c_k * (A_k u) sharing one gather/scatter round trip —
        the split (compensated) f32 operator costs ONE extra einsum, not a
        second full apply."""

        def apply(u):
            uF, ui = self.split(u)
            ue = self.gather_elem(uF, ui)
            ye = None
            for A_perm, c in mats_and_scales:
                t = jnp.einsum("eij,ej->ei", A_perm, ue)
                t = t if c is None else c * t
                ye = t if ye is None else ye + t
            yF, yi = self.scatter_elem(ye)
            return self.join(yF, yi)

        return apply

    def elem_apply_comp(self, A_hi, A_lo, out_dtype=jnp.float64):
        """True-f64 apply y = (A_hi + A_lo) u of a split table pair (numpy
        or device arrays): the phase-2 (endgame) operator of the
        refinement solve.  The pair is recombined ONCE into one f64 table,
        which streams the same 8 bytes per entry as the pair and carries
        its ~2^-48 accuracy through any row cancellation."""
        A64 = (jnp.asarray(A_hi, out_dtype) + jnp.asarray(A_lo, out_dtype))
        return self.elem_apply(A64)

    def rect_apply_comp(self, B_hi, B_lo, eldofs_p, ndof_p,
                        out_dtype=jnp.float64):
        """True-f64 (B, BT) of a split pressure-coupling pair — the
        companion of :meth:`elem_apply_comp`."""
        B64 = (jnp.asarray(B_hi, out_dtype) + jnp.asarray(B_lo, out_dtype))
        return self.rect_apply(B64, eldofs_p, ndof_p)

    def skel_apply(self, S_perm):
        """y = S u for a skeleton-only operator (ne, 4nfb, 4nfb) in
        face-major order; interiors pass through as zero."""

        def apply(u):
            uF, _ = self.split(u)
            ue = uF[self.efaces].reshape(self.ne, self.n_skel)
            ye = jnp.einsum("eij,ej->ei", S_perm, ue)
            yF = self.scatter_skel(ye)
            return self.join(yF, jnp.zeros((self.ne, self.n_int), u.dtype))

        return apply

    def rect_apply(self, B_perm, eldofs_p, ndof_p):
        """(B, BT) for a rectangular coupling (ne, m, nb) with
        element-contiguous row dofs (L2 pressure: eldofs_p[e, j] =
        e * m + j), face-major columns."""
        m = B_perm.shape[1]
        ed = np.asarray(eldofs_p)
        expected = np.arange(self.ne)[:, None] * m + np.arange(m)[None, :]
        assert np.array_equal(ed, expected), "pressure dofs not contiguous"

        def B(u):
            uF, ui = self.split(u)
            ue = self.gather_elem(uF, ui)
            pe = jnp.einsum("epi,ei->ep", B_perm, ue)
            return pe.reshape(-1)

        def BT(p):
            pe = p.reshape(self.ne, m)
            ye = jnp.einsum("epi,ep->ei", B_perm, pe)
            yF, yi = self.scatter_elem(ye)
            return self.join(yF, yi)

        return B, BT

    def rect_apply_multi(self, mats, eldofs_p, ndof_p):
        """(B, BT) applying sum_k B_k, sharing one gather/scatter round
        trip (split-matrix f32 coupling)."""
        m = mats[0].shape[1]
        ed = np.asarray(eldofs_p)
        expected = np.arange(self.ne)[:, None] * m + np.arange(m)[None, :]
        assert np.array_equal(ed, expected), "pressure dofs not contiguous"

        def B(u):
            uF, ui = self.split(u)
            ue = self.gather_elem(uF, ui)
            pe = sum(jnp.einsum("epi,ei->ep", Bk, ue) for Bk in mats)
            return pe.reshape(-1)

        def BT(p):
            pe = p.reshape(self.ne, m)
            ye = sum(jnp.einsum("epi,ep->ei", Bk, pe) for Bk in mats)
            yF, yi = self.scatter_elem(ye)
            return self.join(yF, yi)

        return B, BT


# ----------------------------------------------------------------------
# Face-granular overlapping block smoother (edge-star patches)
# ----------------------------------------------------------------------


class FaceStarSmoother:
    """Overlapping block-Jacobi / multi-color block-GS over FACE-granular
    patches (edge-stars: the faces around each mesh edge,
    models/auxspace3d._edge_star_skeleton_blocks), with every index op a
    block-row gather of slice nfb.

    Blocks are bucketed by face count (padding a 4-face boundary star to
    the 10-face interior maximum would triple the inverse tables); each
    bucket is one batched dense matvec.  The scatter back is the
    transpose-gather: every face belongs to exactly THREE edge-stars (its
    three edges), so assembly is three block-row gathers and two adds.

    Constrained (Dirichlet) dofs are decoupled by zeroing their block
    rows/columns and placing 1 on the diagonal before inversion — the
    free-free part of the inverse then equals the inverse of the pruned
    block the dof-level smoother uses.
    """

    def __init__(self, layout: FaceBlockLayout, S_fb_csr, edge_faces,
                 freeF: np.ndarray, dtype=jnp.float32, S_dev=None):
        nfb, nface = layout.nfb, layout.nface
        ne = layout.ne
        self.layout = layout
        self.dtype = dtype
        nblocks = len(edge_faces)

        sizes = np.array([len(f) for f in edge_faces])
        self.buckets = []
        # per-bucket UNCAST inverses for color_row_groups' own storage cast:
        # f64 numpy on the host path, f32 device arrays on the S_dev path
        self._bucket_inv_np: list = []
        self._bucket_apply: list = []  # per-bucket table solves
        self.block_faces: list[np.ndarray] = []  # bucket order
        # HOST copies of the per-bucket face index arrays: the setup paths
        # (color grouping) read these without a device->host copy
        self._faces_np: list[np.ndarray] = []
        self.freeF_np = np.asarray(freeF)
        slot_base = 0
        # face -> (up to 3) slot positions in the concatenated result
        pos3 = np.full((nface, 3), -1, np.int64)
        cnt = np.zeros(nface, np.int32)
        order = np.argsort(sizes, kind="stable")
        # DEVICE-side block assembly + inversion: with ``S_dev`` — the
        # face-major skeleton table already on device — the edge-star
        # blocks are pure gathers from it, so neither the ~GB inverse
        # tables nor the assembled blocks are built on the host or
        # uploaded, and the per-block scipy CSR slicing (tens of seconds
        # single-core at bench scale) disappears.  The inverses come out
        # f32 (vs f64 on the host path): a ~1e-6-relative perturbation of
        # a SMOOTHER block, iteration-neutral
        # (tests/test_device_tables.py).
        self._S_dev = S_dev
        if S_dev is not None:
            csr = None
            self._S5p = jnp.concatenate(
                [S_dev.reshape(ne, 4, nfb, 4, nfb),
                 jnp.zeros((1, 4, nfb, 4, nfb), S_dev.dtype)]
            )
            pos_np = layout.pos_np
            freeF_dev = jnp.asarray(freeF)
        else:
            import scipy.sparse as sp

            csr = sp.csr_matrix(S_fb_csr)
        freeF_flat = freeF.ravel()
        for fsz in np.unique(sizes):
            sel = order[sizes[order] == fsz]
            faces_b = np.stack([np.asarray(edge_faces[i]) for i in sel])
            bdim = fsz * nfb
            dof_idx = (
                faces_b[:, :, None] * nfb + np.arange(nfb)[None, None, :]
            ).reshape(len(sel), bdim)
            if S_dev is not None:
                inv = self._device_bucket_inverses(
                    faces_b, pos_np, freeF_dev, nfb)
            else:
                mats = np.empty((len(sel), bdim, bdim))
                for b in range(len(sel)):
                    mats[b] = csr[np.ix_(dof_idx[b], dof_idx[b])].toarray()
                    fm = freeF_flat[dof_idx[b]]
                    mats[b][~fm, :] = 0.0
                    mats[b][:, ~fm] = 0.0
                    mats[b][np.where(~fm)[0], np.where(~fm)[0]] = 1.0
                inv = np.linalg.inv(mats)
            # record slot positions
            for b, i in enumerate(sel):
                for k, f in enumerate(edge_faces[i]):
                    pos3[f, cnt[f]] = slot_base + b * fsz + k
                    cnt[f] += 1
            self.buckets.append(
                (jnp.asarray(faces_b, jnp.int32),
                 inv.astype(dtype) if S_dev is not None
                 else jnp.asarray(inv, dtype),
                 np.asarray(sel))
            )
            self._bucket_inv_np.append(inv)
            self._faces_np.append(faces_b)
            self._bucket_apply.append(make_table_apply(inv, store_dtype=dtype))
            self.block_faces.extend(faces_b)
            slot_base += len(sel) * fsz
        assert cnt.max() <= 3
        self.total_slots = slot_base
        pos3 = np.where(pos3 < 0, slot_base, pos3)  # pad -> zero row
        self.pos3 = jnp.asarray(pos3, jnp.int32)
        self.freeF = jnp.asarray(freeF)
        self.sizes = sizes

    def _device_bucket_inverses(self, faces_b, pos_np, freeF_dev, nfb):
        """Assemble one bucket's edge-star blocks from the on-device
        skeleton table and invert them there (batched f32 LU).

        Entries of the assembled face-level S: the (face_i, face_j) block
        sums S_perm[e] sub-blocks over elements adjacent to BOTH faces —
        for faces of one edge-star that is up to 2 shared elements on the
        diagonal (the face's own neighbours) and exactly one off the
        diagonal (two distinct tets cannot share two faces), so the block
        is TWO batched gather passes from S5p with host-precomputed index
        plans (topology only, no matrix data)."""
        ne = self.layout.ne
        nb_b, fsz = faces_b.shape
        bdim = fsz * nfb
        p2 = pos_np[faces_b]  # (nb_b, fsz, 2): elem*4+lf, pad ne*4
        el = p2 // 4
        lf = p2 % 4
        ar = np.arange(fsz)
        E = np.full((2, nb_b, fsz, fsz), ne, np.int64)
        LI = np.zeros((2, nb_b, fsz, fsz), np.int64)
        LJ = np.zeros((2, nb_b, fsz, fsz), np.int64)
        for s in (0, 1):  # diagonal: both adjacent elements
            # scalar + slice + index arrays: numpy puts the (fsz, nb_b)
            # index dims FIRST, hence the transposes
            E[s, :, ar, ar] = el[:, :, s].T
            LI[s, :, ar, ar] = lf[:, :, s].T
            LJ[s, :, ar, ar] = lf[:, :, s].T
        # off-diagonal: the one element shared by faces i and j (pass 0)
        eli = el[:, :, None, :, None]
        elj = el[:, None, :, None, :]
        diag = np.eye(fsz, dtype=bool)[None, :, :, None, None]
        m4 = (eli == elj) & (eli != ne) & ~diag
        lfi = lf[:, :, None, :, None]
        lfj = lf[:, None, :, None, :]
        e_off = (m4 * (eli + 1)).sum((3, 4)) - 1
        li_off = (m4 * (lfi + 1)).sum((3, 4)) - 1
        lj_off = (m4 * (lfj + 1)).sum((3, 4)) - 1
        off = e_off >= 0
        E[0] = np.where(off, e_off, E[0])
        LI[0] = np.where(off, li_off, LI[0])
        LJ[0] = np.where(off, lj_off, LJ[0])

        fmask = freeF_dev[jnp.asarray(faces_b, jnp.int32)].reshape(
            nb_b, bdim)

        # S5p rides as an ARGUMENT: a closure capture would embed the
        # GB-scale table as a constant in the compiled module
        def chunk_inv(S5p, Ej, LIj, LJj, fm):
            blk = (S5p[Ej[0], LIj[0], :, LJj[0], :]
                   + S5p[Ej[1], LIj[1], :, LJj[1], :])
            blk = blk.transpose(0, 1, 3, 2, 4).reshape(-1, bdim, bdim)
            fmf = fm.astype(blk.dtype)
            blk = blk * (fmf[:, :, None] * fmf[:, None, :])
            blk = blk + jnp.eye(bdim, dtype=blk.dtype)[None] * (
                1.0 - fmf)[:, None, :]
            return jnp.linalg.inv(blk)

        chunk_inv = jax.jit(chunk_inv)
        # chunk the gather intermediates (2 x (chunk, fsz, fsz, nfb, nfb))
        # to ~0.5 GB so HBM holds them next to the resident tables
        chunk = max(1, int(2.5e8 / max(1, fsz * fsz * nfb * nfb * 4)))
        outs = []
        Ej_all = jnp.asarray(E, jnp.int32)
        LIj_all = jnp.asarray(LI, jnp.int32)
        LJj_all = jnp.asarray(LJ, jnp.int32)
        for c0 in range(0, nb_b, chunk):
            c1 = min(nb_b, c0 + chunk)
            outs.append(chunk_inv(
                self._S5p, Ej_all[:, c0:c1], LIj_all[:, c0:c1],
                LJj_all[:, c0:c1], fmask[c0:c1],
            ))
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs)

    def _bucket_solve(self, xF, faces_b, inv):
        nfb = self.layout.nfb
        nb_b, fsz = faces_b.shape
        xb = xF[faces_b].reshape(nb_b, fsz * nfb)
        yb = jnp.einsum("bij,bj->bi", inv, xb)
        return yb.reshape(nb_b * fsz, nfb)

    def smooth_faces(self, xF):
        """Additive Schwarz: yF = sum_blocks P_b S_b^{-1} P_b^T xF."""
        nfb = self.layout.nfb
        xF = jnp.where(self.freeF, xF, 0.0)
        parts = []
        for (faces_b, _inv, _), solve in zip(self.buckets,
                                             self._bucket_apply):
            nb_b, fsz = faces_b.shape
            xb = xF[faces_b].reshape(nb_b, fsz * nfb)
            parts.append(solve(xb).reshape(nb_b * fsz, nfb))
        slots = jnp.concatenate(
            parts + [jnp.zeros((1, self.layout.nfb), xF.dtype)]
        )
        yF = slots[self.pos3[:, 0]] + slots[self.pos3[:, 1]] + slots[self.pos3[:, 2]]
        return jnp.where(self.freeF, yF, 0.0)

    def smooth(self, x):
        """Flat-vector additive smoother (interiors pass through zero)."""
        lay = self.layout
        xF, _ = lay.split(x)
        yF = self.smooth_faces(xF)
        return lay.join(yF, jnp.zeros((lay.ne, lay.n_int), x.dtype))

    # -- multi-color Gauss-Seidel support -------------------------------

    def color_groups(self, colors: np.ndarray):
        """Per-color solve groups for multiplicative (GS) sweeps.

        ``colors``: (nblocks,) in BUCKET order (= ``block_faces`` order).
        Same-color blocks must be operator-decoupled (face-disjoint
        follows), so the per-color scatter is a single-row gather.
        """
        nface, nfb = self.layout.nface, self.layout.nfb
        ncolors = int(np.max(colors)) + 1
        groups = []
        base = 0
        bucket_meta = []
        for (faces_b, inv, sel), faces_np in zip(self.buckets,
                                                 self._faces_np):
            nb_b = faces_b.shape[0]
            bucket_meta.append((faces_np, inv, base, nb_b))
            base += nb_b
        for c in range(ncolors):
            parts = []
            pos1 = np.full(nface, -1, np.int64)
            slot_base = 0
            for faces_np, inv, b0, nb_b in bucket_meta:
                keep = np.where(colors[b0: b0 + nb_b] == c)[0]
                if not len(keep):
                    continue
                fb_np = faces_np[keep]
                fsz = fb_np.shape[1]
                for b, row in enumerate(fb_np):
                    for k, f in enumerate(row):
                        assert pos1[f] < 0, "same-color blocks share a face"
                        pos1[f] = slot_base + b * fsz + k
                slot_base += len(keep) * fsz
                parts.append(
                    (jnp.asarray(fb_np, jnp.int32),
                     inv[jnp.asarray(keep)])
                )
            pos1 = np.where(pos1 < 0, slot_base, pos1)
            groups.append((parts, jnp.asarray(pos1, jnp.int32)))
        return groups

    def solve_color(self, group, rF):
        """One color's batched block solve: yF = sum_{b in color} P_b
        S_b^{-1} P_b^T rF (blocks face-disjoint -> single-row gather)."""
        parts, pos1 = group
        rF = jnp.where(self.freeF, rF, 0.0)
        outs = [
            self._bucket_solve(rF, faces_b, inv) for faces_b, inv in parts
        ]
        slots = jnp.concatenate(
            outs + [jnp.zeros((1, self.layout.nfb), rF.dtype)]
        )
        return jnp.where(self.freeF, slots[pos1], 0.0)

    # -- row-panel GS: fresh per-color residual without full S applies ---

    def _color_row_groups_device(self, colors: np.ndarray, sdt, inv_sdt):
        """:meth:`color_row_groups` with EVERY table derived on device by
        ONE jitted program.

        A per-table construction path (a gather + cast chain per color and
        per color x bucket inverse table) dispatches ~700 small device
        calls at bench scale.  Batching the whole derivation — residual
        row panels gathered from the on-device skeleton table, per-color
        edge-star inverse tables gathered from the bucket inverses, and
        the storage casts — into one jitted program (tables as ARGUMENTS,
        tiny index plans as constants) makes the phase one compile + one
        execution.
        """
        inv_sdt = inv_sdt or sdt
        lay = self.layout
        nfb, nface, ne = lay.nfb, lay.nface, lay.ne
        n_skel = lay.n_skel
        efaces = lay.efaces_np
        pos = lay.pos_np
        freeF_np = self.freeF_np

        # host metadata pass: per color — member faces, adjacency, result
        # slot map, per-bucket solve slices (index plans only, no matrix
        # data)
        ncolors = int(np.max(colors)) + 1
        bucket_meta = []
        base = 0
        for faces_np in self._faces_np:
            bucket_meta.append((faces_np, base))
            base += faces_np.shape[0]
        efaces_pad_np = np.concatenate(
            [efaces, np.full((1, 4), nface, np.int64)])
        meta = []
        for c in range(ncolors):
            faces_list = []
            parts_meta = []  # (ofs, nkeep, fsz, bucket_idx, keep)
            ofs = 0
            for bi, (faces_np, b0) in enumerate(bucket_meta):
                nb_b = faces_np.shape[0]
                keep = np.where(colors[b0: b0 + nb_b] == c)[0]
                if not len(keep):
                    continue
                fb = faces_np[keep]
                fsz = fb.shape[1]
                faces_list.append(fb.ravel())
                parts_meta.append((ofs, len(keep), fsz, bi, keep))
                ofs += fb.size
            faces_c = np.concatenate(faces_list)
            nsel = len(faces_c)
            assert len(np.unique(faces_c)) == nsel, \
                "same-color blocks share a face"
            # MERGED solve layout + TRANSPOSED (SoA) plans: all of the
            # color's edge-star blocks zero-padded to ONE batch size
            # fsz_max*nfb so the per-color solve is a single table stream
            # (not one per size bucket), and the whole sweep iterate kept
            # TRANSPOSED ((nfb, nface+1) — minor dim the large face axis).
            # Zero padding is exact: padded tables are zero, padded
            # columns are zero.
            fsz_max, nblk_c, gpos, pos1 = _merged_color_plan(
                parts_meta, self._faces_np, nface, nsel)
            # tables carry ONE trailing zero block (the guaranteed zero
            # column the pad indices point at)
            NP, NB = nsel + 1, nblk_c + 1
            p2 = pos[faces_c]  # (nsel, 2) elem*4+lf, pad ne*4
            el2 = p2 // 4
            lf2 = p2 % 4
            plans = _soa_color_plans(
                faces_c, np.where(el2 < ne, el2, ne), efaces_pad_np,
                gpos, pos1, nface, ne, nfb, fsz_max, nblk_c, NP, NB)
            meta.append((faces_c, el2, lf2, parts_meta, fsz_max, plans))

        colm_np = np.concatenate([
            freeF_np[efaces].reshape(ne, n_skel),
            np.zeros((1, n_skel), bool),
        ])
        def build_all(S5p, colm, freeF, *bucket_invs):
            out = []
            for (faces_c, el2, lf2, parts_meta, fsz_max, _plans) in meta:
                nsel = len(faces_c)
                el2j = jnp.asarray(np.where(el2 < ne, el2, ne), jnp.int32)
                lf2j = jnp.asarray(lf2, jnp.int32)
                fcj = jnp.asarray(faces_c, jnp.int32)
                pans = []
                for s in range(2):
                    pan = S5p[el2j[:, s], lf2j[:, s]].reshape(
                        nsel, nfb, n_skel)
                    pan = pan * colm[el2j[:, s]][:, None, :].astype(
                        pan.dtype)
                    pans.append(pan)
                P2 = (jnp.stack(pans, axis=2).reshape(nsel, nfb, 2 * n_skel)
                      * freeF[fcj][:, :, None].astype(pans[0].dtype)
                      ).astype(sdt)
                # one zero pad block ALWAYS (rowio: padded rhs rows and
                # the pad indices' target row must be exact zeros)
                P2 = jnp.concatenate(
                    [P2, jnp.zeros((1, nfb, 2 * n_skel), P2.dtype)])
                # merged padded solve table: every bucket's kept inverses
                # zero-padded to (fsz_max*nfb)^2 and stacked -> the
                # color's solves are ONE batched stream
                bmax = fsz_max * nfb
                tabs = []
                for (_ofs, nkeep, fsz, bi, keep) in parts_meta:
                    t = bucket_invs[bi][jnp.asarray(keep, jnp.int32)]
                    bdim = fsz * nfb
                    if bdim < bmax:
                        t = jnp.pad(
                            t, ((0, 0), (0, bmax - bdim), (0, bmax - bdim)))
                    tabs.append(t)
                inv_c = jnp.concatenate(
                    tabs + [jnp.zeros((1, bmax, bmax), tabs[0].dtype)]
                ).astype(inv_sdt)
                out.append((P2, inv_c))
            return tuple(out)

        built = jax.jit(build_all)(
            self._S5p, jnp.asarray(colm_np), self.freeF,
            *self._bucket_inv_np)
        self._efaces_pad = jnp.asarray(efaces_pad_np, jnp.int32)

        groups = []
        for (*_, plans), (P2, inv_c) in zip(meta, built):
            P_soa = make_table_apply(P2, store_dtype=sdt, soa_io=True)
            solve = make_table_apply(inv_c, store_dtype=inv_sdt, soa_io=True)
            fc, rowA, colA, rowB, colB, rowD, colD = plans
            groups.append((fc, rowA, colA, P_soa, rowB, colB, solve,
                           rowD, colD))
        return groups

    def color_row_groups(self, colors: np.ndarray, S_perm_np: np.ndarray,
                         sdt=jnp.float32, inv_sdt=None):
        """Per-color solve groups that compute the color's residual from
        ROW PANELS of S instead of a full skeleton apply.

        The recompute sweep (``xF - S_faces(y)`` before every color) streams
        the full element-block table S once per color per direction —
        2 x ncolors full streams per GS apply, the dominant cost of the
        gs=True preconditioner (measured ~15 ms vs 8 ms additive at 243k
        dofs).  But color g's block solves only read the residual at color-g
        faces, and a face belongs to exactly 3 edge-stars (its 3 edges, all
        differently colored — same-color blocks share no element), so
        computing r fresh at just those rows streams each face's row panel
        3x per direction total: 3 full-S streams per direction instead of
        ncolors, independent of the color count.

        Per color: for each member face f and each of its <=2 adjacent
        elements e, the panel S_e[rows of f's slot, :] (nfb, n_skel) times
        the element's current skeleton iterate gives (S y)|_f.  Panels are
        free-masked (rows AND columns) at setup, matching S_faces' masking.

        ``colors``: (nblocks,) in bucket order.  ``S_perm_np``: (ne,
        n_skel, n_skel) face-major skeleton element blocks (numpy).
        ``sdt`` is the STORAGE dtype of the residual row panels (the
        dominant stream: 3 full-S equivalents per sweep direction);
        ``inv_sdt`` (defaults to ``sdt``) that of the edge-star inverse
        tables — separable because their iteration-count sensitivity
        differs (bf16 panels are a symmetric perturbation of the sweep's
        residual operator; bf16 inverses perturb the solves themselves).
        Returns groups for :meth:`solve_color_rows`.
        """
        if self._S_dev is not None:
            # device table derivation, ONE builder program for every color
            # — see _color_row_groups_device
            return self._color_row_groups_device(colors, sdt, inv_sdt)
        lay = self.layout
        nfb, nface, ne = lay.nfb, lay.nface, lay.ne
        n_skel = lay.n_skel
        # host topology copies only — no device->host copies in setup
        efaces = lay.efaces_np
        pos = lay.pos_np  # face -> <=2 (elem*4+lf), pad ne*4
        freeF_np = self.freeF_np
        # element-skeleton column mask: free dofs of e's 4 faces
        colmask = freeF_np[efaces].reshape(ne, n_skel)
        efaces_pad_np = np.concatenate(
            [efaces, np.full((1, 4), nface, np.int64)])
        self._efaces_pad = jnp.asarray(efaces_pad_np, jnp.int32)
        inv_sdt = inv_sdt or sdt
        ncolors = int(np.max(colors)) + 1
        base = 0
        bucket_meta = []
        for faces_np, inv_np in zip(self._faces_np, self._bucket_inv_np):
            nb_b = faces_np.shape[0]
            bucket_meta.append((faces_np, inv_np, base, nb_b))
            base += nb_b
        groups = []
        for c in range(ncolors):
            parts_meta = []  # (ofs, nkeep, fsz, bucket_idx, keep)
            faces_list = []
            ofs = 0
            for bi, (faces_b, inv_np, b0, nb_b) in enumerate(bucket_meta):
                keep = np.where(colors[b0: b0 + nb_b] == c)[0]
                if not len(keep):
                    continue
                fb = faces_b[keep]
                fsz = fb.shape[1]
                faces_list.append(fb.ravel())
                parts_meta.append((ofs, len(keep), fsz, bi, keep))
                ofs += fb.size
            faces_c = np.concatenate(faces_list)
            nsel = len(faces_c)
            assert len(np.unique(faces_c)) == nsel, \
                "same-color blocks share a face"
            # merged padded solve table + row-io plans (see
            # _color_row_groups_device): one batched stream per color
            fsz_max, nblk_c, gpos, pos1 = _merged_color_plan(
                parts_meta, self._faces_np, nface, nsel)
            # tables carry ONE trailing zero block (the guaranteed zero
            # column the pad indices point at)
            NP, NB = nsel + 1, nblk_c + 1
            bmax = fsz_max * nfb
            inv_full = np.zeros((nblk_c + 1, bmax, bmax))
            blk = 0
            for (_ofs, nkeep, fsz, bi, keep) in parts_meta:
                bdim = fsz * nfb
                inv_full[blk: blk + nkeep, :bdim, :bdim] = \
                    self._bucket_inv_np[bi][keep]
                blk += nkeep
            # adjacency + row panels for the fresh residual at faces_c
            p2 = pos[faces_c]  # (nsel, 2) elem*4+lf, pad ne*4
            el2 = p2 // 4
            lf2 = p2 % 4
            P = np.zeros((nsel, 2, nfb, n_skel), np.float64)
            for s in range(2):
                real = el2[:, s] < ne
                er = el2[real, s]
                lr = lf2[real, s]
                rows = lr[:, None] * nfb + np.arange(nfb)[None, :]
                pan = S_perm_np[er[:, None, None], rows[:, :, None],
                                np.arange(n_skel)[None, None, :]]
                # mask columns (free dofs of the adjacent element)
                # and rows
                pan = pan * colmask[er][:, None, :]
                pan = pan * freeF_np[faces_c[real]][:, :, None]
                P[real, s] = pan
            # both adjacent-element panels as ONE (nfb, 2*n_skel)
            # block: a single table stream per color
            P2 = np.ascontiguousarray(
                P.transpose(0, 2, 1, 3).reshape(nsel, nfb, 2 * n_skel)
            )
            P2 = np.concatenate([P2, np.zeros((1, nfb, 2 * n_skel))])
            fc, rowA, colA, rowB, colB, rowD, colD = _soa_color_plans(
                faces_c, np.where(el2 < ne, el2, ne), efaces_pad_np,
                gpos, pos1, nface, ne, nfb, fsz_max, nblk_c, NP, NB)
            groups.append((
                fc, rowA, colA,
                make_table_apply(P2, store_dtype=sdt, soa_io=True),
                rowB, colB,
                make_table_apply(inv_full, store_dtype=inv_sdt, soa_io=True),
                rowD, colD,
            ))
        return groups

    def solve_color_rows(self, group, xPT, yPT=None):
        """One color's solves with the residual built from row panels:
        dy = sum_{b in color} P_b S_b^{-1} (xF - S yF)|_rows(b).

        TRANSPOSED (SoA) calling convention: ``xPT``/``yPT`` are the face
        iterate TRANSPOSED with one trailing zero column ((nfb, nface+1),
        free-masked by the caller); the returned update has the same shape
        with a zero pad column, so the sweep accumulates with plain adds
        and the whole color-step is three 2-index gathers and two SoA
        table applies — no pad-concat / transpose / slice launches.
        ``yPT=None`` means the zero iterate (first forward color)."""
        fc, rowA, colA, P_soa, rowB, colB, solve_soa, rowD, colD = group
        xcT = xPT[:, fc]  # (nfb, NP); pad cols read xPT's zero column
        if yPT is None:
            rcT = xcT
        else:
            yeT = yPT[rowA, colA]  # (8nfb, NP)
            rcT = xcT - P_soa(yeT)
        xbT = rcT[rowB, colB]      # (fsz_max*nfb, NB)
        ybT = solve_soa(xbT)
        return ybT[rowD, colD]     # (nfb, nface+1)


def _soa_color_plans(faces_c, el2, efaces_pad_np, gpos, pos1, nface, ne,
                     nfb, fsz_max, nblk_c, NP, NB):
    """Transposed (SoA) gather plans for one color-step.

    The sweep iterate lives as (nfb, nface+1) — minor dim the face axis —
    and every step is three 2-index-array gathers
    around the two SoA table kernels:

      xcT  = xPT[:, fc]            fc   (NP,)          color faces
      yeT  = yPT[rowA, colA]       rowA (8nfb, 1), colA (8nfb, NP)
      xbT  = rcT[rowB, colB]       rowB (bmax, 1), colB (bmax, NB)
      dyT  = ybT[rowD, colD]       rowD (nfb, nface+1), colD (1, nface+1)

    Pad targets are guaranteed-zero columns: face nface of the iterate,
    column nsel of rcT, block nblk_c of the solve output (the appended
    zero table blocks)."""
    nsel = len(faces_c)
    idx8 = efaces_pad_np[
        np.concatenate([el2, np.full((NP - nsel, 2), ne, np.int64)])
    ].reshape(NP, 8)
    fc = np.concatenate([faces_c, np.full(NP - nsel, nface, np.int64)])
    gpos_pad = np.concatenate(
        [gpos, np.full((NB - nblk_c, fsz_max), nsel, np.int64)])
    pos1_pad = np.concatenate([pos1, [nblk_c * fsz_max]])
    rowA = (np.arange(8 * nfb) % nfb)[:, None]
    colA = np.repeat(idx8.T, nfb, axis=0)          # (8nfb, NP)
    rowB = (np.arange(fsz_max * nfb) % nfb)[:, None]
    colB = np.repeat(gpos_pad.T, nfb, axis=0)      # (fsz_max*nfb, NB)
    rowD = ((pos1_pad % fsz_max)[None, :] * nfb
            + np.arange(nfb)[:, None])             # (nfb, nface+1)
    colD = (pos1_pad // fsz_max)[None, :]          # (1, nface+1)
    return tuple(jnp.asarray(a, jnp.int32)
                 for a in (fc, rowA, colA, rowB, colB, rowD, colD))


def _merged_color_plan(parts_meta, faces_by_bucket, nface, nsel):
    """Host index plans for one color's MERGED padded block solve.

    ``parts_meta``: [(ofs, nkeep, fsz, bucket_idx, keep)] in color-row
    order.  Returns (fsz_max, nblk_c, gpos, pos1): ``gpos`` (nblk_c,
    fsz_max) row indices into the color's rc rows (pad -> nsel, a zero
    row), ``pos1`` (nface,) face -> slot in the (nblk_c*fsz_max, nfb)
    padded result (pad -> nblk_c*fsz_max, a zero row)."""
    fsz_max = max(p[2] for p in parts_meta)
    nblk_c = sum(p[1] for p in parts_meta)
    gpos = np.full((nblk_c, fsz_max), nsel, np.int64)
    pos1 = np.full(nface, -1, np.int64)
    blk = 0
    for (ofs, nkeep, fsz, bi, keep) in parts_meta:
        rows = ofs + np.arange(nkeep * fsz).reshape(nkeep, fsz)
        gpos[blk: blk + nkeep, :fsz] = rows
        fb = faces_by_bucket[bi][keep]
        pos1[fb] = ((blk + np.arange(nkeep))[:, None] * fsz_max
                    + np.arange(fsz)[None, :])
        blk += nkeep
    pos1 = np.where(pos1 < 0, nblk_c * fsz_max, pos1)
    return fsz_max, nblk_c, gpos, pos1


def face_star_smoother(layout: FaceBlockLayout, S_skel_perm: np.ndarray,
                       free_mask: np.ndarray, dtype=jnp.float32,
                       S_dev=None):
    """Build a FaceStarSmoother from face-major skeleton element blocks.

    ``S_skel_perm``: (ne, 4nfb, 4nfb) numpy, face-major order.
    ``free_mask``: (n,) full-space free mask.  With ``S_dev`` (the same
    table already on device, f32) the global CSR is never assembled: the
    edge-star blocks are gathered and inverted ON DEVICE.
    """
    lay = layout
    if S_dev is None:
        import scipy.sparse as sp

        ed = lay.eldofs_fb
        ne, nb = ed.shape
        rows = np.repeat(ed[:, :, None], nb, axis=2).ravel()
        cols = np.repeat(ed[:, None, :], nb, axis=1).ravel()
        S_csr = sp.coo_matrix(
            (S_skel_perm.ravel(), (rows, cols)),
            shape=(lay.nface * lay.nfb, lay.nface * lay.nfb),
        ).tocsr()
    else:
        S_csr = None

    edge_faces = _edge_star_faces(lay.mesh)
    free = np.asarray(free_mask)
    freeF = np.concatenate(
        [
            free[: lay.off_c].reshape(lay.nface, lay.nfd_v),
            free[lay.nhd:].reshape(lay.nface, lay.nfd_f),
        ],
        axis=1,
    )
    return FaceStarSmoother(lay, S_csr, edge_faces, freeF, dtype,
                            S_dev=S_dev)


def _edge_star_faces(mesh) -> list[np.ndarray]:
    """edge id -> sorted array of face ids containing that edge."""
    faces = np.asarray(mesh.faces)
    edge_key = {tuple(e): i for i, e in enumerate(mesh.edges.tolist())}
    out: list[list[int]] = [[] for _ in range(mesh.nedge)]
    for f, (a, b, c) in enumerate(faces.tolist()):
        for pair in ((a, b), (a, c), (b, c)):
            out[edge_key[pair]].append(f)
    return [np.asarray(sorted(s), np.int64) for s in out]
