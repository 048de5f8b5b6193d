"""Face-sharded production solver: the fast split-f32 path under shard_map.

Round 3's production path (the bench's phase-1 solver: Jacobi-equilibrated
SPLIT f32 operators with scatter-free face-block applies, the skeleton
edge-star smoother + vector-P1 aux-space coarse correction, MINRES
refinement passes) ran single-device only; the sharded path
(parallel/ddshard.py) still solved with round-1-era plain f64 BPCG over
dof-granular halo exchanges.

This module shards the PRODUCTION algorithm itself.  The unit of
distribution is the face-major layout of ops/faceblock.py:

* elements are partitioned in contiguous index blocks (thin slabs — the
  generators emit roughly-spatially-ordered elements),
* a FACE is owned by the lowest shard among its <=2 adjacent elements, so
  each shard's face rows (nfb-wide blocks, the layout's natural unit) form
  a padded (npad_f, nfb) matrix, and element interiors shard with their
  elements,
* halo exchange moves whole FACE ROWS (nfb contiguous floats), never
  scalar dofs: pack the owned rows other shards touch, one ``all_gather``
  (collective volume = interface area), local einsums over the shard's
  face-major element blocks, and a second packed ``all_gather`` returning
  foreign-face contributions to their owners,
* the aux-space coarse correction reduces to the P1 vertex space with a
  ``psum`` (the coarse residual is tiny) and solves it REPLICATED on every
  shard — the standard data-parallel treatment of a coarse problem.

Vectors stay FLAT: a sharded velocity is (n_shards * nloc,) with per-shard
block [own face rows | own element interiors], a sharded pressure is
(n_shards * ne_max * m,) — so the generic mixed-precision refinement
drivers (solvers/refinement.py) and MINRES run on them unchanged, with
Krylov dots lowering to per-shard partial sums + a scalar all-reduce under
GSPMD.

Parity: the sharded operators compute exactly the single-device sums (the
same element blocks, the same smoother inverses, the same coarse solve) —
only the floating-point reduction ORDER differs, so iteration counts track
the single-device solve to within rounding noise (asserted by the
slow-tier parity test in tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .ddshard import block_element_partition

__all__ = ["FaceShardPlan", "build_sharded_fast_ops",
           "sharded_fast_flagship_solve"]


def _pad_rows_2d(rows: list[np.ndarray], fill, width=None, dtype=np.int64):
    m = width if width is not None else max(
        (len(r) for r in rows), default=0)
    m = max(m, 1)
    out = np.full((len(rows), m), fill, dtype=dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


class FaceShardPlan:
    """Host-side partition + halo-exchange plan for a FaceBlockLayout.

    ``need_extra_faces`` / ``produce_extra_faces``: per-shard global faces
    a shard must additionally see in its halo / write contributions to,
    beyond its own elements' faces (the faces of smoother blocks assigned
    to it).
    """

    def __init__(self, lay, n_shards: int,
                 need_extra_faces: list[set] | None = None,
                 produce_extra_faces: list[set] | None = None):
        self.lay = lay
        self.n_shards = n_shards
        ne, nface = lay.ne, lay.nface
        pos = np.asarray(lay.pos)  # face -> <=2 (elem*4+lf), pad = ne*4
        efaces = np.asarray(lay.efaces)

        es = block_element_partition(ne, n_shards)
        self.elem_shard = es
        # face owner: lowest shard among adjacent elements
        e0 = np.where(pos[:, 0] < ne * 4, pos[:, 0] // 4, 0)
        e1 = np.where(pos[:, 1] < ne * 4, pos[:, 1] // 4, ne - 1)
        fowner = np.minimum(es[e0], np.where(pos[:, 1] < ne * 4,
                                             es[e1], n_shards))
        self.fowner = fowner

        self.own_faces = [np.where(fowner == s)[0] for s in range(n_shards)]
        self.npad_f = max(max((len(o) for o in self.own_faces), default=1), 1)
        slot_f = np.zeros(nface, np.int64)
        for s in range(n_shards):
            slot_f[self.own_faces[s]] = np.arange(len(self.own_faces[s]))
        self.slot_f = slot_f

        self.els_of = [np.where(es == s)[0] for s in range(n_shards)]
        self.ne_max = max(max((len(e) for e in self.els_of), default=1), 1)

        # need set: faces of my elements (+ extras); halo = need \ own
        need = []
        for s in range(n_shards):
            nf = set(np.unique(efaces[self.els_of[s]]).tolist())
            if need_extra_faces is not None:
                nf |= need_extra_faces[s]
            need.append(nf)
        self.halo_faces = [
            np.asarray(sorted(f for f in need[s] if fowner[f] != s),
                       np.int64)
            for s in range(n_shards)
        ]
        self.n_halo_max = max(
            max((len(h) for h in self.halo_faces), default=1), 1)
        halo_pos = [
            {int(f): i for i, f in enumerate(self.halo_faces[s])}
            for s in range(n_shards)
        ]
        self.halo_pos = halo_pos

        # forward packing: own faces of s that appear in anyone's halo
        pack = [[] for _ in range(n_shards)]
        pack_pos = [dict() for _ in range(n_shards)]
        for s in range(n_shards):
            for f in self.halo_faces[s]:
                o = int(fowner[f])
                if int(f) not in pack_pos[o]:
                    pack_pos[o][int(f)] = len(pack[o])
                    pack[o].append(int(f))
        self.Bmax = max(max((len(p) for p in pack), default=1), 1)
        self.pack_slots = _pad_rows_2d(
            [slot_f[np.asarray(p, np.int64)] if p else np.zeros(0, np.int64)
             for p in pack], fill=0, width=self.Bmax)
        self.pack_mask = _pad_rows_2d(
            [np.ones(len(p), np.int64) for p in pack], fill=0,
            width=self.Bmax)
        # halo fetch positions in the gathered (n_shards*Bmax) row buffer
        self.halo_src = _pad_rows_2d(
            [np.asarray(
                [int(fowner[f]) * self.Bmax + pack_pos[int(fowner[f])][int(f)]
                 for f in self.halo_faces[s]], np.int64)
             for s in range(n_shards)], fill=0, width=self.n_halo_max)
        self.halo_mask = _pad_rows_2d(
            [np.ones(len(h), np.int64) for h in self.halo_faces],
            fill=0, width=self.n_halo_max)

        # produce set: foreign faces my elements (or extras) write to
        prod = []
        for s in range(n_shards):
            pf = set(np.unique(efaces[self.els_of[s]]).tolist())
            if produce_extra_faces is not None:
                pf |= produce_extra_faces[s]
            prod.append(sorted(int(f) for f in pf if fowner[f] != s))
        self.prod_faces = [np.asarray(p, np.int64) for p in prod]
        self.n_prod_pad = max(
            max((len(p) for p in prod), default=1), 1)
        prod_pos = [
            {int(f): i for i, f in enumerate(prod[s])}
            for s in range(n_shards)
        ]
        self.prod_pos = prod_pos
        # reverse fold: where in the gathered (n_shards*n_prod_pad) buffer
        # live rows destined to shard t, and at which own slot they land
        rev_src, rev_dst = [], []
        for t in range(n_shards):
            src, dst = [], []
            for s in range(n_shards):
                for i, f in enumerate(prod[s]):
                    if int(fowner[f]) == t:
                        src.append(s * self.n_prod_pad + i)
                        dst.append(int(slot_f[f]))
            rev_src.append(np.asarray(src, np.int64))
            rev_dst.append(np.asarray(dst, np.int64))
        wid = max(max((len(r) for r in rev_src), default=1), 1)
        self.rev_src = _pad_rows_2d(rev_src, fill=0, width=wid)
        self.rev_dst = _pad_rows_2d(rev_dst, fill=0, width=wid)
        self.rev_mask = _pad_rows_2d(
            [np.ones(len(r), np.int64) for r in rev_src], fill=0, width=wid)

        # local face id: own face -> slot, halo face -> npad_f + halo pos,
        # anything else -> zero row (npad_f + n_halo_max)
        self.zero_row = self.npad_f + self.n_halo_max
        loc_id = np.full((n_shards, nface), self.zero_row, np.int64)
        for s in range(n_shards):
            loc_id[s, self.own_faces[s]] = slot_f[self.own_faces[s]]
            if len(self.halo_faces[s]):
                loc_id[s, self.halo_faces[s]] = (
                    self.npad_f + np.arange(len(self.halo_faces[s]))
                )
        self.loc_id = loc_id

        # per-shard element-face tables in local ids, padded elements -> 0
        efl = np.zeros((n_shards, self.ne_max, 4), np.int64)
        for s in range(n_shards):
            sel = self.els_of[s]
            efl[s, : len(sel)] = loc_id[s][efaces[sel]]
        self.efaces_loc = efl

        # sibling-assembly plan: for [own | produce] faces of shard s, the
        # <=2 (local elem*4+lf) slots OF THIS SHARD feeding the face (a
        # foreign sibling's contribution is folded by its own shard);
        # pad -> ne_max*4 (a zero row)
        pos2 = np.full(
            (n_shards, self.npad_f + self.n_prod_pad, 2),
            self.ne_max * 4, np.int64,
        )
        eloc = np.full((n_shards, ne), -1, np.int64)
        for s in range(n_shards):
            eloc[s, self.els_of[s]] = np.arange(len(self.els_of[s]))
        for s in range(n_shards):
            targets = np.concatenate(
                [self.own_faces[s], self.prod_faces[s]]).astype(np.int64)
            rows = np.concatenate([
                np.arange(len(self.own_faces[s])),
                self.npad_f + np.arange(len(self.prod_faces[s])),
            ]) if len(targets) else np.zeros(0, np.int64)
            for f, r in zip(targets, rows):
                k = 0
                for c in range(2):
                    slot = pos[f, c]
                    if slot < ne * 4 and es[slot // 4] == s:
                        le = eloc[s, slot // 4]
                        pos2[s, r, k] = le * 4 + (slot % 4)
                        k += 1
        self.pos2 = pos2

        # local face id -> row in the [own | produce] output buffer (halo
        # faces a shard writes to are by construction in its produce set);
        # everything else -> a dump row one past the buffer (dropped)
        loc2op = np.full((n_shards, self.zero_row + 1),
                         self.npad_f + self.n_prod_pad, np.int64)
        for s in range(n_shards):
            nown = len(self.own_faces[s])
            loc2op[s, :nown] = np.arange(nown)
            for f in self.halo_faces[s]:
                if int(f) in prod_pos[s]:
                    loc2op[s, loc_id[s][f]] = (
                        self.npad_f + prod_pos[s][int(f)])
        self.loc2op = loc2op

    # -- host-side layout conversions ------------------------------------

    def split_np(self, x: np.ndarray):
        lay = self.lay
        uF = np.concatenate(
            [x[: lay.off_c].reshape(lay.nface, lay.nfd_v),
             x[lay.nhd:].reshape(lay.nface, lay.nfd_f)], axis=1)
        ui = x[lay.off_c: lay.nhd].reshape(lay.ne, lay.n_int)
        return uF, ui

    def join_np(self, uF: np.ndarray, ui: np.ndarray):
        lay = self.lay
        return np.concatenate([
            uF[:, : lay.nfd_v].reshape(-1), ui.reshape(-1),
            uF[:, lay.nfd_v:].reshape(-1),
        ])

    @property
    def nloc(self) -> int:
        return self.npad_f * self.lay.nfb + self.ne_max * self.lay.n_int

    def vel_to_sharded(self, x: np.ndarray) -> np.ndarray:
        """Global flat velocity (n,) -> sharded flat (n_shards * nloc,)."""
        lay = self.lay
        uF, ui = self.split_np(np.asarray(x))
        out = np.zeros((self.n_shards, self.nloc), np.asarray(x).dtype)
        nF = self.npad_f * lay.nfb
        for s in range(self.n_shards):
            o = self.own_faces[s]
            blk = np.zeros((self.npad_f, lay.nfb), uF.dtype)
            blk[: len(o)] = uF[o]
            out[s, :nF] = blk.reshape(-1)
            e = self.els_of[s]
            bi = np.zeros((self.ne_max, lay.n_int), ui.dtype)
            bi[: len(e)] = ui[e]
            out[s, nF:] = bi.reshape(-1)
        return out.reshape(-1)

    def vel_to_global(self, xs: np.ndarray) -> np.ndarray:
        lay = self.lay
        xs = np.asarray(xs).reshape(self.n_shards, self.nloc)
        nF = self.npad_f * lay.nfb
        uF = np.zeros((lay.nface, lay.nfb), xs.dtype)
        ui = np.zeros((lay.ne, lay.n_int), xs.dtype)
        for s in range(self.n_shards):
            o = self.own_faces[s]
            uF[o] = xs[s, :nF].reshape(self.npad_f, lay.nfb)[: len(o)]
            e = self.els_of[s]
            ui[e] = xs[s, nF:].reshape(self.ne_max, lay.n_int)[: len(e)]
        return self.join_np(uF, ui)

    def p_to_sharded(self, p: np.ndarray, m: int, fill=0.0) -> np.ndarray:
        pe = np.asarray(p).reshape(self.lay.ne, m)
        out = np.full((self.n_shards, self.ne_max, m), fill, pe.dtype)
        for s in range(self.n_shards):
            e = self.els_of[s]
            out[s, : len(e)] = pe[e]
        return out.reshape(-1)

    def p_to_global(self, ps: np.ndarray, m: int) -> np.ndarray:
        ps = np.asarray(ps).reshape(self.n_shards, self.ne_max, m)
        out = np.zeros((self.lay.ne, m), ps.dtype)
        for s in range(self.n_shards):
            e = self.els_of[s]
            out[e] = ps[s, : len(e)]
        return out.reshape(-1)

    def faces_to_sharded(self, xF: np.ndarray, fill=0) -> np.ndarray:
        """(nface, k...) face-row data -> (n_shards, npad_f, k...)."""
        out = np.full((self.n_shards, self.npad_f) + xF.shape[1:], fill,
                      xF.dtype)
        for s in range(self.n_shards):
            o = self.own_faces[s]
            out[s, : len(o)] = xF[o]
        return out

    def elems_to_sharded(self, xe: np.ndarray, fill=0.0) -> np.ndarray:
        """(ne, k...) element data -> (n_shards, ne_max, k...)."""
        out = np.full((self.n_shards, self.ne_max) + xe.shape[1:], fill,
                      xe.dtype)
        for s in range(self.n_shards):
            e = self.els_of[s]
            out[s, : len(e)] = xe[e]
        return out

    def exchange_tables(self) -> dict:
        return dict(
            pack_slots=self.pack_slots, pack_mask=self.pack_mask,
            halo_src=self.halo_src, halo_mask=self.halo_mask,
            rev_src=self.rev_src, rev_dst=self.rev_dst,
            rev_mask=self.rev_mask, efaces_loc=self.efaces_loc,
            pos2=self.pos2, loc2op=self.loc2op,
        )


def _halo_gather(t, uF_own, axis):
    """uF_loc = [own rows | halo rows | zero row] via one all_gather."""
    packed = jnp.where(t["pack_mask"][:, None] > 0, uF_own[t["pack_slots"]],
                       0.0)
    all_pk = jax.lax.all_gather(packed, axis)  # (n_shards, Bmax, nfb)
    halo = jnp.where(
        t["halo_mask"][:, None] > 0,
        all_pk.reshape(-1, uF_own.shape[1])[t["halo_src"]], 0.0)
    zero = jnp.zeros((1, uF_own.shape[1]), uF_own.dtype)
    return jnp.concatenate([uF_own, halo, zero])


def _rev_fold(t, y_ownprod, npad_f, axis):
    """Fold the produce rows back onto their owners; returns own rows."""
    y_own = y_ownprod[:npad_f]
    all_rv = jax.lax.all_gather(y_ownprod[npad_f:], axis)
    add = jnp.where(
        t["rev_mask"][:, None] > 0,
        all_rv.reshape(-1, y_ownprod.shape[1])[t["rev_src"]], 0.0)
    return y_own.at[t["rev_dst"]].add(add)


def _sibling_assemble(t, ye_skel, nfb):
    """(ne_max, 4*nfb) element skeleton results -> [own | produce] face
    rows via the two-sibling gather (scatter-free)."""
    yf = ye_skel.reshape(-1, nfb)
    yf = jnp.concatenate([yf, jnp.zeros((1, nfb), yf.dtype)])
    return yf[t["pos2"][:, 0]] + yf[t["pos2"][:, 1]]


def build_sharded_fast_ops(m, mesh: Mesh, axis: str = "shard",
                           gs: bool = False):
    """Shard the production split-f32 operator stack + preconditioner of a
    3D MCS model (the algorithm bench.py measures single-device) over
    ``mesh``'s ``axis``.

    Returns (ops32, ops64, D_sh, plan, aux): ops dicts with A/B/BT (plus
    preA/preM in ops32) acting on FLAT sharded vectors; ``D_sh`` the
    equilibration diagonal in the sharded velocity layout.  The math is
    identical to solvers/refinement.equilibrated_f32_ops(split=True):
    Jacobi-equilibrated split hi/lo f32 element blocks in face-major
    order, the skeleton preconditioner (edge-star smoother + damped
    vector-P1 aux-space coarse on the skeleton Schur complement, exact
    interior solves, harmonic extension).  ``gs=True`` shards the
    symmetric multi-color ROW-PANEL block-GS sweep (the bench default):
    each color refreshes the face halo of the current iterate (one
    all_gather), computes its residual from row panels of S at just that
    color's faces, batch-solves its edge-star blocks, and folds foreign
    face updates back to their owners — 2 face-row exchanges per color,
    color-count-independent panel volume, exactly the single-device
    sweep's math (ops/faceblock.color_row_groups).
    """
    from ..fem.spaces import H1
    from ..ops.faceblock import face_star_smoother
    from ..precond.multicolor import color_blocks, damped_coarse
    from ..precond.twolevel import coarse_p1_solver

    lay = m.fb
    assert lay is not None, "sharded fast ops need the face-block layout"
    n_shards = mesh.shape[axis]
    nfb, n_int, n_skel = lay.nfb, lay.n_int, lay.n_skel
    mQ = int(np.asarray(m.Q.element_dofs).shape[1])

    # ---- equilibration + split blocks (same host math as
    # equilibrated_f32_ops) ----------------------------------------------
    A_loc = m.A_cond_np
    eldofs = np.asarray(m.Xv.element_dofs)
    d = np.zeros(m.n)
    np.add.at(d, eldofs.ravel(), np.einsum("eii->ei", A_loc).ravel())
    free = np.asarray(m.free)
    D = np.ones(m.n)
    D[free] = 1.0 / np.sqrt(np.maximum(np.abs(d[free]), 1e-300))
    De = D[eldofs]
    A_s = A_loc * De[:, :, None] * De[:, None, :]
    A_sp = lay.permute_blocks(A_s)
    A_hi = A_sp.astype(np.float32)
    A_lo = (A_sp - A_hi.astype(np.float64)).astype(np.float32)
    B_np = getattr(m, "_B_host", None)
    if B_np is None:
        B_np = np.asarray(m._B_loc, np.float64)
    B_sp = (np.asarray(B_np, np.float64) * De[:, None, :])[:, :, lay.perm]
    B_hi = B_sp.astype(np.float32)
    B_lo = (B_sp - B_hi.astype(np.float64)).astype(np.float32)

    # ---- skeleton preconditioner host setup (same tables as the
    # single-device build_skeleton_preconditioner_3d fast path) -----------
    nbv = m.Xv.hdiv.n_basis
    n_face_tot = 4 * lay.nfd_v
    loc_int = np.arange(n_face_tot, nbv)
    nfac = lay.nfd_f * 4
    loc_skel = np.concatenate(
        [np.arange(n_face_tot), np.arange(nbv, nbv + nfac)])
    A_ii = A_s[:, loc_int[:, None], loc_int[None, :]]
    A_is = A_s[:, loc_int[:, None], loc_skel[None, :]]
    A_ss = A_s[:, loc_skel[:, None], loc_skel[None, :]]
    A_ii_inv = np.linalg.inv(A_ii)
    AinvAis = np.matmul(A_ii_inv, A_is)
    S_loc = A_ss - np.matmul(A_is.transpose(0, 2, 1), AinvAis)
    S_perm = lay.permute_skel_blocks(S_loc)
    AinvAis_perm = np.ascontiguousarray(AinvAis[:, :, lay.perm_skel])

    fmask = np.asarray(m.Xv.free_mask)
    sm = face_star_smoother(lay, S_perm, fmask, jnp.float32)

    space = H1(m.Xv.mesh, 1, dirichlet=m._dirich)
    solve1 = coarse_p1_solver(space, m.nu, jnp.float32)
    nv = m.Xv.mesh.nv
    M_F, faces_np = _face_transfer_tables(m.Xv, lay)

    # ---- plan with smoother-extended need/produce sets -------------------
    es = block_element_partition(lay.ne, n_shards)
    pos_np = np.asarray(lay.pos)
    e0 = np.where(pos_np[:, 0] < lay.ne * 4, pos_np[:, 0] // 4, 0)
    e1 = np.where(pos_np[:, 1] < lay.ne * 4, pos_np[:, 1] // 4, lay.ne - 1)
    fowner0 = np.minimum(es[e0], np.where(pos_np[:, 1] < lay.ne * 4,
                                          es[e1], n_shards))
    # blocks in bucket order; a block lives on the owner of its first face
    blk_shard = [int(fowner0[np.asarray(bf)[0]]) for bf in sm.block_faces]
    efaces_np = np.asarray(lay.efaces)
    need_extra = [set() for _ in range(n_shards)]
    prod_extra = [set() for _ in range(n_shards)]
    for b, bf in enumerate(sm.block_faces):
        s = blk_shard[b]
        for f in np.asarray(bf).tolist():
            need_extra[s].add(int(f))
            if int(fowner0[f]) != s:
                prod_extra[s].add(int(f))
            if gs:
                # the GS row panels read the iterate at ALL faces of the
                # <=2 elements adjacent to each block face
                for slot in pos_np[f]:
                    if slot < lay.ne * 4:
                        for f2 in efaces_np[slot // 4].tolist():
                            need_extra[s].add(int(f2))

    plan = FaceShardPlan(lay, n_shards, need_extra, prod_extra)
    assert np.array_equal(plan.fowner, fowner0)

    shard_spec = NamedSharding(mesh, P(axis))

    def put_sh(x, dt=None):
        return jax.device_put(
            jnp.asarray(x, dt) if dt is not None else jnp.asarray(x),
            shard_spec)

    # ---- sharded constant tables -----------------------------------------
    ex = {k: put_sh(v) for k, v in plan.exchange_tables().items()}
    A_hi_sh = put_sh(plan.elems_to_sharded(A_hi))
    A_lo_sh = put_sh(plan.elems_to_sharded(A_lo))
    B_hi_sh = put_sh(plan.elems_to_sharded(B_hi))
    B_lo_sh = put_sh(plan.elems_to_sharded(B_lo))
    # the f64 residual operators are UNEQUILIBRATED (the refinement driver
    # conjugates the inner system by D itself)
    A_64_sh = put_sh(plan.elems_to_sharded(lay.permute_blocks(A_loc)))
    B_64_sh = put_sh(plan.elems_to_sharded(
        np.ascontiguousarray(np.asarray(B_np, np.float64)[:, :, lay.perm])
    ))
    ext_sh = put_sh(plan.elems_to_sharded(AinvAis_perm.astype(np.float32)))
    inner_sh = put_sh(plan.elems_to_sharded(A_ii_inv.astype(np.float32)))

    freeF_np = np.asarray(sm.freeF)
    freeF_sh = put_sh(plan.faces_to_sharded(freeF_np, fill=False))
    free_flat = put_sh(plan.vel_to_sharded(
        np.asarray(m.free)).reshape(n_shards, -1)).reshape(-1)
    # padded slots must scale by 1, not 0 (D multiplies iterates)
    ones_pad = plan.vel_to_sharded(np.ones(m.n))
    D_fix = np.where(ones_pad > 0, plan.vel_to_sharded(D), 1.0)
    D_sh = put_sh(D_fix.reshape(n_shards, -1)).reshape(-1)

    diag_Mp = np.maximum(np.asarray(m._diag_Mp, np.float64), 1e-300)
    dM = put_sh(
        plan.p_to_sharded(diag_Mp, mQ, fill=1.0).reshape(n_shards, -1),
        jnp.float32).reshape(-1)

    # coarse tables: M_F rows + face vertex ids sharded by face owner;
    # DinvF (equilibration on face rows) sharded
    M_F_sh = put_sh(plan.faces_to_sharded(M_F.astype(np.float32), fill=0.0))
    fverts_sh = put_sh(plan.faces_to_sharded(faces_np.astype(np.int64)))
    dinv = 1.0 / D
    DinvF_np = np.concatenate(
        [dinv[: lay.off_c].reshape(lay.nface, lay.nfd_v),
         dinv[lay.nhd:].reshape(lay.nface, lay.nfd_f)], axis=1)
    DinvF_sh = put_sh(
        plan.faces_to_sharded(DinvF_np.astype(np.float32), fill=0.0))

    # smoother buckets sharded: per bucket, the blocks assigned to each
    # shard (inverse tables + LOCAL face ids + mask), padded per shard
    bucket_tabs = []
    bucket_fsz = []
    b0 = 0
    for (faces_b, _inv_j, _sel), inv_np in zip(sm.buckets,
                                               sm._bucket_inv_np):
        fb_np = np.asarray(faces_b)
        nb_b, fsz = fb_np.shape
        sel_by_shard = [
            np.where(np.asarray(blk_shard[b0: b0 + nb_b]) == s)[0]
            for s in range(n_shards)
        ]
        nb_max = max(max((len(x) for x in sel_by_shard), default=1), 1)
        inv_t = np.zeros((n_shards, nb_max, fsz * nfb, fsz * nfb),
                         np.float32)
        fl_t = np.full((n_shards, nb_max, fsz), plan.zero_row, np.int64)
        mask_t = np.zeros((n_shards, nb_max), np.float32)
        for s in range(n_shards):
            ks = sel_by_shard[s]
            inv_t[s, : len(ks)] = inv_np[ks]
            fl_t[s, : len(ks)] = plan.loc_id[s][fb_np[ks]]
            mask_t[s, : len(ks)] = 1.0
        bucket_tabs.append(dict(
            inv=put_sh(inv_t), floc=put_sh(fl_t), mask=put_sh(mask_t)))
        bucket_fsz.append(fsz)
        b0 += nb_b

    npad_f, ne_max = plan.npad_f, plan.ne_max
    n_prod_pad = plan.n_prod_pad
    nF = npad_f * nfb
    nloc = plan.nloc
    spec_sh = P(axis)

    def tree_specs(tree):
        return jax.tree.map(lambda _: spec_sh, tree)

    # ------------------------------------------------------------------
    # element-block saddle operators (A, B, BT), one shard_map each
    # ------------------------------------------------------------------

    def _split_loc(xb):
        uF = xb[:nF].reshape(npad_f, nfb)
        ui = xb[nF:].reshape(ne_max, n_int)
        return uF, ui

    def _join_loc(uF, ui):
        return jnp.concatenate([uF.reshape(-1), ui.reshape(-1)])

    def make_elem_apply(mats_list):
        """Sharded y = (sum_k A_k) u for face-major element blocks."""
        tabs = dict(ex=ex, mats=mats_list)

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(tree_specs(tabs), spec_sh), out_specs=spec_sh)
        def apply_sh(t, x):
            te = jax.tree.map(lambda a: a[0], t["ex"])
            uF, ui = _split_loc(x[0])
            uF_loc = _halo_gather(te, uF, axis)
            ue = jnp.concatenate(
                [uF_loc[te["efaces_loc"]].reshape(ne_max, n_skel), ui],
                axis=1)
            ye = None
            for mk in t["mats"]:
                tt = jnp.einsum("eij,ej->ei", mk[0], ue)
                ye = tt if ye is None else ye + tt
            y_op = _sibling_assemble(te, ye[:, :n_skel], nfb)
            yF = _rev_fold(te, y_op, npad_f, axis)
            return _join_loc(yF, ye[:, n_skel:])[None]

        def apply(x):
            return apply_sh(tabs, x.reshape(n_shards, nloc)).reshape(-1)

        return apply

    def make_B_apply(mats_list):
        tabs = dict(ex=ex, mats=mats_list)

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(tree_specs(tabs), spec_sh), out_specs=spec_sh)
        def apply_sh(t, x):
            te = jax.tree.map(lambda a: a[0], t["ex"])
            uF, ui = _split_loc(x[0])
            uF_loc = _halo_gather(te, uF, axis)
            ue = jnp.concatenate(
                [uF_loc[te["efaces_loc"]].reshape(ne_max, n_skel), ui],
                axis=1)
            pe = None
            for mk in t["mats"]:
                tt = jnp.einsum("epi,ei->ep", mk[0], ue)
                pe = tt if pe is None else pe + tt
            return pe.reshape(-1)[None]

        def apply(x):
            return apply_sh(tabs, x.reshape(n_shards, nloc)).reshape(-1)

        return apply

    def make_BT_apply(mats_list):
        tabs = dict(ex=ex, mats=mats_list)

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(tree_specs(tabs), spec_sh), out_specs=spec_sh)
        def apply_sh(t, p):
            te = jax.tree.map(lambda a: a[0], t["ex"])
            pe = p[0].reshape(ne_max, mQ)
            ye = None
            for mk in t["mats"]:
                tt = jnp.einsum("epi,ep->ei", mk[0], pe)
                ye = tt if ye is None else ye + tt
            y_op = _sibling_assemble(te, ye[:, :n_skel], nfb)
            yF = _rev_fold(te, y_op, npad_f, axis)
            return _join_loc(yF, ye[:, n_skel:])[None]

        def apply(p):
            return apply_sh(tabs, p.reshape(n_shards, ne_max * mQ)
                            ).reshape(-1)

        return apply

    _A32 = make_elem_apply([A_hi_sh, A_lo_sh])
    _B32 = make_B_apply([B_hi_sh, B_lo_sh])
    _BT32 = make_BT_apply([B_hi_sh, B_lo_sh])
    _A64 = make_elem_apply([A_64_sh])
    _B64 = make_B_apply([B_64_sh])
    _BT64 = make_BT_apply([B_64_sh])

    def masked_A(Araw):
        def A(u):
            uf = jnp.where(free_flat, u, 0.0)
            return jnp.where(free_flat, Araw(uf), u)
        return A

    def masked_B(Braw):
        return lambda u: Braw(jnp.where(free_flat, u, 0.0))

    def masked_BT(BTraw):
        return lambda p: jnp.where(free_flat, BTraw(p), 0.0)

    # ------------------------------------------------------------------
    # the skeleton preconditioner: preA = E (smooth[+coarse]) E^T + inner
    # ------------------------------------------------------------------

    def _coarse_rows(t, rF):
        """Aux-space P1 coarse: psum-reduced vertex residual, replicated
        solve, local face rows (the sharded hybrid_h1_face_transfer)."""
        rFc = t["DinvF"][0] * rF
        g = jnp.einsum("fri,fr->fi", t["M_F"][0], rFc)  # (npad_f, 9)
        part = jnp.zeros((nv, 3), g.dtype).at[t["fverts"][0]].add(
            g.reshape(npad_f, 3, 3))
        z = solve1(jax.lax.psum(part, axis))  # replicated (nv, 3)
        cloc = z[t["fverts"][0]].reshape(npad_f, 9)
        return t["DinvF"][0] * jnp.einsum("fri,fi->fr", t["M_F"][0], cloc)

    def _extT_rows(t, te, xF, xi):
        """Fold the interior residual into the skeleton (free-masked)."""
        rs = -jnp.einsum("eis,ei->es", t["ext"][0], xi)
        r_op = _sibling_assemble(te, rs, nfb)
        r_op = r_op.at[:npad_f].add(xF)
        return jnp.where(t["freeF"][0],
                         _rev_fold(te, r_op, npad_f, axis), 0.0)

    def _ext_inner(t, te, yF, xi):
        """Harmonic extension of skeleton values + exact interior solve."""
        yF_loc = _halo_gather(te, yF, axis)
        ys = yF_loc[te["efaces_loc"]].reshape(ne_max, n_skel)
        yi = -jnp.einsum("eis,es->ei", t["ext"][0], ys)
        return yi + jnp.einsum("eij,ej->ei", t["inner"][0], xi)

    if not gs:
        pre_tabs = dict(
            ex=ex, ext=ext_sh, inner=inner_sh, freeF=freeF_sh,
            M_F=M_F_sh, fverts=fverts_sh, DinvF=DinvF_sh,
            buckets=bucket_tabs,
        )

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(tree_specs(pre_tabs), spec_sh),
                 out_specs=spec_sh)
        def preA_sh(t, x):
            te = jax.tree.map(lambda a: a[0], t["ex"])
            freeF = t["freeF"][0]
            xF, xi = _split_loc(x[0])
            rF = _extT_rows(t, te, xF, xi)

            # one halo refresh serves every smoother block on this shard
            rF_loc = _halo_gather(te, rF, axis)

            # additive edge-star smoother: batched bucket solves
            # accumulated into the [own | produce] buffer, then folded
            y_op = jnp.zeros((npad_f + n_prod_pad, nfb), rF.dtype)
            for bt, fsz in zip(t["buckets"], bucket_fsz):
                inv, floc, mask = bt["inv"][0], bt["floc"][0], bt["mask"][0]
                xb = rF_loc[floc].reshape(inv.shape[0], fsz * nfb)
                yb = jnp.einsum("bij,bj->bi", inv, xb) * mask[:, None]
                tgt = te["loc2op"][floc.reshape(-1)]
                y_op = y_op.at[tgt].add(yb.reshape(-1, nfb), mode="drop")
            yF_sm = _rev_fold(te, y_op, npad_f, axis)

            yF = jnp.where(freeF, yF_sm + _coarse_rows(t, rF), 0.0)
            yi = _ext_inner(t, te, yF, xi)
            return _join_loc(yF, yi)[None]

        def preA(x):
            xf = jnp.where(free_flat, x, 0.0)
            y = preA_sh(pre_tabs, xf.reshape(n_shards, nloc)).reshape(-1)
            return jnp.where(free_flat, y, x)

    else:
        # ---- sharded symmetric multi-color row-panel GS sweep ----------
        S32 = S_perm.astype(np.float32)
        S_sh = put_sh(plan.elems_to_sharded(S32))
        colmask = freeF_np[efaces_np].reshape(lay.ne, n_skel)
        blocks_fb = [
            (np.asarray(f)[:, None] * nfb + np.arange(nfb)[None, :]).ravel()
            for f in sm.block_faces
        ]
        colors = color_blocks(blocks_fb, lay.nface * nfb, lay.eldofs_fb)

        # per color, per bucket-size part, per shard: padded block
        # inverses, LOCAL block-face ids, the (nfb, 2*n_skel) row panels
        # of S at each block face, and the local face ids of the <=2
        # adjacent elements' faces (for the panel gather of the iterate)
        b0s = []
        off = 0
        for faces_b, _ij, _sel in sm.buckets:
            b0s.append(off)
            off += np.asarray(faces_b).shape[0]
        ncolors = int(np.max(colors)) + 1
        color_tabs = []
        color_meta = []
        for c in range(ncolors):
            parts = []
            meta = []
            for (faces_b, _ij, _sel), inv_np, b0 in zip(
                    sm.buckets, sm._bucket_inv_np, b0s):
                fb_np = np.asarray(faces_b)
                nb_b, fsz = fb_np.shape
                keep = np.where(colors[b0: b0 + nb_b] == c)[0]
                if not len(keep):
                    continue
                kshard = np.asarray(
                    [blk_shard[b0 + int(k)] for k in keep])
                ks_by_shard = [keep[kshard == s] for s in range(n_shards)]
                nb_max = max(
                    max((len(x) for x in ks_by_shard), default=1), 1)
                inv_t = np.zeros(
                    (n_shards, nb_max, fsz * nfb, fsz * nfb), np.float32)
                fl_t = np.full((n_shards, nb_max, fsz), plan.zero_row,
                               np.int64)
                mask_t = np.zeros((n_shards, nb_max), np.float32)
                P2_t = np.zeros(
                    (n_shards, nb_max, fsz, nfb, 2 * n_skel), np.float32)
                ef2_t = np.full((n_shards, nb_max, fsz, 2, 4),
                                plan.zero_row, np.int64)
                for s in range(n_shards):
                    ks = ks_by_shard[s]
                    inv_t[s, : len(ks)] = inv_np[ks]
                    mask_t[s, : len(ks)] = 1.0
                    for j, k in enumerate(ks):
                        faces = fb_np[int(k)]
                        fl_t[s, j] = plan.loc_id[s][faces]
                        for fi, f in enumerate(faces.tolist()):
                            rowmask = freeF_np[f]
                            for s2 in range(2):
                                slot = int(pos_np[f, s2])
                                if slot >= lay.ne * 4:
                                    continue
                                e, lf = slot // 4, slot % 4
                                pan = (
                                    S32[e, lf * nfb:(lf + 1) * nfb, :]
                                    * colmask[e][None, :]
                                    * rowmask[:, None]
                                )
                                P2_t[s, j, fi, :,
                                     s2 * n_skel:(s2 + 1) * n_skel] = pan
                                ef2_t[s, j, fi, s2] = (
                                    plan.loc_id[s][efaces_np[e]]
                                )
                parts.append(dict(
                    inv=put_sh(inv_t), floc=put_sh(fl_t),
                    mask=put_sh(mask_t), P2=put_sh(P2_t),
                    ef2=put_sh(ef2_t)))
                meta.append((fsz, nb_max))
            color_tabs.append(parts)
            color_meta.append(meta)

        # the coarse damping scale: power-iterate lambda_max(C S) with the
        # SHARDED face-vector operators (same math as the single-device
        # damped_coarse at _build_skeleton_fast)
        S_tabs = dict(ex=ex, S=S_sh, freeF=freeF_sh)

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(tree_specs(S_tabs), spec_sh), out_specs=spec_sh)
        def S_fv_sh(t, xf):
            te = jax.tree.map(lambda a: a[0], t["ex"])
            freeF = t["freeF"][0]
            xF = jnp.where(freeF, xf[0].reshape(npad_f, nfb), 0.0)
            xF_loc = _halo_gather(te, xF, axis)
            ue = xF_loc[te["efaces_loc"]].reshape(ne_max, n_skel)
            ye = jnp.einsum("eij,ej->ei", t["S"][0], ue)
            y_op = _sibling_assemble(te, ye, nfb)
            yF = _rev_fold(te, y_op, npad_f, axis)
            return jnp.where(freeF, yF, 0.0).reshape(-1)[None]

        c_tabs = dict(M_F=M_F_sh, fverts=fverts_sh, DinvF=DinvF_sh,
                      freeF=freeF_sh)

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(tree_specs(c_tabs), spec_sh), out_specs=spec_sh)
        def coarse_fv_sh(t, rf):
            yc = _coarse_rows(t, rf[0].reshape(npad_f, nfb))
            return jnp.where(t["freeF"][0], yc, 0.0).reshape(-1)[None]

        def S_fv(x):
            return S_fv_sh(
                S_tabs, x.reshape(n_shards, npad_f * nfb)).reshape(-1)

        def coarse_fv(x):
            return coarse_fv_sh(
                c_tabs, x.reshape(n_shards, npad_f * nfb)).reshape(-1)

        rng = np.random.default_rng(7)
        exF = (rng.standard_normal((lay.nface, nfb))
               * freeF_np).astype(np.float32)
        ex_fv = put_sh(plan.faces_to_sharded(exF, fill=0.0).reshape(
            n_shards, -1)).reshape(-1)
        _, _lam, theta = damped_coarse(coarse_fv, S_fv, ex_fv)
        theta_j = jnp.asarray(theta, jnp.float32)

        gs_tabs = dict(ex=ex, ext=ext_sh, inner=inner_sh, freeF=freeF_sh,
                       M_F=M_F_sh, fverts=fverts_sh, DinvF=DinvF_sh,
                       S=S_sh, colors=color_tabs)

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(tree_specs(gs_tabs), P(), spec_sh),
                 out_specs=spec_sh)
        def preA_gs_sh(t, th, x):
            te = jax.tree.map(lambda a: a[0], t["ex"])
            freeF = t["freeF"][0]
            xF, xi = _split_loc(x[0])
            rF = _extT_rows(t, te, xF, xi)
            xF_loc = _halo_gather(te, rF, axis)

            def color_update(ct, meta, y, y_loc):
                """One color: fresh residual at this color's faces from
                ROW PANELS of S, batched block solves, owner fold."""
                dy_op = jnp.zeros((npad_f + n_prod_pad, nfb), rF.dtype)
                for pt, (fsz, nb_max) in zip(ct, meta):
                    inv, floc = pt["inv"][0], pt["floc"][0]
                    mask, P2, ef2 = (pt["mask"][0], pt["P2"][0],
                                     pt["ef2"][0])
                    xc = xF_loc[floc]  # (nb_max, fsz, nfb)
                    if y_loc is None:  # zero iterate: residual IS x
                        rc = xc
                    else:
                        ye2 = y_loc[ef2].reshape(nb_max, fsz, 2 * n_skel)
                        rc = xc - jnp.einsum("bfij,bfj->bfi", P2, ye2)
                    yb = jnp.einsum(
                        "bij,bj->bi", inv, rc.reshape(nb_max, fsz * nfb)
                    ) * mask[:, None]
                    tgt = te["loc2op"][floc.reshape(-1)]
                    dy_op = dy_op.at[tgt].add(
                        yb.reshape(-1, nfb), mode="drop")
                return y + _rev_fold(te, dy_op, npad_f, axis)

            y = jnp.zeros((npad_f, nfb), rF.dtype)
            y_loc = None
            for ct, meta in zip(t["colors"], color_meta):  # forward
                y = color_update(ct, meta, y, y_loc)
                y_loc = _halo_gather(te, y, axis)
            # damped coarse correction on the fresh residual
            ue = y_loc[te["efaces_loc"]].reshape(ne_max, n_skel)
            Sy_op = _sibling_assemble(
                te, jnp.einsum("eij,ej->ei", t["S"][0], ue), nfb)
            Sy = jnp.where(freeF, _rev_fold(te, Sy_op, npad_f, axis), 0.0)
            y = y + th * jnp.where(freeF, _coarse_rows(t, rF - Sy), 0.0)
            for ct, meta in zip(reversed(t["colors"]),
                                reversed(color_meta)):  # backward
                y_loc = _halo_gather(te, y, axis)
                y = color_update(ct, meta, y, y_loc)

            yi = _ext_inner(t, te, y, xi)
            return _join_loc(y, yi)[None]

        def preA(x):
            xf = jnp.where(free_flat, x, 0.0)
            y = preA_gs_sh(gs_tabs, theta_j,
                           xf.reshape(n_shards, nloc)).reshape(-1)
            return jnp.where(free_flat, y, x)

    nu32 = jnp.asarray(m.nu, jnp.float32)

    def preM(p):
        return nu32.astype(p.dtype) * p / dM.astype(p.dtype)

    ops32 = dict(A=masked_A(_A32), B=masked_B(_B32), BT=masked_BT(_BT32),
                 preA=preA, preM=preM)
    ops64 = dict(A=masked_A(_A64), B=masked_B(_B64), BT=masked_BT(_BT64))
    aux = dict(free_flat=free_flat, mQ=mQ)
    return ops32, ops64, D_sh, plan, aux


def _face_transfer_tables(V, lay):
    """Host tables of the face-level P1 transfer (the M_F of
    models/auxspace3d.hybrid_h1_face_transfer) + the face vertex ids."""
    from ..fem.quadrature import triangle_rule
    from ..fem.reference import triangle_modal

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
        [1 - rule2.points.sum(1, keepdims=True), rule2.points], axis=1)
    cjv = np.einsum("q,qj,qv->jv", rule2.weights, phi_v, lam2)
    cjv_fac = np.einsum("q,qj,qv->jv", rule2.weights, phi_f, lam2)

    pts = mesh.points
    faces = np.asarray(mesh.faces)
    fv = pts[faces]
    E1 = fv[:, 1] - fv[:, 0]
    E2 = fv[:, 2] - fv[:, 0]
    nsc = np.cross(E1, E2)
    E = np.stack([E1, E2], axis=1)
    G = np.einsum("fdc,fec->fde", E, E)
    W = np.einsum("fde,fec->fdc", np.linalg.inv(G), E)

    M_F = np.zeros((nface, nfb, 9))
    M_F[:, :nfd_v] = np.einsum(
        "jv,fc->fjvc", cjv[:nfd_v], nsc).reshape(nface, nfd_v, 9)
    M_F[:, nfd_v: nfd_v + 2 * nss] = np.einsum(
        "jv,fdc->fjdvc", cjv_fac[:nss], W).reshape(nface, 2 * nss, 9)
    return M_F, faces


def sharded_fast_flagship_solve(ns, mesh: Mesh, tol: float = 1e-8,
                                inner_tol: float = 1e-5,
                                inner_maxsteps: int = 800,
                                max_refine: int = 8,
                                axis: str = "shard",
                                gs: bool = True,
                                two_phase: bool = True,
                                abs_test: bool = False):
    """SolveInitial of the flagship MCS model with the PRODUCTION fast
    path sharded: split-f32 equilibrated
    operators, scatter-free face-block applies, skeleton smoother +
    aux-space coarse, f32 MINRES refinement passes — the same
    mixed_precision refinement drivers as the single-device solve, on
    flat sharded vectors.

    ``two_phase=True`` (default) chains the bench's phase-2 endgame after
    the f32 passes stall: true-f64 MINRES refinement on the equilibrated
    correction system with f32 preconditioner casts
    (mixed_precision_minres_refinement_2phase), so the sharded path
    certifies the full production tolerance 1e-8 rather than the ~4e-7
    f32 floor.

    Returns ((x_u, x_p) global, rel_residual, passes, total_inner, plan);
    ``passes`` is (p1, p2) when two_phase else a single int.
    """
    from ..solvers.refinement import (
        mixed_precision_minres_refinement,
        mixed_precision_minres_refinement_2phase,
    )
    from ..utils.jaxtools import hoisted_jit

    ops32, ops64, D_sh, plan, aux = build_sharded_fast_ops(ns, mesh,
                                                           axis=axis, gs=gs)
    f_mod = np.asarray(jnp.where(ns.free, ns.f - ns.A_raw(ns.u_bc), 0.0))
    g_mod = np.asarray(-ns.B_raw(ns.u_bc))
    shard_spec = NamedSharding(mesh, P(axis))
    n_shards = mesh.shape[axis]
    f_sh = jax.device_put(
        jnp.asarray(plan.vel_to_sharded(f_mod)).reshape(n_shards, -1),
        shard_spec).reshape(-1)
    g_sh = jax.device_put(
        jnp.asarray(plan.p_to_sharded(g_mod, aux["mQ"])).reshape(
            n_shards, -1), shard_spec).reshape(-1)

    # hoisted_jit: the sharded operator tables stay runtime arguments (as
    # closure constants they made a multi-GB executable); the output
    # shardings are given, not read back from the executable
    out_sh = ((shard_spec, shard_spec),) + (NamedSharding(mesh, P()),) * 3
    if two_phase:
        x, r, steps, inner = hoisted_jit(
            lambda f, g: mixed_precision_minres_refinement_2phase(
                ops64, ops32, D_sh, f, g, tol=tol, inner_tol=inner_tol,
                inner_maxsteps=inner_maxsteps, max_refine=max_refine,
                abs_test=abs_test,
            ), f_sh, g_sh, out_shardings=out_sh,
        )(f_sh, g_sh)
        steps = (int(steps[0]), int(steps[1]))
    else:
        x, r, steps, inner = hoisted_jit(
            lambda f, g: mixed_precision_minres_refinement(
                ops64, ops32, D_sh, f, g, tol=tol, inner_tol=inner_tol,
                inner_maxsteps=inner_maxsteps, max_refine=max_refine,
                abs_test=abs_test,
            ), f_sh, g_sh, out_shardings=out_sh,
        )(f_sh, g_sh)
        steps = int(steps)
    x_u = plan.vel_to_global(np.asarray(x[0]))
    x_p = plan.p_to_global(np.asarray(x[1]), aux["mQ"])
    return (x_u, x_p), float(r), steps, int(inner), plan
