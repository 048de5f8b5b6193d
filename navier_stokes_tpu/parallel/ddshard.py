"""Dof-sharded domain-decomposition operators (halo exchange, not replication).

Round-1 spatial parallelism replicated the full dof vector on every device
and psum'd whole vectors per apply (O(ndof) collective volume, single-device
memory cap).  This module is the real design: dof vectors are PARTITIONED
across the mesh axis (padded per-shard blocks), and a matrix-free apply
moves only INTERFACE data:

  1. each shard packs the owned dofs that other shards' elements touch
     (its interface) into a fixed-size buffer,
  2. one ``all_gather`` of the packed buffers (collective volume = total
     interface size, the surface O(ndof^(2/3) n^(1/3)) — not the volume),
  3. local gather -> batched einsum -> local scatter over [own | halo],
  4. contributions this shard computed for dofs owned elsewhere travel
     back by a second packed ``all_gather`` and are added by their owners.

Elements are partitioned in contiguous index blocks (the mesh generators
emit roughly-spatially-ordered elements, so block partitions are thin
slabs).  Everything runs under ``jax.shard_map`` with per-shard index
tables laid out as (n_shards, ...) arrays sharded over the leading axis,
so each device reads exactly its own row.  Krylov vector algebra
(axpy/dot) on the partitioned vectors is plain jnp under GSPMD: dots
lower to per-shard partial sums + a scalar all-reduce.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@dataclass(frozen=True)
class DofPartition:
    """Partition of a dof space into n_shards padded blocks.

    ``owner``: (ndof,) shard id per dof; ``slot``: (ndof,) position within
    the owner's block; ``npad``: slots per shard (max count, padded).
    The sharded vector layout is x_sh[s * npad + slot] = x_global[dof].
    """

    n_shards: int
    ndof: int
    npad: int
    owner: np.ndarray
    slot: np.ndarray

    @property
    def ntotal(self) -> int:
        return self.n_shards * self.npad

    def to_sharded(self, x: np.ndarray) -> np.ndarray:
        out = np.zeros(self.ntotal, dtype=x.dtype)
        out[self.owner * self.npad + self.slot] = x
        return out

    def to_global(self, xs: np.ndarray) -> np.ndarray:
        return np.asarray(xs)[self.owner * self.npad + self.slot]


def partition_dofs(eldofs: np.ndarray, ndof: int, n_shards: int,
                   elem_shard: np.ndarray) -> DofPartition:
    """First-touch dof partition: a dof is owned by the lowest shard whose
    elements reference it; dofs referenced by no element go to shard 0."""
    owner = np.full(ndof, n_shards, dtype=np.int64)
    for s in range(n_shards - 1, -1, -1):
        sel = np.where(elem_shard == s)[0]
        owner[np.unique(eldofs[sel])] = s
    owner[owner == n_shards] = 0
    slot = np.zeros(ndof, dtype=np.int64)
    counts = np.zeros(n_shards, dtype=np.int64)
    for s in range(n_shards):
        idx = np.where(owner == s)[0]
        slot[idx] = np.arange(len(idx))
        counts[s] = len(idx)
    npad = int(counts.max())
    return DofPartition(n_shards, ndof, npad, owner, slot)


def block_element_partition(ne: int, n_shards: int) -> np.ndarray:
    """Contiguous element blocks (generators emit spatially-ordered
    elements, so blocks are slabs)."""
    return np.minimum((np.arange(ne) * n_shards) // max(ne, 1),
                      n_shards - 1)


def _pad_rows(rows: list[np.ndarray], fill: int) -> np.ndarray:
    m = max((len(r) for r in rows), default=0)
    m = max(m, 1)
    out = np.full((len(rows), m), fill, dtype=np.int64)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def build_dd_operator(
    mats: np.ndarray,
    eldofs_out: np.ndarray,
    eldofs_in: np.ndarray,
    part_out: DofPartition,
    part_in: DofPartition,
    elem_shard: np.ndarray,
    mesh: Mesh,
    dtype=jnp.float64,
    axis: str = "shard",
):
    """Sharded matrix-free apply y = sum_e P_out^T mats[e] P_in x.

    ``mats``: (ne, nout, nin) local matrices; rectangular operators (the
    divergence coupling B / B^T) just use different in/out tables and
    partitions.  Returns a callable on partitioned padded vectors
    (NamedSharding P(axis) over the leading dof axis).
    """
    n_shards = mesh.shape[axis]
    ne, nout, nin = mats.shape
    npad_in, npad_out = part_in.npad, part_out.npad

    # --- per-shard local structures (host setup) -------------------------
    g_in = part_in.owner * npad_in + part_in.slot  # global -> packed id
    g_out = part_out.owner * npad_out + part_out.slot

    shard_mats, shard_eldofs_in, shard_eldofs_out = [], [], []
    halo_in_rows, pack_in_rows = [], []
    rev_src_rows, rev_dst_rows = [], []

    # forward packing: for each shard, the owned IN-dofs other shards touch
    need = [set() for _ in range(n_shards)]  # need[s] = global in-dofs of s's elements
    for s in range(n_shards):
        sel = np.where(elem_shard == s)[0]
        need[s] = set(np.unique(eldofs_in[sel]).tolist())
    pack_in: list[list[int]] = [[] for _ in range(n_shards)]
    pack_pos: list[dict] = [dict() for _ in range(n_shards)]
    for s in range(n_shards):
        for d in sorted(need[s]):
            o = int(part_in.owner[d])
            if o != s and d not in pack_pos[o]:
                pack_pos[o][d] = len(pack_in[o])
                pack_in[o].append(d)
    # ensure every needed foreign dof has a pack position (order of shards
    # above already guarantees it)
    Bmax = max(max((len(p) for p in pack_in), default=1), 1)

    # reverse packing (OUT side): contributions for foreign out-dofs
    prod = [set() for _ in range(n_shards)]
    for s in range(n_shards):
        sel = np.where(elem_shard == s)[0]
        prod[s] = set(np.unique(eldofs_out[sel]).tolist())
    out_halo: list[list[int]] = []  # per shard, foreign out-dofs it produces
    for s in range(n_shards):
        out_halo.append(
            sorted(d for d in prod[s] if int(part_out.owner[d]) != s)
        )
    Hmax = max(max((len(h) for h in out_halo), default=1), 1)

    for s in range(n_shards):
        sel = np.where(elem_shard == s)[0]
        m = np.zeros((0, nout, nin)) if not len(sel) else mats[sel]
        shard_mats.append(m)
        # IN index: owned -> slot, foreign -> npad_in + halo position
        halo_list = sorted(
            d for d in need[s] if int(part_in.owner[d]) != s
        )
        halo_pos = {d: i for i, d in enumerate(halo_list)}
        ed_in = eldofs_in[sel].astype(np.int64)
        loc_in = np.zeros_like(ed_in)
        own_mask = part_in.owner[ed_in] == s
        loc_in[own_mask] = part_in.slot[ed_in[own_mask]]
        if (~own_mask).any():
            loc_in[~own_mask] = npad_in + np.asarray(
                [halo_pos[int(d)] for d in ed_in[~own_mask]]
            )
        shard_eldofs_in.append(loc_in)
        # halo fetch positions in the all-gathered (n_shards * Bmax) buffer
        halo_in_rows.append(
            np.asarray(
                [int(part_in.owner[d]) * Bmax + pack_pos[int(part_in.owner[d])][d]
                 for d in halo_list],
                dtype=np.int64,
            )
        )
        pack_in_rows.append(
            np.asarray([part_in.slot[d] for d in pack_in[s]], dtype=np.int64)
        )
        # OUT index: owned -> slot, foreign -> npad_out + out-halo position
        oh = out_halo[s]
        oh_pos = {d: i for i, d in enumerate(oh)}
        ed_out = eldofs_out[sel].astype(np.int64)
        loc_out = np.zeros_like(ed_out)
        o_mask = part_out.owner[ed_out] == s
        loc_out[o_mask] = part_out.slot[ed_out[o_mask]]
        if (~o_mask).any():
            loc_out[~o_mask] = npad_out + np.asarray(
                [oh_pos[int(d)] for d in ed_out[~o_mask]]
            )
        shard_eldofs_out.append(loc_out)

    # reverse-add tables: for shard t, where in the gathered (n_shards*Hmax)
    # reverse buffer do entries destined to t live, and at which own slot
    for t in range(n_shards):
        src, dst = [], []
        for s in range(n_shards):
            for i, d in enumerate(out_halo[s]):
                if int(part_out.owner[d]) == t:
                    src.append(s * Hmax + i)
                    dst.append(int(part_out.slot[d]))
        rev_src_rows.append(np.asarray(src, dtype=np.int64))
        rev_dst_rows.append(np.asarray(dst, dtype=np.int64))

    # --- pad per-shard tables to common shapes ---------------------------
    ne_max = max(max((m.shape[0] for m in shard_mats), default=1), 1)

    def pad_elems(arrs, fill=0.0, idx=False):
        out = []
        for a in arrs:
            pad = ne_max - a.shape[0]
            if idx:
                # padded elements read slot 0 / write... route to a dump slot
                pz = np.zeros((pad,) + a.shape[1:], dtype=a.dtype)
            else:
                pz = np.zeros((pad,) + a.shape[1:], dtype=a.dtype)
            out.append(np.concatenate([a, pz], axis=0))
        return np.stack(out)

    mats_t = pad_elems(shard_mats)  # (n_shards, ne_max, nout, nin)
    edin_t = pad_elems(shard_eldofs_in, idx=True)
    edout_t = pad_elems(shard_eldofs_out, idx=True)
    # padded elements have zero mats, so their scatter target (slot 0) is
    # harmless
    halo_t = _pad_rows(halo_in_rows, fill=0)
    halo_mask = _pad_rows(
        [np.ones(len(r), dtype=np.int64) for r in halo_in_rows], fill=0
    )
    pack_t = _pad_rows(pack_in_rows, fill=0)
    pack_mask = _pad_rows(
        [np.ones(len(r), dtype=np.int64) for r in pack_in_rows], fill=0
    )
    rev_src_t = _pad_rows(rev_src_rows, fill=0)
    rev_dst_t = _pad_rows(rev_dst_rows, fill=0)
    rev_mask = _pad_rows(
        [np.ones(len(r), dtype=np.int64) for r in rev_src_rows], fill=0
    )
    n_halo_max = halo_t.shape[1]
    n_outhalo_max = Hmax

    shard_spec = NamedSharding(mesh, P(axis))

    def put(x, dt=None):
        return jax.device_put(
            jnp.asarray(x, dt) if dt else jnp.asarray(x), shard_spec
        )

    mats_j = put(mats_t, dtype)
    edin_j = put(edin_t)
    edout_j = put(edout_t)
    halo_j, halo_m = put(halo_t), put(halo_mask)
    pack_j, pack_m = put(pack_t), put(pack_mask)
    rev_src_j, rev_dst_j, rev_m = put(rev_src_t), put(rev_dst_t), put(rev_mask)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis),) * 9 + (P(axis),),
        out_specs=P(axis),
    )
    def apply_shard(m, edi, edo, halo, hmask, pack, pmask, rsrc, rdst_rm, x):
        m, edi, edo = m[0], edi[0], edo[0]
        halo, hmask = halo[0], hmask[0]
        pack, pmask = pack[0], pmask[0]
        rsrc = rsrc[0]
        rdst, rmask = rdst_rm[0][0], rdst_rm[0][1]
        xo = x[0]  # (npad_in,)
        # 1) pack + all_gather interface values
        packed = jnp.where(pmask > 0, xo[pack], 0.0)
        all_pk = jax.lax.all_gather(packed, axis)  # (n_shards, Bmax)
        halo_vals = jnp.where(hmask > 0, all_pk.reshape(-1)[halo], 0.0)
        x_loc = jnp.concatenate([xo, halo_vals])
        # 2) local gather-einsum-scatter
        ue = x_loc[edi]
        ye = jnp.einsum("eij,ej->ei", m, ue)
        y = jnp.zeros(npad_out + n_outhalo_max, ye.dtype).at[edo].add(ye)
        y_own, y_halo = y[:npad_out], y[npad_out:]
        # 3) return foreign contributions to their owners
        all_rv = jax.lax.all_gather(y_halo, axis)  # (n_shards, Hmax)
        add_vals = jnp.where(rmask > 0, all_rv.reshape(-1)[rsrc], 0.0)
        y_own = y_own.at[rdst].add(add_vals)
        return y_own[None]

    # bundle rdst+rmask to stay under shard_map's positional in_specs
    rdst_rm = put(np.stack([rev_dst_t, rev_mask], axis=1))

    def apply(x):
        return apply_shard(
            mats_j, edin_j, edout_j, halo_j, halo_m, pack_j, pack_m,
            rev_src_j, rdst_rm, x.reshape(n_shards, npad_in)
        ).reshape(-1)

    return apply


def sharded_flagship_solve(ns, mesh: Mesh, tol: float = 1e-8,
                           maxsteps: int = 4000, axis: str = "shard"):
    """Full Bramble-Pasciak SolveInitial of the flagship MCS model with
    dof-SHARDED vectors.

    A / B / B^T and the vertex-star block smoother all run through
    ``build_dd_operator`` (interface-packed halo exchange); Krylov dots and
    axpys act on the partitioned padded vectors under GSPMD.  Returns
    (result, part_u, part_p) so callers can map the solution back with
    ``part.to_global``.
    """
    from ..models.stokes_hybrid import hybrid_blocks
    from ..precond.jacobi import extract_blocks_from_local
    from ..solvers.bpcg import bramble_pasciak_cg_opt

    n_shards = mesh.shape[axis]
    eldofs = np.asarray(ns.Xv.element_dofs)
    eldofs_p = np.asarray(ns.Q.element_dofs)
    es = block_element_partition(ns.mesh.ne, n_shards)
    pu = partition_dofs(eldofs, ns.n, n_shards, es)
    pp = partition_dofs(eldofs_p, ns.Q.ndof, n_shards, es)
    dt = ns.dtype

    A_dd = build_dd_operator(
        ns.A_cond_np, eldofs, eldofs, pu, pu, es, mesh, dt, axis
    )
    B_loc = np.asarray(ns._B_loc)
    B_dd = build_dd_operator(B_loc, eldofs_p, eldofs, pp, pu, es, mesh, dt, axis)
    BT_dd = build_dd_operator(
        B_loc.transpose(0, 2, 1), eldofs, eldofs_p, pu, pp, es, mesh, dt, axis
    )

    # block smoother as one more DD gather-solve-scatter: 2D vertex stars /
    # 3D disjoint face+interior blocks (matches the model's
    # preconditioner="vertexstar" / "faceblock" respectively, so iteration
    # counts are comparable to the single-device solve)
    if ns.mesh.dim == 3:
        from ..models.stokes_hybrid3d import hybrid_blocks_3d

        fmask = ns.Xv.free_mask
        blocks = [
            np.asarray([d for d in b if fmask[d]], np.int32)
            for b in hybrid_blocks_3d(ns.Xv, "face")
        ]
        blocks = [b for b in blocks if len(b)]
    else:
        blocks = hybrid_blocks(ns.Xv, "vertexstar")
    dofs_pad, mats = extract_blocks_from_local(
        ns.A_cond_np, eldofs, blocks, ns.n
    )
    inv = np.linalg.inv(np.asarray(mats, np.float64))
    pad = dofs_pad < 0
    inv = inv * (~pad[:, :, None]) * (~pad[:, None, :])
    dofs0 = np.where(pad, 0, dofs_pad)
    blk_shard = pu.owner[dofs0[:, 0]]
    pre_dd = build_dd_operator(
        inv, dofs0, dofs0, pu, pu, blk_shard, mesh, dt, axis
    )

    shard_spec = NamedSharding(mesh, P(axis))
    free_sh = jax.device_put(
        jnp.asarray(pu.to_sharded(np.asarray(ns.free))).reshape(
            n_shards, -1
        ), shard_spec
    ).reshape(-1)
    f_sh = jax.device_put(
        jnp.asarray(pu.to_sharded(np.asarray(
            jnp.where(ns.free, ns.f - ns.A_raw(ns.u_bc), 0.0)
        )), dt).reshape(n_shards, -1), shard_spec
    ).reshape(-1)
    g_sh = jax.device_put(
        jnp.asarray(pp.to_sharded(np.asarray(-ns.B_raw(ns.u_bc))), dt
                    ).reshape(n_shards, -1), shard_spec
    ).reshape(-1)
    diag_Mp_sh = jax.device_put(
        jnp.asarray(pp.to_sharded(np.maximum(np.asarray(ns._diag_Mp), 1e-30)),
                    dt).reshape(n_shards, -1), shard_spec
    ).reshape(-1)
    # padded pressure slots carry diag 1e-30? use 1.0 there instead
    diag_Mp_sh = jnp.where(diag_Mp_sh > 1e-29, diag_Mp_sh, 1.0)
    nu = ns.nu

    def A(x):
        xf = jnp.where(free_sh, x, 0.0)
        return jnp.where(free_sh, A_dd(xf), x)

    def B(x):
        return B_dd(jnp.where(free_sh, x, 0.0))

    def BT(p):
        return jnp.where(free_sh, BT_dd(p), 0.0)

    def preA(x):
        xf = jnp.where(free_sh, x, 0.0)
        return jnp.where(free_sh, pre_dd(xf), x)

    preM = lambda p: nu * p / diag_Mp_sh

    res = bramble_pasciak_cg_opt(
        A, B, BT, preA, preM, f_sh, g_sh, tol=tol, maxsteps=maxsteps,
        rel_err=True,
    )
    return res, pu, pp
