"""Two-level additive Schwarz preconditioner for H1-type operators.

The batched stand-in for the reference's preconditioner stack (SURVEY.md
section 2b 'Preconditioners'): NGSolve's BDDC / h1amg are C++ sequential
algorithms; the reference itself builds an *auxiliary-space* preconditioner
from a facet-block smoother plus a per-component order-1 H1 coarse correction
(MypreA, /root/reference/templates/NavierStokesSIMPLE_iterative.py:310-391).
This module implements that structure for batched execution:

* fine level: vertex-patch block-Jacobi (batched dense block inverses,
  applied as gather -> batched matvec -> scatter), or plain
  Jacobi;
* coarse level: the embedded P1 space on the same mesh (for nested Lagrange
  spaces the Galerkin coarse operator IS the P1 stiffness matrix), solved
  by a precomputed dense inverse on small coarse spaces and by a
  smoothed-aggregation AMG V-cycle (precond/amg.py) at scale.

Additive combination keeps the preconditioner SPD, which Bramble-Pasciak CG
requires; the Lanczos scaling (bpcg.bp_scale_factor) absorbs the additive-
Schwarz spectral bounds.  The reference's GS=True multiplicative variant
(:375-381) is available as multi-color block Gauss-Seidel
(precond/multicolor.py), wired through the model preconditioner builders.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.spaces import H1, FunctionSpace
from ..ops import assembly as asm
from .jacobi import block_jacobi, extract_blocks_from_local


def p1_embedding(space: FunctionSpace, dtype=jnp.float64):
    """(P, PT): embed P1 vertex functions into ``space`` and its transpose.

    P maps coarse (nv,) -> fine (ndof,) by interpolation (exact for nested
    Lagrange spaces); PT is the exact transpose.  Jit-safe closures over
    static index tables.
    """
    mesh = space.mesh
    basis = space.basis
    nodes = basis.nodes  # (nb, dim) reference interpolation points
    if nodes is None:
        raise ValueError("p1_embedding requires an interpolatory basis")
    # barycentric hat values at the reference nodes
    lam = np.concatenate(
        [1.0 - nodes.sum(axis=1, keepdims=True), nodes], axis=1
    )  # (nb, dim+1)
    if not basis.nodal:
        vn, _ = basis.tabulate(nodes)
        lam = np.linalg.inv(vn) @ lam  # coefficients, not values
    eldofs = jnp.asarray(space.element_dofs)
    elverts = jnp.asarray(mesh.elements, jnp.int32)
    ndof, nv = space.ndof, mesh.nv
    # multiplicity weights so the overlapping scatter averages to the value
    mult = np.zeros(ndof)
    np.add.at(mult, space.element_dofs.ravel(), 1.0)
    winv = jnp.asarray(1.0 / np.maximum(mult, 1.0), dtype)
    lam_j = jnp.asarray(lam, dtype)

    def P(c):
        ce = c[elverts]  # (ne, dim+1)
        fe = jnp.einsum("nv,ev->en", lam_j, ce)  # (ne, nb)
        return winv * asm.scatter_add(fe, eldofs, ndof)

    def PT(x):
        xe = (winv * x)[eldofs]  # (ne, nb)
        ce = jnp.einsum("nv,en->ev", lam_j, xe)
        return asm.scatter_add(ce, elverts, nv)

    return P, PT


def coarse_p1_solver(
    space: FunctionSpace, coefficient: float = 1.0, dtype=jnp.float64,
    dense_limit: int = 5000,
):
    """Coarse solver on the P1 space (same mesh, same Dirichlet).

    Returns a jit-safe apply r_coarse -> ~Kc^{-1} r_coarse (zero on
    constrained coarse dofs).  Small coarse spaces (<= ``dense_limit`` free
    dofs) use a precomputed dense inverse — one matmul; larger ones use
    a smoothed-aggregation AMG V-cycle (precond/amg.py, the h1amg stand-in:
    O(nv) memory, h-independent quality) exactly as the reference's
    auxiliary-space preconditioner applies one 'h1amg' cycle
    (NavierStokesSIMPLE_iterative.py:122,310-357).
    """
    mesh = space.mesh
    coarse = H1(mesh, 1, dirichlet=space.dirichlet_names)
    # HOST assembly of the tiny P1 stiffness (nb = dim+1): building it on
    # device (stiffness_local) would need a device->host copy back for
    # the host-side coarse setup.  Same einsum, pure numpy, affine
    # jacobians (the coarse space is always straight).
    from ..fem.quadrature import simplex_rule

    rule = simplex_rule(mesh.dim, 2)
    _, grads = coarse.basis.tabulate(rule.points)
    J, detJ, Jinv = mesh.element_jacobians
    g = np.einsum("eba,qib->eqia", Jinv, grads)
    K_loc = np.einsum("q,eqia,eqja,e->eij", rule.weights, g, g, detJ,
                      optimize=True)
    Kc = asm.assemble_csr(K_loc, coarse.element_dofs, coarse.ndof) \
        * coefficient
    free_mask = coarse.free_mask
    free = np.where(free_mask)[0]
    nv = coarse.ndof

    if len(free) > dense_limit:
        from .amg import build_sa_amg

        return build_sa_amg(Kc, free_mask, dtype)

    Kff = np.asarray(Kc[free][:, free].todense())
    inv = jnp.asarray(np.linalg.inv(Kff), dtype)
    free_j = jnp.asarray(free)

    def solve(r):
        # no precision pin of its own: a preconditioner apply runs at the
        # package default (HIGHEST, navier_stokes_tpu/__init__.py).
        # ``r`` may be (nv,) or (nv, k) — vector-component solves batch
        # into one matmul.
        rf = r[free_j]
        xf = inv @ rf
        return jnp.zeros((nv,) + r.shape[1:], r.dtype).at[free_j].set(xf)

    return solve


def vertex_patch_blocks(space: FunctionSpace) -> list[np.ndarray]:
    """Free-dof blocks: per mesh vertex, its dof + the dofs of incident
    edges (and faces in 3D).  The analogue of the reference's facet blocks
    (NavierStokesSIMPLE_iterative.py:360-362), filtered by FreeDofs."""
    mesh, b = space.mesh, space.basis
    free = space.free_mask
    blocks: list[list[int]] = [[] for _ in range(mesh.nv)]
    if b.n_vertex:
        for v in range(mesh.nv):
            blocks[v].append(v)
    off = mesh.nv * b.n_vertex
    if b.n_edge:
        for eid, (a, bb) in enumerate(mesh.edges.tolist()):
            dofs = list(range(off + eid * b.n_edge, off + (eid + 1) * b.n_edge))
            blocks[a].extend(dofs)
            blocks[bb].extend(dofs)
    if mesh.dim == 3 and b.n_face:
        off_f = off + mesh.nedge * b.n_edge
        for fid, verts in enumerate(mesh.faces.tolist()):
            dofs = list(range(off_f + fid * b.n_face, off_f + (fid + 1) * b.n_face))
            for v in verts:
                blocks[v].extend(dofs)
    if b.n_cell:
        # interior dofs: one block per element (so every free dof is covered
        # and the additive preconditioner stays definite)
        off_c = (
            mesh.nv * b.n_vertex
            + mesh.nedge * b.n_edge
            + (len(mesh.faces) * b.n_face if mesh.dim == 3 else 0)
        )
        for e in range(mesh.ne):
            blocks.append(
                list(range(off_c + e * b.n_cell, off_c + (e + 1) * b.n_cell))
            )
    out = []
    for blk in blocks:
        blk = [d for d in blk if free[d]]
        if blk:
            out.append(np.asarray(blk, dtype=np.int32))
    return out


def two_level_preconditioner(
    space: FunctionSpace,
    a_local,
    coefficient: float = 1.0,
    smoother: str = "patch",
    dtype=jnp.float64,
):
    """Additive two-level preconditioner for the masked operator built from
    ``a_local`` on ``space``: smoother + P Kc^{-1} P^T.

    ``coefficient`` scales the coarse P1 stiffness (e.g. the viscosity, as
    in the reference's per-component aH1_i = nu grad.grad forms, :314-318).
    """
    free = jnp.asarray(space.free_mask)
    P, PT = p1_embedding(space, dtype)
    coarse = coarse_p1_solver(space, coefficient, dtype)

    if smoother == "patch":
        blocks = vertex_patch_blocks(space)
        dofs, mats = extract_blocks_from_local(
            np.asarray(a_local), space.element_dofs, blocks, space.ndof
        )
        smooth = block_jacobi(dofs, jnp.asarray(mats, dtype), space.ndof)
    elif smoother == "jacobi":
        diag = asm.diagonal_of_local(
            jnp.asarray(a_local, dtype),
            jnp.asarray(space.element_dofs),
            space.ndof,
        )
        diag = jnp.where(free, diag, 1.0)
        smooth = lambda x, d=1.0 / diag: d * x
    else:
        raise ValueError(smoother)

    def pre(x):
        xf = jnp.where(free, x, 0.0)
        y = smooth(xf) + P(coarse(PT(xf)))
        return jnp.where(free, y, x)

    return pre
