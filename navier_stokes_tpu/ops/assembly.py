"""Batched FEM assembly and matrix-free operator applies (pure JAX).

Batched replacement for NGSolve's C++ symbolic-form assembly (SURVEY.md
section 2b row 3, consumed at e.g. /root/reference/run.py:77-97 and
/root/reference/heat.py:43-61).  Element-local matrices are computed as one
batched einsum over all elements — dense (nq x nb) basis tables contracted in
one batched product — and operators are applied matrix-free as gather -> batched local
matvec -> scatter-add, which keeps every Krylov iteration a fixed-shape jitted
program with zero host round-trips.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.quadrature import simplex_rule
from ..fem.spaces import FunctionSpace


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["qw", "val", "grad", "detj", "jinv", "eldofs", "qpts"],
    meta_fields=["ndof"],
)
@dataclass(frozen=True)
class SpaceTables:
    """Device-resident static tables for one (space, quadrature) pair."""

    qw: jax.Array  # (nq,) quadrature weights
    val: jax.Array  # (nq, nb) basis values at quad points
    grad: jax.Array  # (nq, nb, d) reference gradients
    detj: jax.Array  # (ne,)
    jinv: jax.Array  # (ne, d, d)
    eldofs: jax.Array  # (ne, nb) int32
    qpts: jax.Array  # (ne, nq, d) physical quadrature points
    ndof: int  # static


def make_tables(
    space: FunctionSpace,
    quad_degree: int | None = None,
    dtype=jnp.float64,
    geometry=None,
) -> SpaceTables:
    """Tabulate basis + geometry for ``space`` at a shared quadrature rule.

    ``geometry``: optional mesh.curved.CurvedGeometry — switches to
    isoparametric per-quadrature-point Jacobians (detj (ne, nq), jinv
    (ne, nq, d, d)); all assembly kernels handle both ranks."""
    mesh = space.mesh
    if quad_degree is None:
        quad_degree = 2 * max(space.order, 1)
        if geometry is not None:
            quad_degree += 2 * (geometry.order - 1)
    rule = simplex_rule(mesh.dim, quad_degree)
    vals, grads = space.basis.tabulate(rule.points)
    if geometry is not None:
        from ..mesh.curved import geometry_tables

        _, detJ, Jinv, qpts = geometry_tables(geometry, rule.points)
    else:
        J, detJ, Jinv = mesh.element_jacobians
        v0 = mesh.points[mesh.elements[:, 0]]
        qpts = v0[:, None, :] + np.einsum("eab,qb->eqa", J, rule.points)
    return SpaceTables(
        qw=jnp.asarray(rule.weights, dtype),
        val=jnp.asarray(vals, dtype),
        grad=jnp.asarray(grads, dtype),
        detj=jnp.asarray(detJ, dtype),
        jinv=jnp.asarray(Jinv, dtype),
        eldofs=jnp.asarray(space.element_dofs, jnp.int32),
        qpts=jnp.asarray(qpts, dtype),
        ndof=space.ndof,
    )


# ---------------------------------------------------------------------------
# Element-matrix assembly (batched einsum)
# ---------------------------------------------------------------------------


@jax.jit
def mass_local(t: SpaceTables) -> jax.Array:
    """(ne, nb, nb): integral phi_i phi_j per element."""
    if t.detj.ndim == 1:  # affine
        m_ref = jnp.einsum("q,qi,qj->ij", t.qw, t.val, t.val)
        return t.detj[:, None, None] * m_ref[None]
    return jnp.einsum("q,qi,qj,eq->eij", t.qw, t.val, t.val, t.detj)


@jax.jit
def stiffness_local(t: SpaceTables) -> jax.Array:
    """(ne, nb, nb): integral grad(phi_i) . grad(phi_j) per element."""
    g = phys_grad(t)
    if t.detj.ndim == 1:
        return jnp.einsum("q,eqia,eqja,e->eij", t.qw, g, g, t.detj)
    return jnp.einsum("q,eqia,eqja,eq->eij", t.qw, g, g, t.detj)


@jax.jit
def phys_grad(t: SpaceTables) -> jax.Array:
    """(ne, nq, nb, d): physical basis gradients at quadrature points.

    (grad_x phi)_a = Jinv[b,a] d_b phi; handles affine (ne,d,d) and
    isoparametric (ne,nq,d,d) Jacobians."""
    if t.jinv.ndim == 3:
        return jnp.einsum("eba,qib->eqia", t.jinv, t.grad)
    return jnp.einsum("eqba,qib->eqia", t.jinv, t.grad)


@jax.jit
def divergence_local(tp: SpaceTables, tu: SpaceTables) -> jax.Array:
    """(ne, nbp, nbu, d): integral psi_i d_c(phi_j) per element.

    Contracting with velocity component c gives the div coupling
    b = integral div(u) q of /root/reference/run.py:80-81.  Requires tp and tu
    built on the same mesh with the same quadrature rule.
    """
    gu = phys_grad(tu)
    if tp.detj.ndim == 1:
        return jnp.einsum("q,qi,eqjc,e->eijc", tp.qw, tp.val, gu, tp.detj)
    return jnp.einsum("q,qi,eqjc,eq->eijc", tp.qw, tp.val, gu, tp.detj)


def linear_form_local(t: SpaceTables, f_qvals: jax.Array) -> jax.Array:
    """(ne, nb): integral f phi_i with f given at physical quad points (ne, nq)."""
    if t.detj.ndim == 1:
        return jnp.einsum("q,eq,qi,e->ei", t.qw, f_qvals, t.val, t.detj)
    return jnp.einsum("q,eq,qi,eq->ei", t.qw, f_qvals, t.val, t.detj)


# ---------------------------------------------------------------------------
# Matrix-free applies and scatters
# ---------------------------------------------------------------------------


def gather(u: jax.Array, eldofs: jax.Array) -> jax.Array:
    return u[eldofs]


def scatter_add(local: jax.Array, eldofs: jax.Array, ndof: int) -> jax.Array:
    """(ne, nb) local contributions -> (ndof,) global vector."""
    return jnp.zeros(ndof, local.dtype).at[eldofs].add(local)


def apply_local_matrices(
    a_local: jax.Array, eldofs: jax.Array, ndof: int, u: jax.Array,
) -> jax.Array:
    """y = A u with A given by per-element dense blocks (gather-einsum-scatter)."""
    ue = u[eldofs]
    ye = jnp.einsum("eij,ej->ei", a_local, ue)
    return jnp.zeros(ndof, ye.dtype).at[eldofs].add(ye)


def diagonal_of_local(a_local: jax.Array, eldofs: jax.Array, ndof: int) -> jax.Array:
    d = jnp.einsum("eii->ei", a_local)
    return jnp.zeros(ndof, d.dtype).at[eldofs].add(d)


# ---------------------------------------------------------------------------
# Host-side global sparse assembly (validation / direct solves in tests)
# ---------------------------------------------------------------------------


def assemble_csr(a_local, eldofs, ndof: int, ndof_col: int | None = None):
    """scipy CSR from element matrices; host-side, tests and setup only."""
    import scipy.sparse as sp

    a = np.asarray(a_local)
    ed = np.asarray(eldofs)
    ne, nr, nc = a.shape
    rows = np.repeat(ed[:, :, None], nc, axis=2).ravel()
    cols = np.repeat(ed[:, None, :], nr, axis=1).ravel()
    mat = sp.coo_matrix(
        (a.ravel(), (rows, cols)), shape=(ndof, ndof_col or ndof)
    )
    return mat.tocsr()


def assemble_csr_rect(a_local, row_dofs, col_dofs, nrow: int, ncol: int):
    import scipy.sparse as sp

    a = np.asarray(a_local)
    rd, cd = np.asarray(row_dofs), np.asarray(col_dofs)
    ne, nr, nc = a.shape
    rows = np.repeat(rd[:, :, None], nc, axis=2).ravel()
    cols = np.repeat(cd[:, None, :], nr, axis=1).ravel()
    return sp.coo_matrix((a.ravel(), (rows, cols)), shape=(nrow, ncol)).tocsr()
