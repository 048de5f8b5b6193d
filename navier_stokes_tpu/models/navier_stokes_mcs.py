"""Navier-Stokes on the MCS discretization — the reference's centerpiece.

Rebuild of /root/reference/templates/NavierStokesSIMPLE_iterative.py with the
actual MCS spaces, dimension-generic like the reference's class (its spaces
switch on mesh.dim at :28-36): V = BDM_k H(div) velocity (:24), uhat =
tangential facet velocity of order k-1 (:26), sigma = H(curl,div) stress
(:27; triangles via fem/hcurldiv, tets via fem/hcurldiv3d), W = L2 (2D) /
VectorL2 (3D) vorticity multiplier (:29-31) paired through Skew2Vec
(:53-58), with the Stokes operator (:66-70)

  stokesA = -(1/(2 nu)) int sigma:tau
          + int (div sigma . v + div tau . u)
          + int (W skw(tau) + R skw(sigma))
          - sum_T int_dT (sigma n.n)(v.n) + (tau n.n)(u.n)
          - sum_T int_dT (sigma n).tang(vhat) + (tau n).tang(uhat)

plus the grad-div term V_trace = 2 nu div(u) div(v) (:72).

Batched static condensation: sigma and W are element-local (the reference
marks them HIDDEN and compresses, :33-36); their block is eliminated per
element as one batched dense solve, leaving an operator on the [HDiv |
facet] structure — the same structure as the HDG system, so the hybrid
preconditioners (vertex-star blocks / aux-space P1 coarse) apply directly.
Because the (sigma,W) rows scale linearly with dt inside mstar, the
condensed mstar is exactly M_u + dt * condensed(stokesA): one condensation
serves both operators.

API parity: SolveInitial(timesteps, iterative, GS) recording
stokes_bpcg_iterations/stokes_bpcg_time (:397-399), AddForce, DoTimeStep
(explicit upwind-DG convection + implicit mstar at precision 1e-4 +
divergence-free projection, :427-438), Project (:440-444),
velocity/pressure properties (:159-166).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from ..fem.hcurldiv import hcurldiv_triangle
from ..fem.hcurldiv3d import hcurldiv_tet
from ..fem.hdiv import HDiv, VectorFacet, legendre_01
from ..fem.hdiv3d import HDiv3D
from ..fem.quadrature import tetrahedron_rule, triangle_rule
from ..fem.reference import triangle_modal
from ..fem.spaces import L2
from ..ops import assembly as asm
from ..ops.convection import build_upwind_convection
from ..ops.convection3d import build_upwind_convection_3d
from ..ops.facets import facet_geometry
from ..ops.facets3d import facet_geometry_3d
from ..solvers.bpcg import bramble_pasciak_cg_opt
from ..solvers.cg import cg
from ..utils.timers import Timer
from .stokes_hybrid import (
    HybridVelocitySpace,
    build_hybrid_preconditioner,
    interpolate_hybrid_boundary,
)
from .stokes_hybrid3d import (
    HybridVelocitySpace3D,
    VectorFacet3D,
    build_faceblock_preconditioner_3d,
    interpolate_hybrid_boundary_3d,
)

__all__ = ["NavierStokesMCS"]


def _assemble_mcs_ns_local(mesh, V, facet_space, sigma_basis, W_space, nu):
    """Element-local 4-field matrices, split into retained [u | uhat] and
    eliminated [sigma | W] blocks.

    Returns (A_ret, A_rc, A_cc, A_cr) with shapes over
    n_ret = nbv + 3*nfd and n_el = nbs + nbw, signs folded on the retained
    and eliminated sides.
    """
    hb, sb = V.basis, sigma_basis
    k = hb.order
    nbv, nbs = hb.n_basis, sb.n_basis
    nfd = facet_space.n_edge
    nfac = 3 * nfd
    qb = W_space.basis
    nbw = qb.n_basis

    J, detJ, Jinv = mesh.element_jacobians
    ne = mesh.ne
    vol = triangle_rule(2 * k + 2)
    w = vol.weights

    v_val, v_grad = hb.tabulate(vol.points)
    s_val, s_grad = sb.tabulate(vol.points)
    w_val, _ = qb.tabulate(vol.points)

    # physical sigma and its divergence (see stokes_mcs.py derivation)
    sp = np.einsum("eai,qnab,ejb->eqnij", Jinv, s_val, J, optimize=True) / detJ[:, None, None, None, None]
    div_s_ref = np.einsum("qnabb->qna", s_grad)
    v_p = np.einsum("ecA,qiA->eqic", J, v_val, optimize=True) / detJ[:, None, None, None]

    n_ret = nbv + nfac
    n_el = nbs + nbw
    A_ret = np.zeros((ne, n_ret, n_ret))
    A_rc = np.zeros((ne, n_ret, n_el))
    A_cc = np.zeros((ne, n_el, n_el))

    # -(1/(2 nu)) sigma:tau
    A_cc[:, :nbs, :nbs] += -(0.5 / nu) * np.einsum(
        "q,eqnij,eqmij,e->enm", w, sp, sp, detJ
    , optimize=True)
    # vorticity multiplier: W skw(tau) + R skw(sigma); skw(m) = m10 - m01
    skw_s = sp[..., 1, 0] - sp[..., 0, 1]  # (ne, nq, nbs)
    wr = np.einsum("q,qn,eqm,e->enm", w, w_val, skw_s, detJ, optimize=True)
    A_cc[:, nbs:, :nbs] += wr
    A_cc[:, :nbs, nbs:] += wr.transpose(0, 2, 1)
    # div(sigma).v + div(tau).u  (ref-frame pairing / detJ)
    dsv = np.einsum("q,qma,qia,e->eim", w, div_s_ref, v_val, 1.0 / detJ, optimize=True)
    A_rc[:, :nbv, :nbs] += dsv
    # facet terms
    fg = facet_geometry(mesh, k + 3)
    for le in range(3):
        pts = fg.ref_points[le]
        tv, _ = hb.tabulate(pts)
        ts, _ = sb.tabulate(pts)
        v_tp = np.einsum("ecA,qiA->eqic", J, tv, optimize=True) / detJ[:, None, None, None]
        s_tp = np.einsum("eai,qnab,ejb->eqnij", Jinv, ts, J, optimize=True) / detJ[:, None, None, None, None]
        nrm = fg.normal[:, le]
        vn = np.einsum("eqic,ec->eqi", v_tp, nrm, optimize=True)
        sn = np.einsum("eqnij,ej->eqni", s_tp, nrm, optimize=True)
        snn = np.einsum("eqni,ei->eqn", sn, nrm, optimize=True)
        ds = fg.elen[:, le]
        # -(sigma n.n)(v.n)
        blk = np.einsum("q,eqm,eqi,e->eim", fg.w, snn, vn, ds, optimize=True)
        A_rc[:, :nbv, :nbs] -= blk
        # -(sigma n).tang(uhat): facet basis = L_j(t_g) tau_g (tangential)
        tgl = fg.t_global[:, le]
        leg = np.stack([legendre_01(tgl, j) for j in range(nfd)], axis=2)
        fvals = leg[..., None] * fg.tau_global[:, le][:, None, None, :]
        sn_t = sn - snn[..., None] * nrm[:, None, None, :]
        blk2 = np.einsum("q,eqmc,eqjc,e->ejm", fg.w, sn_t, fvals, ds, optimize=True)
        A_rc[:, nbv + le * nfd: nbv + (le + 1) * nfd, :nbs] -= blk2

    # grad-div: 2 nu div(u) div(v)
    div_v_ref = np.einsum("qnaa->qn", v_grad)
    A_ret[:, :nbv, :nbv] += 2.0 * nu * np.einsum(
        "q,qn,qm,e->enm", w, div_v_ref, div_v_ref, 1.0 / detJ
    , optimize=True)

    # fold signs: retained = [hdiv signs | +1 facet], eliminated = [sigma
    # parity signs | +1]
    s_ret = np.concatenate(
        [V.element_signs, np.ones((ne, nfac))], axis=1
    )
    # sigma element-local -> no sharing, signs irrelevant (identity)
    A_ret = A_ret * s_ret[:, :, None] * s_ret[:, None, :]
    A_rc = A_rc * s_ret[:, :, None]
    return A_ret, A_rc, A_cc, v_p, vol


def _assemble_mcs_ns_local_curved(mesh, V, facet_space, sigma_basis,
                                  W_space, nu, geometry):
    """Curved-geometry (isoparametric) 2D MCS assembly.

    With a non-affine map the stress pullback sigma = (1/detJ) J^{-T}
    sigmahat J^T acquires curvature terms in its divergence:

      d_B sigma_ij = (1/detJ) [ (d_B Jinv)_ai shat_ab J_jb
                                + Jinv_ai ghat_abB J_jb
                                + Jinv_ai shat_ab H_jbB ]
                     - (d_B detJ / detJ^2) Jinv_ai shat_ab J_jb,
      (div sigma)_i = d_B sigma_ij Jinv_Bj,
      (d_B Jinv)_ai = - Jinv_ac H_cdB Jinv_di,

    while ``div u = divhat/detJ`` (H(div) Piola identity) keeps the
    grad-div and pressure-coupling terms curvature-free.  Facet integrals
    use the exact curved scaled normal detJ J^{-T} nhat.  Returns
    (A_ret, A_rc, A_cc, M_full, B_loc) with signs folded like the affine
    2D path.
    """
    from ..mesh.curved import geometry_hessian, geometry_tables

    hb, sb = V.basis, sigma_basis
    k = hb.order
    nbv, nbs = hb.n_basis, sb.n_basis
    nfd = facet_space.n_edge
    nfac = 3 * nfd
    qb = W_space.basis
    nbw = qb.n_basis
    ne = mesh.ne

    vol = triangle_rule(2 * k + 4)
    w = vol.weights
    J, detJ, Jinv, xq = geometry_tables(geometry, vol.points)
    H = geometry_hessian(geometry, vol.points)
    ddet = (
        H[..., 0, 0, :] * J[..., 1, 1, None]
        + J[..., 0, 0, None] * H[..., 1, 1, :]
        - H[..., 0, 1, :] * J[..., 1, 0, None]
        - J[..., 0, 1, None] * H[..., 1, 0, :]
    )  # (ne, nq, 2B)
    dJinv = -np.einsum(
        "eqac,eqcdB,eqdi->eqaiB", Jinv, H, Jinv, optimize=True
    )

    v_val, v_grad = hb.tabulate(vol.points)
    s_val, s_grad = sb.tabulate(vol.points)
    w_val, _ = qb.tabulate(vol.points)

    n_ret = nbv + nfac
    n_el = nbs + nbw
    A_ret = np.zeros((ne, n_ret, n_ret))
    A_rc = np.zeros((ne, n_ret, n_el))
    A_cc = np.zeros((ne, n_el, n_el))

    # physical stress values
    sp = np.einsum(
        "eqai,qnab,eqjb->eqnij", Jinv, s_val, J, optimize=True
    ) / detJ[..., None, None, None]
    A_cc[:, :nbs, :nbs] += -(0.5 / nu) * np.einsum(
        "q,eqnij,eqmij,eq->enm", w, sp, sp, detJ, optimize=True
    )
    skw_s = sp[..., 1, 0] - sp[..., 0, 1]
    wr = np.einsum("q,qn,eqm,eq->enm", w, w_val, skw_s, detJ, optimize=True)
    A_cc[:, nbs:, :nbs] += wr
    A_cc[:, :nbs, nbs:] += wr.transpose(0, 2, 1)

    # div(sigma) with curvature terms
    T = (
        np.einsum("eqaiB,qnab,eqjb->eqnijB", dJinv, s_val, J, optimize=True)
        + np.einsum("eqai,qnabB,eqjb->eqnijB", Jinv, s_grad, J, optimize=True)
        + np.einsum("eqai,qnab,eqjbB->eqnijB", Jinv, s_val, H, optimize=True)
    ) / detJ[..., None, None, None, None]
    T -= sp[..., None] * (ddet / detJ[..., None])[:, :, None, None, None, :]
    div_s = np.einsum("eqnijB,eqBj->eqni", T, Jinv, optimize=True)
    del T
    # pairing with v_phys * detJ = J vhat
    Jv = np.einsum("eqcA,qnA->eqnc", J, v_val, optimize=True)
    A_rc[:, :nbv, :nbs] += np.einsum(
        "q,eqmi,eqni->enm", w, div_s, Jv, optimize=True
    )

    # facet terms (curved normals)
    fg = facet_geometry(mesh, k + 4)
    ref_n_sc = {
        0: np.array([0.0, -1.0]),
        1: np.array([1.0, 1.0]),
        2: np.array([-1.0, 0.0]),
    }
    for le in range(3):
        pts = fg.ref_points[le]
        Jf, detf, Jinvf, _ = geometry_tables(geometry, pts)
        tv, _ = hb.tabulate(pts)
        ts, _ = sb.tabulate(pts)
        v_tp = np.einsum(
            "eqcA,qiA->eqic", Jf, tv, optimize=True
        ) / detf[..., None, None]
        s_tp = np.einsum(
            "eqai,qnab,eqjb->eqnij", Jinvf, ts, Jf, optimize=True
        ) / detf[..., None, None, None]
        nsc = np.einsum(
            "eq,eqBc,B->eqc", detf, Jinvf, ref_n_sc[le], optimize=True
        )
        dsq = np.linalg.norm(nsc, axis=-1)
        n_unit = nsc / dsq[..., None]
        vn = np.einsum("eqic,eqc->eqi", v_tp, n_unit, optimize=True)
        sn = np.einsum("eqnij,eqj->eqni", s_tp, n_unit, optimize=True)
        snn = np.einsum("eqni,eqi->eqn", sn, n_unit, optimize=True)
        blk = np.einsum("q,eqm,eqi,eq->eim", fg.w, snn, vn, dsq, optimize=True)
        A_rc[:, :nbv, :nbs] -= blk
        tgl = fg.t_global[:, le]
        leg = np.stack([legendre_01(tgl, j) for j in range(nfd)], axis=2)
        fvals = leg[..., None] * fg.tau_global[:, le][:, None, None, :]
        sn_t = sn - snn[..., None] * n_unit[:, :, None, :]
        blk2 = np.einsum(
            "q,eqmc,eqjc,eq->ejm", fg.w, sn_t, fvals, dsq, optimize=True
        )
        A_rc[:, nbv + le * nfd: nbv + (le + 1) * nfd, :nbs] -= blk2

    # grad-div (Piola identity: div u = divhat/detJ)
    div_v_ref = np.einsum("qnaa->qn", v_grad)
    A_ret[:, :nbv, :nbv] += 2.0 * nu * np.einsum(
        "q,qn,qm,eq->enm", w, div_v_ref, div_v_ref, 1.0 / detJ, optimize=True
    )

    # signs
    s_ret = np.concatenate([V.element_signs, np.ones((ne, nfac))], axis=1)
    A_ret = A_ret * s_ret[:, :, None] * s_ret[:, None, :]
    A_rc = A_rc * s_ret[:, :, None]

    # velocity mass on the retained block: u.v dx = vhat^T (J^T J) vhat/detJ
    G = np.einsum("eqca,eqcb->eqab", J, J, optimize=True)
    M_u = np.einsum(
        "q,qia,eqab,qjb,eq->eij", w, v_val, G, v_val, 1.0 / detJ,
        optimize=True,
    )
    M_u *= V.element_signs[:, :, None] * V.element_signs[:, None, :]
    M_full = np.zeros((ne, n_ret, n_ret))
    M_full[:, :nbv, :nbv] = M_u

    # pressure coupling (exact Piola identity, element-independent frame)
    q_val, _ = W_space.basis.tabulate(vol.points)
    B_ref = np.einsum("q,qp,qi->pi", w, q_val, div_v_ref, optimize=True)
    B_loc = np.zeros((ne, q_val.shape[1], n_ret))
    B_loc[:, :, :nbv] = B_ref[None] * V.element_signs[:, None, :]
    return A_ret, A_rc, A_cc, M_full, B_loc


def _assemble_mcs_ns_local_3d(mesh, V, facet_space, sigma_basis, Wq_basis,
                              Q_basis, nu):
    """3D element-local 4-field MCS matrices on tets.

    Counterpart of ``_assemble_mcs_ns_local`` for mesh.dim == 3 (the
    reference's class is dimension-generic,
    NavierStokesSIMPLE_iterative.py:28-36,53-70): V is a combo-cached
    HDivSpace3D (BDM tets), ``facet_space`` the tangential facet space in
    each face's global frame, ``sigma_basis`` the trace-free tet stress
    element (fem/hcurldiv3d), and the vorticity multiplier is the
    3-component VectorL2 field W with Skew2Vec(m) = (m01-m10, m20-m02,
    m12-m21) (reference :57-58).  3D H(div) face dofs are global-frame
    moments, so no orientation signs exist.

    Affine factorization: every physical integral is a combo-level
    REFERENCE integral (shared across all elements with the same face
    orientations) contracted with a small per-element geometry tensor
    built from J / Jinv / detJ — no per-element quadrature arrays are ever
    materialized, so host assembly cost is a handful of GEMMs:

      sigma_phys : tau_phys = (1/detJ^2) sigmahat : (Ginv tauhat G),
      skw_c(sigma_phys)     = K[c,a,b] sigmahat_ab / detJ,
      (sigma_phys n)_i      = (1/detJ) Jinv[a,i] (sigmahat J^T n)_a,
      v_phys . n            = vhat . (J^T n) / detJ.

    Returns (A_ret, A_rc, A_cc, M_full, B_loc): the retained/eliminated
    blocks plus the velocity mass on the retained block and the pressure
    divergence coupling (per-element tables the model ships to device).
    """
    k = V.order
    nbv = V.n_basis
    sb = sigma_basis
    nbs = sb.n_basis
    nss = facet_space.n_scalar
    nfd = facet_space.n_face  # 2 * nss
    nfac = 4 * nfd
    nbw_s = Wq_basis.n_basis  # scalar modes; W has 3 components
    nbw = 3 * nbw_s

    J, detJ, Jinv = mesh.element_jacobians
    ne = mesh.ne
    vol = tetrahedron_rule(2 * k + 2)
    w = vol.weights
    nq = len(w)

    s_val, s_grad = sb.tabulate(vol.points)  # shared reference tables
    w_val, _ = Wq_basis.tabulate(vol.points)
    q_val, _ = Q_basis.tabulate(vol.points)
    ncombo = len(V.bases)
    combo_sel = [np.where(V.combo_ids == c)[0] for c in range(ncombo)]
    vtabs = [V.bases[c].tabulate(vol.points) for c in range(ncombo)]

    n_ret = nbv + nfac
    n_el = nbs + nbw
    A_ret = np.zeros((ne, n_ret, n_ret))
    A_rc = np.zeros((ne, n_ret, n_el))
    A_cc = np.zeros((ne, n_el, n_el))
    M_full = np.zeros((ne, n_ret, n_ret))
    B_loc = np.zeros((ne, q_val.shape[1], n_ret))

    G = np.matmul(J.transpose(0, 2, 1), J)
    Ginv = np.linalg.inv(G)

    # -(1/(2 nu)) sigma:tau: D[a,c,d,b][n,m] = sum_q w shat[q,n,a,b]
    # shat[q,m,c,d]; per element contract with Ginv[a,c] G[d,b] / detJ.
    sw = s_val * w[:, None, None, None]
    D = np.tensordot(sw, s_val, axes=(0, 0))  # (nbs,3a,3b, nbs,3c,3d)
    D2 = np.ascontiguousarray(D.transpose(1, 4, 5, 2, 0, 3)).reshape(
        81, nbs * nbs
    )  # (a,c,d,b) x (n,m)
    CC = (Ginv[:, :, None, None, :] * G.transpose(0, 2, 1)[:, None, :, :, None]
          ).transpose(0, 1, 4, 2, 3)  # [e,a,c,d,b] = Ginv[e,a,c] G[e,d,b]
    A_cc[:, :nbs, :nbs] += (-(0.5 / nu) / detJ)[:, None, None] * np.matmul(
        CC.reshape(ne, 81), D2
    ).reshape(ne, nbs, nbs)

    # vorticity multiplier Skew2Vec (reference :57-58): skw_c(sigma_phys) =
    # K[e,c,a,b] sigmahat_ab / detJ; detJ cancels against the volume element
    K = np.stack(
        [
            np.einsum("ea,eb->eab", Jinv[:, :, 0], J[:, 1, :])
            - np.einsum("ea,eb->eab", Jinv[:, :, 1], J[:, 0, :]),
            np.einsum("ea,eb->eab", Jinv[:, :, 2], J[:, 0, :])
            - np.einsum("ea,eb->eab", Jinv[:, :, 0], J[:, 2, :]),
            np.einsum("ea,eb->eab", Jinv[:, :, 1], J[:, 2, :])
            - np.einsum("ea,eb->eab", Jinv[:, :, 2], J[:, 1, :]),
        ],
        axis=1,
    )  # (ne, 3, 3, 3)
    # WS[nw, m, a, b] = sum_q w wval[q,nw] shat[q,m,a,b]
    WS = np.tensordot(w_val * w[:, None], s_val, axes=(0, 0))
    wr = np.tensordot(
        K.reshape(ne * 3, 9), WS.transpose(2, 3, 0, 1).reshape(9, nbw_s * nbs),
        axes=(1, 0),
    ).reshape(ne, 3, nbw_s, nbs).reshape(ne, nbw, nbs)
    A_cc[:, nbs:, :nbs] += wr
    A_cc[:, :nbs, nbs:] += wr.transpose(0, 2, 1)

    # div(sigma).v: per-combo reference integral E_c[i,m], scaled 1/detJ
    div_s_ref = np.einsum("qnabb->qna", s_grad)
    wdsr = w[:, None, None] * div_s_ref  # (nq, nbs, 3)
    for c in range(ncombo):
        sel = combo_sel[c]
        if not len(sel):
            continue
        vv, vg = vtabs[c]
        E_c = np.tensordot(
            vv.reshape(nq, nbv, 3), wdsr, axes=([0, 2], [0, 2])
        )  # (nbv, nbs)
        A_rc[sel, :nbv, :nbs] += E_c[None] / detJ[sel, None, None]
        # grad-div 2 nu (div u)(div v) / detJ and mass / B from the same tabs
        dvr = np.einsum("qiaa->qi", vg)  # (nq, nbv)
        GD = dvr.T @ (dvr * w[:, None])
        A_ret[sel, :nbv, :nbv] += (2.0 * nu / detJ[sel, None, None]) * GD[None]
        # velocity mass: M[e] = (1/detJ) G[e,a,b] C[a,b] with
        # C[a,b,i,j] = sum_q w vhat[q,i,a] vhat[q,j,b]
        Cab = np.einsum("qia,qjb->abij", vv * w[:, None, None], vv, optimize=True)
        M_full[sel[:, None, None], np.arange(nbv)[None, :, None],
               np.arange(nbv)[None, None, :]] = np.matmul(
            G[sel].reshape(-1, 1, 9), Cab.reshape(9, nbv * nbv)[None]
        ).reshape(len(sel), nbv, nbv) / detJ[sel, None, None]
        # pressure coupling: int div(u) q dx = int_ref divhat qhat
        B_loc[sel, :, :nbv] = ((q_val * w[:, None]).T @ dvr)[None]

    # facet terms over the 4 faces (global-frame quadrature): combo-level
    # trace integrals T1/S2 contracted with per-element (m, r, s) vectors,
    # m = J^T n, r = Jinv n, s_d = Jinv E_d.
    fg = facet_geometry_3d(mesh, 2 * k + 2)
    fvals, _ = triangle_modal(fg.qp, facet_space.order)  # (nq2, nss)
    fw = fvals * fg.qw[:, None]
    for lf in range(4):
        nrm = fg.normal[:, lf]
        ds = fg.area[:, lf]
        m_e = np.einsum("eba,eb->ea", J, nrm)  # J^T n
        r_e = np.einsum("eab,eb->ea", Jinv, nrm)  # Jinv n
        s_e = np.matmul(Jinv[:, None], fg.frame[:, lf, :, :, None]).squeeze(-1)
        # (ne, 2, 3): s_d = Jinv E_d
        for c in range(ncombo):
            sel = combo_sel[c]
            if not len(sel):
                continue
            p0 = fg.ref_points[sel[0], lf]
            vtr = V.bases[c].tabulate(p0)[0]  # (nq2, nbv, 3)
            str_ = sb.tabulate(p0)[0]  # (nq2, nbs, 3, 3)
            # T1[c3,a,b][i,m] = sum_q w2 vtr[q,i,c3] str[q,m,a,b]
            T1 = np.tensordot(
                vtr * fg.qw[:, None, None], str_, axes=(0, 0)
            )  # (nbv, 3c3, nbs, 3a, 3b)
            T1 = np.ascontiguousarray(T1.transpose(1, 3, 4, 0, 2)).reshape(
                27, nbv * nbs
            )
            # -(sigma n.n)(v.n): coeff = m_c3 r_a m_b * ds / detJ^2
            co = (
                m_e[sel][:, :, None, None]
                * r_e[sel][:, None, :, None]
                * m_e[sel][:, None, None, :]
            ).reshape(len(sel), 27)
            blk = np.matmul(co, T1).reshape(len(sel), nbv, nbs)
            A_rc[sel, :nbv, :nbs] -= blk * (
                ds[sel] / detJ[sel] ** 2
            )[:, None, None]
            # -(sigma n).tang(uhat): S2[a,b][j,m] = sum_q w2 f[q,j] str[q,m,a,b]
            S2 = np.tensordot(fw, str_, axes=(0, 0))  # (nss, nbs, 3a, 3b)
            S2 = np.ascontiguousarray(S2.transpose(2, 3, 0, 1)).reshape(
                9, nss * nbs
            )
            co2 = (
                s_e[sel][:, :, :, None] * m_e[sel][:, None, None, :]
            ).reshape(len(sel) * 2, 9)
            blk2 = np.matmul(co2, S2).reshape(len(sel), 2, nss, nbs)
            blk2 = blk2.transpose(0, 2, 1, 3).reshape(len(sel), nfd, nbs)
            A_rc[
                sel[:, None, None],
                nbv + lf * nfd + np.arange(nfd)[None, :, None],
                np.arange(nbs)[None, None, :],
            ] -= blk2 * (ds[sel] / detJ[sel])[:, None, None]
    return A_ret, A_rc, A_cc, M_full, B_loc


def _assemble_mcs_ns_local_curved_3d(mesh, V, facet_space, sigma_basis,
                                     Wq_basis, Q_basis, nu, geometry,
                                     A_ret, A_rc, A_cc, M_full, B_loc):
    """Overwrite the CURVED-element rows of the affine 3D MCS tables with
    the isoparametric (order-g tet Lagrange map) assembly — the 3D
    counterpart of ``_assemble_mcs_ns_local_curved``.

    Only ``geometry.curved_elements`` — the O(surface) subset with a
    non-affine map — is re-assembled per quadrature point; all other
    elements keep the affine combo-factorized tables, so the expensive
    per-point arrays stay bounded by the curved-layer size.  The same
    pullbacks as 2D apply, in 3D index form:

      sigma_phys_ij = Jinv_ai sigmahat_ab J_jb / detJ     (H(curl,div))
      v_phys        = J vhat / detJ                        (H(div) Piola)
      div u         = divhat u / detJ                      (exact identity)
      d_B detJ      = detJ tr(Jinv dJ/dB)                  (Jacobi)

    and div(sigma_phys) picks up the same three curvature terms as the 2D
    docstring plus the -ddet/detJ correction.  Facet integrals use the
    exact curved scaled normal cross(J e1r, J e2r) of each face's
    sorted-global reference frame; the facet SPACE keeps its fixed
    affine-face frame (it defines the discrete space), while sigma.n is
    tangentialized against the curved unit normal, matching the 2D curved
    convention.  Mutates the five tables in place.
    """
    from ..mesh.curved import geometry_hessian_3d, geometry_tables_3d
    from ..fem.reference import TET_FACES, TET_VERTICES

    sel_all = np.asarray(geometry.curved_elements)
    if not len(sel_all):
        return
    gb = geometry.basis
    k = V.order
    nbv = V.n_basis
    sb = sigma_basis
    nbs = sb.n_basis
    nss = facet_space.n_scalar
    nfd = facet_space.n_face
    nfac = 4 * nfd
    nbw_s = Wq_basis.n_basis
    nbw = 3 * nbw_s
    n_ret = nbv + nfac
    n_el = nbs + nbw

    # 2k+3 (125 collapsed points): one degree above the affine assembler's
    # exactness requirement — the curved integrands are rational, so extra
    # exactness is unreachable and the next tier (2k+4 -> 216 points) costs
    # 1.7x for no measured accuracy change
    vol = tetrahedron_rule(2 * k + 3)
    w = vol.weights
    s_val, s_grad = sb.tabulate(vol.points)  # (nq,nbs,3,3), (nq,nbs,3,3,3)
    w_val, _ = Wq_basis.tabulate(vol.points)
    q_val, _ = Q_basis.tabulate(vol.points)
    vtabs = [b.tabulate(vol.points) for b in V.bases]

    A_ret[sel_all] = 0.0
    A_rc[sel_all] = 0.0
    A_cc[sel_all] = 0.0
    M_full[sel_all] = 0.0
    B_loc[sel_all] = 0.0

    # chunk the per-quadrature-point volume work: the div(sigma) curvature
    # intermediate alone is (nc, nq, nbs, 3, 3, 3) — at 216 points and 56
    # stress modes that is ~2.6 MB PER ELEMENT, so an all-element pass
    # would allocate gigabytes.  64-element chunks keep every intermediate
    # under ~200 MB while the einsums stay batched enough to be fast.
    for chunk in np.array_split(sel_all, max(1, len(sel_all) // 64)):
        nc = len(chunk)
        J, detJ, Jinv, _ = geometry_tables_3d(
            geometry.coords[chunk], gb, vol.points
        )
        H = geometry_hessian_3d(geometry.coords[chunk], gb, vol.points)
        cids = V.combo_ids[chunk]
        v_val = np.stack([vtabs[c][0] for c in cids])  # (nc, nq, nbv, 3)
        v_grad = np.stack([vtabs[c][1] for c in cids])

        # physical stress values per point
        sp = np.einsum(
            "eqai,qnab,eqjb->eqnij", Jinv, s_val, J, optimize=True
        ) / detJ[..., None, None, None]
        A_cc[chunk, :nbs, :nbs] += -(0.5 / nu) * np.einsum(
            "q,eqnij,eqmij,eq->enm", w, sp, sp, detJ, optimize=True
        )
        # Skew2Vec rows (c ordering as the affine K construction)
        skw = np.stack(
            [
                sp[..., 0, 1] - sp[..., 1, 0],
                sp[..., 2, 0] - sp[..., 0, 2],
                sp[..., 1, 2] - sp[..., 2, 1],
            ],
            axis=2,
        )  # (nc, nq, 3, nbs)
        wr = np.einsum(
            "q,qn,eqcm,eq->ecnm", w, w_val, skw, detJ, optimize=True
        ).reshape(nc, nbw, nbs)
        A_cc[chunk, nbs:, :nbs] += wr
        A_cc[chunk, :nbs, nbs:] += wr.transpose(0, 2, 1)

        # div(sigma) with curvature terms: div_s[e,q,n,i] =
        # T[e,q,n,i,j,B] Jinv[e,q,B,j] with T the four-term derivative of
        # sigma_phys — contracted term by term WITHOUT materializing the
        # 6-index T (that intermediate alone is ~2.6 MB/element and its
        # elementwise arithmetic dominated the first implementation)
        ddet = detJ[..., None] * np.einsum(
            "eqdc,eqcdB->eqB", Jinv, H, optimize=True
        )
        dJinv = -np.einsum(
            "eqac,eqcdB,eqdi->eqaiB", Jinv, H, Jinv, optimize=True
        )
        JJ = np.einsum("eqjb,eqBj->eqbB", J, Jinv, optimize=True)
        div_s = (
            np.einsum("eqaiB,qnab,eqbB->eqni", dJinv, s_val, JJ,
                      optimize=True)
            + np.einsum("eqai,qnabB,eqbB->eqni", Jinv, s_grad, JJ,
                        optimize=True)
            + np.einsum("eqai,qnab,eqjbB,eqBj->eqni", Jinv, s_val, H,
                        Jinv, optimize=True)
        ) / detJ[..., None, None]
        dd2 = np.einsum("eqB,eqBj->eqj", ddet / detJ[..., None], Jinv,
                        optimize=True)
        div_s -= np.einsum("eqnij,eqj->eqni", sp, dd2, optimize=True)
        Jv = np.einsum("eqcA,eqnA->eqnc", J, v_val, optimize=True)
        A_rc[chunk, :nbv, :nbs] += np.einsum(
            "q,eqmi,eqni->enm", w, div_s, Jv, optimize=True
        )

        # grad-div, pressure coupling, velocity mass
        dvr = np.einsum("eqnaa->eqn", v_grad)
        A_ret[chunk, :nbv, :nbv] += 2.0 * nu * np.einsum(
            "q,eqn,eqm,eq->enm", w, dvr, dvr, 1.0 / detJ, optimize=True
        )
        B_loc[chunk, :, :nbv] = np.einsum(
            "q,qp,eqn->epn", w, q_val, dvr, optimize=True
        )
        G = np.einsum("eqca,eqcb->eqab", J, J, optimize=True)
        M_full[chunk, :nbv, :nbv] = np.einsum(
            "q,eqna,eqab,eqmb,eq->enm", w, v_val, G, v_val, 1.0 / detJ,
            optimize=True,
        )

    # facet terms: group curved elements by combo so each face's reference
    # points (orientation-dependent) are shared within the group
    fg = facet_geometry_3d(mesh, 2 * k + 4)
    fvals, _ = triangle_modal(fg.qp, facet_space.order)  # (nq2, nss)
    ncombo = len(V.bases)
    for c in range(ncombo):
        sel_c = sel_all[V.combo_ids[sel_all] == c]
        if not len(sel_c):
            continue
        for lf in range(4):
          for sel in np.array_split(sel_c, max(1, len(sel_c) // 256)):
            p0 = fg.ref_points[sel[0], lf]  # shared within the combo
            Jf, detf, Jinvf, _ = geometry_tables_3d(
                geometry.coords[sel], gb, p0
            )
            vtr, _ = V.bases[c].tabulate(p0)  # (nq2, nbv, 3)
            str_, _ = sb.tabulate(p0)  # (nq2, nbs, 3, 3)
            # curved scaled normal from the face parametrization in the
            # sorted-global reference frame
            fverts = TET_FACES[lf]
            perm = fg.face_perm[sel[0], lf]
            lv = TET_VERTICES[np.asarray(fverts)[perm]]
            e1r, e2r = lv[1] - lv[0], lv[2] - lv[0]
            t1 = np.einsum("eqcd,d->eqc", Jf, e1r, optimize=True)
            t2 = np.einsum("eqcd,d->eqc", Jf, e2r, optimize=True)
            nsc = np.cross(t1, t2)  # (nc, nq2, 3), |.| = dS/(ds dt)
            # orient outward (match the affine normal's side)
            sgn = np.sign(np.einsum(
                "eqc,ec->eq", nsc, fg.normal[sel, lf]
            ).sum(axis=1))
            nsc *= sgn[:, None, None]
            dsq = np.linalg.norm(nsc, axis=-1)
            n_unit = nsc / dsq[..., None]

            v_tp = np.einsum(
                "eqcA,qiA->eqic", Jf, vtr, optimize=True
            ) / detf[..., None, None]
            s_tp = np.einsum(
                "eqai,qnab,eqjb->eqnij", Jinvf, str_, Jf, optimize=True
            ) / detf[..., None, None, None]
            vn = np.einsum("eqic,eqc->eqi", v_tp, n_unit, optimize=True)
            sn = np.einsum("eqnij,eqj->eqni", s_tp, n_unit, optimize=True)
            snn = np.einsum("eqni,eqi->eqn", sn, n_unit, optimize=True)
            blk = np.einsum(
                "q,eqm,eqi,eq->eim", fg.qw, snn, vn, dsq, optimize=True
            )
            A_rc[sel, :nbv, :nbs] -= blk
            # tangential facet pairing: fixed affine-face frame E_d,
            # sigma.n tangentialized against the curved normal; facet dof
            # ordering j*2+d (scalar-major) as the affine path
            sn_t = sn - snn[..., None] * n_unit[:, :, None, :]
            Ed = fg.frame[sel, lf]  # (nc, 2, 3)
            blk2 = np.einsum(
                "q,qj,eqmc,edc,eq->ejdm", fg.qw, fvals, sn_t, Ed, dsq,
                optimize=True,
            ).reshape(len(sel), nfd, nbs)
            A_rc[
                sel[:, None, None],
                nbv + lf * nfd + np.arange(nfd)[None, :, None],
                np.arange(nbs)[None, None, :],
            ] -= blk2


class NavierStokesMCS:
    def __init__(
        self,
        mesh,
        nu: float,
        inflow: str,
        outflow: str,
        wall: str,
        uin,
        timestep: float,
        order: int = 2,
        volumeforce=None,
        dtype=jnp.float64,
        preconditioner: str = "auxspace",
        geometry=None,
        assembly_cache: dict | None = None,
    ):
        self.nu, self.timestep, self.uin = nu, timestep, uin
        self.inflow, self.outflow, self.wall = inflow, outflow, wall
        self.mesh, self.order, self.dtype = mesh, order, dtype
        self.preconditioner = preconditioner

        import os as _os
        import sys as _sys
        import time as _time

        _t0 = _time.perf_counter()
        t_upload = 0.0  # seconds spent copying the operator tables up

        def _plog(msg):
            if _os.environ.get("NSTPU_SETUP_LOG"):
                print(
                    f"      [init] {msg} {_time.perf_counter() - _t0:.1f}s",
                    file=_sys.stderr, flush=True)

        dirich = inflow + "|" + wall
        # stress: polynomial degree k with facet nt-trace degree k-1 — the
        # reference's HCurlDiv(order-1, orderinner=order) (:27).  The
        # interior richness is needed for definiteness of the condensed
        # operator (plain P_{k-1} stress leaves a large kernel) and the
        # reduced trace degree matches the facet space, which the MCS
        # consistency requires (trace degree k would test u_t - uhat_t
        # beyond uhat's polynomial degree).
        self.Wspace = L2(mesh, order - 1)
        self.Q = L2(mesh, order - 1)
        if mesh.dim == 2:
            self.V = HDiv(mesh, order, dirichlet=dirich, RT=False)
            self.Vhat = VectorFacet(
                mesh, order - 1, dirichlet=dirich + "|" + outflow
            )
            self.Xv = HybridVelocitySpace(self.V, self.Vhat)
            self.sigma_basis = hcurldiv_triangle(order, order_trace=order - 1)
            if geometry is not None:
                A_ret, A_rc, A_cc, M_full_np, B_loc_np = (
                    _assemble_mcs_ns_local_curved(
                        mesh, self.V, self.Vhat, self.sigma_basis,
                        self.Wspace, nu, geometry,
                    )
                )
            else:
                A_ret, A_rc, A_cc, v_p, vol = _assemble_mcs_ns_local(
                    mesh, self.V, self.Vhat, self.sigma_basis, self.Wspace, nu
                )
        else:
            # 3D: same class, tet spaces (the reference's NavierStokes is
            # dimension-generic; 3D demo NavierStokesSIMPLE_test_3D.py:20-28)
            self.V = HDiv3D(mesh, order, dirichlet=dirich)
            self.Vhat = VectorFacet3D(
                mesh, order - 1, dirichlet=dirich + "|" + outflow
            )
            self.Xv = HybridVelocitySpace3D(self.V, self.Vhat)
            self.sigma_basis = hcurldiv_tet(order, order_trace=order - 1)
            # ``assembly_cache``: a dict shared between two builds of the
            # SAME (mesh, order, nu) lets a second model (e.g. the f32
            # transient twin of the bench's f64 model) skip host assembly
            # and condensation entirely — only the device casts differ.
            _plog("spaces built")
            tkey = "tabs3d" if geometry is None else "tabs3d_curved"
            if assembly_cache is not None and tkey in assembly_cache:
                A_ret, A_rc, A_cc, M_full_np, B_loc_np = assembly_cache[
                    tkey
                ]
            else:
                A_ret, A_rc, A_cc, M_full_np, B_loc_np = (
                    _assemble_mcs_ns_local_3d(
                        mesh, self.V, self.Vhat, self.sigma_basis,
                        self.Wspace.basis, self.Q.basis, nu,
                    )
                )
                if geometry is not None:
                    # isoparametric overwrite of the curved-layer rows
                    _assemble_mcs_ns_local_curved_3d(
                        mesh, self.V, self.Vhat, self.sigma_basis,
                        self.Wspace.basis, self.Q.basis, nu, geometry,
                        A_ret, A_rc, A_cc, M_full_np, B_loc_np,
                    )
                if assembly_cache is not None:
                    assembly_cache[tkey] = (
                        A_ret, A_rc, A_cc, M_full_np, B_loc_np
                    )
        _plog("local assembly (or cache hit)")
        # static condensation: batched dense elimination of (sigma, W)
        ckey = "cond" if geometry is None else "cond_curved"
        if assembly_cache is not None and ckey in assembly_cache:
            self._Acc_inv, self.A_cond_np = assembly_cache[ckey]
        else:
            self._Acc_inv = np.linalg.inv(A_cc)
            self.A_cond_np = A_ret - np.einsum(
                "eic,ecd,ejd->eij", A_rc, self._Acc_inv, A_rc
            , optimize=True)
            if assembly_cache is not None:
                assembly_cache[ckey] = (self._Acc_inv, self.A_cond_np)
        _plog("condensation (or cache hit)")
        self._A_rc = A_rc  # for stress reconstruction

        n = self.Xv.ndof
        self.n = n
        self.eldofs = jnp.asarray(self.Xv.element_dofs)
        self.free = jnp.asarray(self.Xv.free_mask)
        if mesh.dim == 3:
            # scatter-free face-block applies (ops/faceblock.py): element
            # blocks ship PERMUTED into face-major order
            from ..ops.faceblock import FaceBlockLayout

            self.fb = FaceBlockLayout(self.Xv)
            A_perm = self.fb.permute_blocks(self.A_cond_np)
            _tu = _time.perf_counter()
            A_cond = jax.block_until_ready(jnp.asarray(A_perm, dtype))
            t_upload += _time.perf_counter() - _tu
            del A_perm
        else:
            self.fb = None
            A_cond = jnp.asarray(self.A_cond_np, dtype)
        self._A_cond = A_cond
        _plog("face-block permute + A upload")

        if mesh.dim == 2 and geometry is None:
            # velocity mass (u block only; signs folded) for mstar +
            # projection
            nbv = self.V.basis.n_basis
            M_u = np.einsum(
                "q,eqic,eqjc,e->eij", vol.weights,
                v_p * self.V.element_signs[:, None, :, None],
                v_p * self.V.element_signs[:, None, :, None],
                mesh.element_jacobians[1],
            optimize=True)
            n_ret = self.A_cond_np.shape[1]
            M_full = np.zeros((mesh.ne, n_ret, n_ret))
            M_full[:, :nbv, :nbv] = M_u
            self._M_loc_np = M_full

            # divergence coupling B: pressure x retained (u block only)
            qb = self.Q.basis
            q_val, _ = qb.tabulate(vol.points)
            _, v_grad = self.V.basis.tabulate(vol.points)
            div_v_ref = np.einsum("qnaa->qn", v_grad)
            # int div(u) q dx = sum_q w divhat q (Piola div and detJ
            # cancel): the same reference-frame block for every element,
            # up to signs
            B_loc = np.zeros((mesh.ne, qb.n_basis, n_ret))
            B_ref = np.einsum("q,qp,qi->pi", vol.weights, q_val, div_v_ref, optimize=True)
            B_loc[:, :, :nbv] = B_ref[None] * self.V.element_signs[:, None, :]
            B_host = B_loc
            self._B_loc = jnp.asarray(B_loc, dtype)
        else:
            self._M_loc_np = M_full_np
            B_host = np.asarray(B_loc_np)
            self._B_loc = jnp.asarray(B_loc_np, dtype)
        self.eldofs_p = jnp.asarray(self.Q.element_dofs)

        free, eldofs = self.free, self.eldofs

        self._B_host = B_host  # setup paths must never download _B_loc
        if self.fb is not None:
            _A_apply = self.fb.elem_apply(A_cond)
            # _B_loc keeps the FLAT element-local order (host assembly in
            # tests/ddshard reads it); the face-major copy feeds the apply.
            # Permute the HOST copy: no device->host copy of the table.
            B_perm = self.fb.permute_cols(B_host)
            _tu = _time.perf_counter()
            self._B_perm = jax.block_until_ready(jnp.asarray(B_perm, dtype))
            t_upload += _time.perf_counter() - _tu
            _plog("B permute+upload")
            _B_apply, _BT_apply = self.fb.rect_apply(
                self._B_perm, self.Q.element_dofs, self.Q.ndof
            )

            def A_raw(u):
                return _A_apply(u)

            def mass_raw(u):
                return self.fb.elem_apply(self._M_loc)(u)

            def B_raw(u):
                return _B_apply(u)

            def BT(p):
                return jnp.where(free, _BT_apply(p), 0.0)

        else:

            def A_raw(u):
                return asm.apply_local_matrices(A_cond, eldofs, n, u)

            def mass_raw(u):
                # mass tables ship to device lazily: the steady SolveInitial
                # path never touches them (device memory at bench sizes)
                return asm.apply_local_matrices(self._M_loc, eldofs, n, u)

            def B_raw(u):
                ue = u[eldofs]
                pe = jnp.einsum("epi,ei->ep", self._B_loc, ue, optimize=True)
                return asm.scatter_add(pe, self.eldofs_p, self.Q.ndof)

            def BT(p):
                pe = p[self.eldofs_p]
                ue = jnp.einsum("epi,ep->ei", self._B_loc, pe, optimize=True)
                return jnp.where(free, asm.scatter_add(ue, eldofs, n), 0.0)

        def A(u):
            uf = jnp.where(free, u, 0.0)
            return jnp.where(free, A_raw(uf), u)

        def mstar(u):
            uf = jnp.where(free, u, 0.0)
            y = mass_raw(uf) + timestep * A_raw(uf)
            return jnp.where(free, y, u)

        def B(u):
            return B_raw(jnp.where(free, u, 0.0))

        self.A, self.A_raw, self.mstar = A, A_raw, mstar
        self.B, self.B_raw, self.BT = B, B_raw, BT
        self._mass_raw = mass_raw

        # preconditioners: built lazily via _preA_for — the additive variant
        # (GS=False) by default; SolveInitial(GS=True) swaps in the
        # symmetric multi-color block-Gauss-Seidel variant (reference
        # MypreA.Mult :375-381) built from the same blocks.
        _plog("operator closures")
        self._dirich = dirich
        self._preA_cache: dict[bool, object] = {}
        diag_m_np = np.zeros(n)
        np.add.at(
            diag_m_np, self.Xv.element_dofs.ravel(),
            np.einsum(
                "eii->ei", self._M_loc_np + timestep * self.A_cond_np
            ).ravel(),
        )
        diag_m = jnp.where(free, jnp.abs(jnp.asarray(diag_m_np, dtype)), 1.0)
        self.preMstar = lambda u: jnp.where(free, u / diag_m, u)
        tq = asm.make_tables(self.Q, 2 * max(self.Q.order, 1), dtype)
        diag_Mp = asm.diagonal_of_local(asm.mass_local(tq), tq.eldofs, self.Q.ndof)
        self._diag_Mp = diag_Mp
        if not outflow:
            # enclosed flow: deflate the constant-pressure nullspace
            def demean(p):
                return p - jnp.mean(p)

            B_enc, B_raw_enc, BT_enc = self.B, self.B_raw, self.BT
            self.B = lambda u: demean(B_enc(u))
            self.B_raw = lambda u: demean(B_raw_enc(u))
            self.BT = lambda p: BT_enc(demean(p))
            self.preM = lambda p: nu * demean(demean(p) / diag_Mp)
            self._preM_proj = lambda p: demean(demean(p) / diag_Mp)
        else:
            self.preM = lambda p: nu * p / diag_Mp
            self._preM_proj = lambda p: p / diag_Mp
        diag_Mv_np = np.zeros(n)
        np.add.at(
            diag_Mv_np, self.Xv.element_dofs.ravel(),
            np.einsum("eii->ei", self._M_loc_np).ravel(),
        )
        diag_Mv = jnp.asarray(diag_Mv_np, dtype)
        diag_Mv = jnp.where(free & (jnp.abs(diag_Mv) > 1e-30), diag_Mv, 1.0)
        self._preMv = lambda u: jnp.where(free, u / diag_Mv, u)

        # mass (masked, identity off the u block) for projection solves
        nbv_total = self.V.ndof
        umask = jnp.arange(n) < nbv_total
        self._umask = umask

        def Mv(u):
            uf = jnp.where(free & umask, u, 0.0)
            y = mass_raw(uf)
            return jnp.where(free & umask, y, u)

        self._Mv = Mv

        # convection (upwind DG on the H(div) block): built lazily — its
        # per-element trace tables are the largest setup artifact and the
        # steady SolveInitial path never touches them
        _plog("diagonals + projection ops")
        self._uin_np = self._wrap_uin(uin)
        self._conv_v = None

        # rhs + state
        self.f = jnp.zeros(n, dtype)
        if volumeforce is not None:
            self.AddForce(volumeforce)
        if mesh.dim == 2:
            u_bc = interpolate_hybrid_boundary(self.Xv, self._uin_np, inflow)
        else:
            u_bc = interpolate_hybrid_boundary_3d(
                self.Xv, self._uin_np, inflow
            )
        _plog("boundary interpolation")
        self.u_bc = jnp.asarray(u_bc, dtype)
        self.u = self.u_bc
        self.p = jnp.zeros(self.Q.ndof, dtype)
        self.stokes_bpcg_iterations = None
        self.stokes_bpcg_time = None
        # wall seconds of the build's host->device copies of the condensed
        # operator and coupling tables
        self.upload_seconds = t_upload

    # ------------------------------------------------------------------

    @property
    def _M_loc(self):
        if getattr(self, "_M_loc_j", None) is None:
            # lazily shipped to device; ensure_compile_time_eval keeps the
            # materialization CONCRETE even when first touched inside a jit
            # trace (a traced constant would leak out of the trace)
            np_dt = np.dtype(self.dtype.__name__)
            M = self._M_loc_np
            if self.fb is not None:
                M = self.fb.permute_blocks(np.asarray(M))
            with jax.ensure_compile_time_eval():
                self._M_loc_j = jnp.asarray(np.asarray(M, np_dt))
        return self._M_loc_j

    def _build_convection(self):
        """Materialize the convection trace tables (largest setup artifact;
        built lazily because the steady SolveInitial path never needs them).

        MUST be called OUTSIDE any jit trace before the first traced
        ``convection`` apply: the table constants otherwise materialize
        inside the trace and are embedded in the compiled module rather
        than staying runtime device buffers, which made an otherwise
        identical fused step run many times slower per call."""
        if self._conv_v is None:
            if self.mesh.dim == 2:
                self._conv_v = build_upwind_convection(
                    self.V, self._uin_np, dtype=self.dtype
                )
            else:
                self._conv_v = build_upwind_convection_3d(
                    self.V, self._uin_np, dtype=self.dtype
                )
        return self._conv_v

    def convection(self, u):
        self._build_convection()
        nbv_total = self.V.ndof
        cu = self._conv_v(u[:nbv_total])
        return jnp.concatenate([cu, jnp.zeros(self.n - nbv_total, u.dtype)])

    def _wrap_uin(self, uin):
        dim = self.mesh.dim

        def f(p):
            out = np.asarray(uin(p))
            if out.ndim == 1:
                full = np.zeros((len(p), dim))
                full[:, 0] = out
                return full
            return out

        return f

    @property
    def velocity(self) -> np.ndarray:
        """H(div) velocity dof vector (normal-moment + interior coeffs)."""
        return np.asarray(self.u[: self.V.ndof])

    @property
    def pressure(self) -> np.ndarray:
        return -np.asarray(self.p)

    def AddForce(self, force):
        fq_builder = self._force_local(force)
        self.f = self.f + jnp.asarray(fq_builder, self.dtype)

    def _force_local(self, force):
        mesh = self.mesh
        dim = mesh.dim
        J, detJ, _ = mesh.element_jacobians
        if dim == 2:
            hb = self.V.basis
            vol = triangle_rule(2 * hb.order + 2)
            v_val, _ = hb.tabulate(vol.points)
            v_p = np.einsum(
                "ecA,qiA->eqic", J, v_val, optimize=True
            ) / detJ[:, None, None, None]
            v_p = v_p * self.V.element_signs[:, None, :, None]
            nbv = hb.n_basis
        else:
            vol = tetrahedron_rule(2 * self.V.order + 2)
            v_val, _ = self.V.tabulate_elements(vol.points)
            v_p = np.einsum(
                "ecA,eqiA->eqic", J, v_val, optimize=True
            ) / detJ[:, None, None, None]
            nbv = self.V.n_basis
        qpts = mesh.points[mesh.elements[:, 0]][:, None, :] + np.einsum(
            "eab,qb->eqa", J, vol.points
        , optimize=True)
        fq = np.asarray(force(qpts.reshape(-1, dim))).reshape(mesh.ne, -1, dim)
        fe_v = np.einsum("q,eqc,eqic,e->ei", vol.weights, fq, v_p, detJ, optimize=True)
        n_ret = self.A_cond_np.shape[1]
        fe = np.zeros((mesh.ne, n_ret))
        fe[:, :nbv] = fe_v
        out = np.zeros(self.n)
        np.add.at(out, self.Xv.element_dofs.ravel(), fe.ravel())
        return out

    @property
    def preA(self):
        return self._preA_for(GS=False)

    def _preA_for(self, GS: bool):
        """Additive (GS=False) or symmetric multi-color block-GS (GS=True)
        variant of the A-preconditioner, built from the same patch blocks
        (reference MypreA, NavierStokesSIMPLE_iterative.py:364-391)."""
        if GS not in self._preA_cache:
            if self.mesh.dim == 2:
                self._preA_cache[GS] = build_hybrid_preconditioner(
                    self.Xv, self.A_cond_np, self.preconditioner,
                    self._dirich, self.dtype, coarse_coefficient=self.nu,
                    gs=GS, A_apply=self.A if GS else None,
                )
            elif self.preconditioner == "auxspace":
                from .auxspace3d import build_skeleton_preconditioner_3d

                self._preA_cache[GS] = build_skeleton_preconditioner_3d(
                    self.Xv, self.A_cond_np, self._dirich, self.dtype,
                    coarse_coefficient=self.nu, gs=GS,
                )
            elif GS:
                from ..precond.multicolor import (
                    MulticolorGS,
                    color_blocks,
                    symmetric_gs_preconditioner,
                )
                from ..precond.jacobi import extract_blocks_from_local
                from .stokes_hybrid3d import hybrid_blocks_3d

                fmask = self.Xv.free_mask
                blks = [
                    np.asarray([d for d in b if fmask[d]], np.int32)
                    for b in hybrid_blocks_3d(self.Xv, "face")
                ]
                blks = [b for b in blks if len(b)]
                dofs, mats = extract_blocks_from_local(
                    self.A_cond_np, self.Xv.element_dofs, blks, self.n
                )
                colors = color_blocks(blks, self.n, self.Xv.element_dofs)
                mgs = MulticolorGS(dofs, mats, colors, self.n, self.dtype)
                self._preA_cache[GS] = symmetric_gs_preconditioner(
                    mgs, self.A, None, self.free
                )
            else:
                self._preA_cache[GS] = build_faceblock_preconditioner_3d(
                    self.Xv, self.A_cond_np, self.dtype
                )
        return self._preA_cache[GS]

    def SolveInitial(self, timesteps=None, iterative: bool = True,
                     GS: bool = True, tol: float = 1e-10,
                     maxsteps: int = 100000):
        if timesteps:
            self.Project()
            for _ in range(timesteps):
                temp = jnp.where(self.free, -self.A_raw(self.u), 0.0)
                temp2, _ = self._project_velocity(self._inv_mstar(temp))
                self.u = self.u + self.timestep * temp2
                self.Project()
            return

        key = (tol, maxsteps, GS)
        if getattr(self, "_solve_key", None) != key:
            self._solve_key = key
            preA = self._preA_for(GS)

            @jax.jit
            def solve_initial(f, u_bc):
                f_mod = jnp.where(self.free, f - self.A_raw(u_bc), 0.0)
                g_mod = -self.B_raw(u_bc)
                return bramble_pasciak_cg_opt(
                    self.A, self.B, self.BT, preA, self.preM,
                    f_mod, g_mod, tol=tol, maxsteps=maxsteps, rel_err=True,
                )

            self._solve_jit = solve_initial

        timer = Timer("stokes-bpcg").Start()
        res = self._solve_jit(self.f, self.u_bc)
        timer.Stop(res.x)
        self.u = self.u_bc + res.x[0]
        self.p = res.x[1]
        self.stokes_bpcg_iterations = int(res.iterations)
        self.stokes_bpcg_time = timer.time
        return res

    def _inv_mstar(self, rhs, precision: float = 1e-4, maxsteps: int = 2000):
        return cg(self.mstar, rhs, pre=self.preMstar, tol=precision,
                  maxsteps=maxsteps).x

    def _mass_chebyshev(self, degree: int = 16):
        """Fixed-degree Chebyshev approximation of Mv^{-1}: linear fori_loop
        (no nested while_loop inside the projection CG); the projection
        stays exactly
        divergence-free for any SPD inner operator."""
        if not hasattr(self, "_mass_cheb"):
            from ..precond.chebyshev import chebyshev_preconditioner

            self._mass_cheb = chebyshev_preconditioner(
                self._Mv, self._preMv, self.u_bc, degree=degree,
                lower_fraction=0.02,
            )
        return self._mass_cheb

    def _pre_proj_twolevel(self):
        """Element-block Jacobi + vertex-P1 Laplacian coarse for the
        projection Schur complement S = B Mv^{-1} B^T.

        S is spectrally a pressure POISSON operator (Neumann at walls,
        Dirichlet-like at the outflow) whose conditioning is dominated by
        the anisotropic sliver elements near the cylinder (aspect ~400):
        measured at bench scale (round 4), projection CG takes 939 its
        with the diag-mass preconditioner, 904 with diag+coarse (the
        coarse can't see the local sliver modes), 402 with element-block
        Jacobi alone, and **26** with block + coarse.  The block is the
        ELEMENT-LOCAL Schur B_e Mloc_e^+ B_e^T (shared velocity faces
        double-counted — a factor-~2 spectral perturbation the CG
        tolerates); the coarse transfer is ONE reference-frame matrix
        (m, d+1): pressure is elementwise modal, and the L2 projection of
        a vertex-linear field onto the element basis has the same
        coefficients on every affine element.  Enclosed flows (no
        outflow) use block + demean: the pure-Neumann coarse Laplacian is
        singular.
        """
        if getattr(self, "_pre_proj2", None) is not None:
            return self._pre_proj2

        # element-block Jacobi on S (host setup, batched tiny inverses)
        B_loc = np.asarray(self._B_host, np.float64)
        M_loc = np.asarray(self._M_loc_np, np.float64)
        ne, mQ, _ = B_loc.shape
        Mpinv = np.linalg.pinv(M_loc, rcond=1e-10)
        S_blk = np.einsum("epi,eij,eqj->epq", B_loc, Mpinv, B_loc,
                          optimize=True)
        S_inv = jnp.asarray(np.linalg.pinv(S_blk, rcond=1e-8), self.dtype)

        def block(p):
            pe = p.reshape(ne, mQ)
            return jnp.einsum("epq,eq->ep", S_inv, pe).reshape(-1)

        if not self.outflow:
            def pre_enc(p):
                pd = p - jnp.mean(p)
                y = block(pd)
                return y - jnp.mean(y)

            self._pre_proj2 = pre_enc
            return self._pre_proj2

        from ..fem.quadrature import tetrahedron_rule, triangle_rule
        from ..fem.spaces import H1
        from ..precond.twolevel import coarse_p1_solver

        mesh = self.mesh
        qb = self.Q.basis
        rule = (tetrahedron_rule(2 * max(self.Q.order, 1) + 1)
                if mesh.dim == 3 else
                triangle_rule(2 * max(self.Q.order, 1) + 1))
        q_val, _ = qb.tabulate(rule.points)  # (nq, m)
        lam = np.concatenate(
            [1 - rule.points.sum(1, keepdims=True), rule.points], axis=1
        )  # (nq, d+1)
        Mref = np.einsum("q,qa,qb->ab", rule.weights, q_val, q_val)
        Tref = np.linalg.solve(
            Mref, np.einsum("q,qa,qv->av", rule.weights, q_val, lam)
        )  # (m, d+1): element coefficients of a vertex-linear field
        solve1 = coarse_p1_solver(
            H1(mesh, 1, dirichlet=self.outflow), 1.0, self.dtype
        )
        els = jnp.asarray(mesh.elements)
        Tref_j = jnp.asarray(Tref, self.dtype)
        nv = mesh.nv

        def pre(p):
            pe = p.reshape(ne, mQ)
            g = jnp.zeros(nv, p.dtype).at[els].add(
                jnp.einsum("av,ea->ev", Tref_j, pe))
            z = solve1(g)
            coarse = jnp.einsum("av,ev->ea", Tref_j, z[els]).reshape(-1)
            return block(p) + coarse

        self._pre_proj2 = pre
        return pre

    def _project_velocity(self, u, tol: float = 1e-9, maxsteps: int = 2000):
        Minv = self._mass_chebyshev()

        def S(p):
            return self.B(Minv(self.BT(p)))

        rhs = self.B_raw(u)
        pres = cg(S, rhs, pre=self._pre_proj_twolevel(), tol=tol,
                  maxsteps=maxsteps)
        return u - Minv(self.BT(pres.x)), pres.x

    def Project(self, vel=None):
        if vel is None:
            self.u, self.p = self._project_velocity(self.u)
            return None
        u_new, self.p = self._project_velocity(vel)
        return u_new

    def make_step_fn(self, project_tol: float = 1e-9,
                     mstar_tol: float = 1e-4):
        # the Chebyshev mass inverse must be CONSTRUCTED outside any jit
        # trace (its Lanczos bound needs concrete values); building it here
        # keeps model setup lazy while the returned step stays jittable.
        # ``project_tol``: relative tolerance of the divergence projection
        # CG — the default matches DoTimeStep's f64 semantics; an f32
        # stepping model must pass a reachable one (~1e-5) or the
        # projection burns its full maxsteps every step.
        self._mass_chebyshev()
        self._pre_proj_twolevel()  # host setup — must happen outside traces
        self._build_convection()  # tables as device buffers, NOT trace
        # constants: built inside a jit/make_jaxpr trace they embed in the
        # compiled module as constants
        free, f, dt = self.free, self.f, self.timestep
        conv, A_raw = self.convection, self.A_raw
        inv_mstar, project = self._inv_mstar, self._project_velocity

        def step(u):
            temp = conv(u) + f - A_raw(u)
            temp = jnp.where(free, temp, 0.0)
            temp2, _ = project(inv_mstar(temp, precision=mstar_tol),
                              tol=project_tol)
            return u + dt * temp2

        return step

    def DoTimeStep(self):
        if not hasattr(self, "_jit_step"):
            self._jit_step = jax.jit(self.make_step_fn())
        self.u = self._jit_step(self.u)

    def reconstruct_stress(self, u=None):
        """Recover the eliminated (sigma, W) fields per element:
        (sigma, W) = -Acc^{-1} A_rc^T u_loc  (homogeneous local rhs)."""
        u = self.u if u is None else u
        ue = np.asarray(u)[self.Xv.element_dofs]
        rhs = -np.einsum("eic,ei->ec", self._A_rc, ue, optimize=True)
        return np.einsum("ecd,ed->ec", self._Acc_inv, rhs, optimize=True)
