"""Navier-Stokes solver with the reference's SIMPLE-style API.

Model-level rebuild of
/root/reference/templates/NavierStokesSIMPLE_iterative.py: the class
signature, the SolveInitial / AddForce / DoTimeStep / Project methods, the
velocity/pressure properties and the recorded ``stokes_bpcg_iterations`` /
``stokes_bpcg_time`` metrics (NavierStokesSIMPLE_iterative.py:15,168,397-399,
422-444) are all preserved.

Discretization deviation (documented per SURVEY.md section 7): the reference
uses the MCS H(div) x H(curl,div) mixed-stress discretization with hybrid
facet spaces; this round uses Taylor-Hood (H1_k^dim velocity, H1_{k-1}
pressure) with grad-div stabilization — same physics, same solver structure,
same API.  The H(div)/MCS element wave upgrades the discretization in place.

Scheme structure mirrors the reference:
* SolveInitial (steady): Bramble-Pasciak CG on the Stokes saddle system
  blfA = nu * viscous + grad-div (the V_trace term, :72), preM = local
  pressure mass (:197-199), tol 1e-10 (:397).
* DoTimeStep: explicit convection + implicit Stokes step through
  mstar = M + dt * stokesA solved by inner CG at precision 1e-4 (:85-96),
  then divergence-free projection (:427-438).
* Project: L2 projection onto discretely divergence-free fields by solving
  the Schur system (B M^-1 B^T) p = B vel (:440-444).

Convection: the reference evaluates an upwind-DG convection operator on a
piola-mapped VectorL2 embedding because its H(div) velocity is tangentially
discontinuous (:106-113); with a continuous velocity the volume form
-(u . grad)u . v is the consistent equivalent, evaluated matrix-free at
quadrature points (gather -> batched einsum -> scatter), jit-fused into the
time step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.spaces import H1, VectorSpace
from ..ops import assembly as asm
from ..precond.jacobi import jacobi
from ..solvers.bpcg import bramble_pasciak_cg_opt
from ..solvers.cg import cg
from ..utils.timers import Timer

__all__ = ["NavierStokes"]


class NavierStokes:
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
        grad_div: float = 2.0,
        preconditioner: str = "twolevel",
    ):
        self.preconditioner = preconditioner
        self.nu = nu
        self.timestep = timestep
        self.uin = uin
        self.inflow = inflow
        self.outflow = outflow
        self.wall = wall
        self.mesh = mesh
        self.order = order
        self.dtype = dtype

        d = mesh.dim
        dirichlet = inflow + "|" + wall
        self.V = VectorSpace(H1(mesh, order, dirichlet=dirichlet), d)
        self.Q = H1(mesh, order - 1)
        Vs = self.V.scalar
        self.n = Vs.ndof
        self.d = d

        qd = 2 * order + 1  # exact for the trilinear convection term
        self.tu = asm.make_tables(Vs, qd, dtype)
        self.tp = asm.make_tables(self.Q, qd, dtype)
        tu, tp = self.tu, self.tp

        self.K_loc = asm.stiffness_local(tu)
        self.M_loc = asm.mass_local(tu)
        self.Mp_loc = asm.mass_local(tp)
        self.D_loc = asm.divergence_local(tp, tu)
        # grad-div local: dd[e, i, a, j, b] = int d_a(phi_i) d_b(phi_j)
        g = asm.phys_grad(tu)
        self.DD_loc = jnp.einsum("q,eqia,eqjb,e->eiajb", tu.qw, g, g, tu.detj)

        self.free_s = jnp.asarray(Vs.free_mask)
        self.grad_div = grad_div

        # rhs (AddForce accumulates, NavierStokesSIMPLE_iterative.py:422-425)
        self.f = jnp.zeros((d, self.n), dtype)
        if volumeforce is not None:
            self.AddForce(volumeforce)

        # state: velocity dof vector (d*n,), pressure (Q.ndof,)
        u_bc = self.V.interpolate_boundary(self._uin_np, self.inflow)
        self.u_bc = jnp.asarray(u_bc.reshape(d, self.n), dtype)
        self.u = self.u_bc.reshape(-1)
        self.p = jnp.zeros(self.Q.ndof, dtype)

        self.stokes_bpcg_iterations = None
        self.stokes_bpcg_time = None
        self._build_operators()
        self._mass_chebyshev()  # eager: its Lanczos bound needs concrete values

    # -- reference-API properties ------------------------------------------

    @property
    def velocity(self) -> np.ndarray:
        """(d, n) component-major velocity dof array."""
        return np.asarray(self.u).reshape(self.d, self.n)

    @property
    def pressure(self) -> np.ndarray:
        """Reference returns -gfup (NavierStokesSIMPLE_iterative.py:163-166)."""
        return -np.asarray(self.p)

    # -- operator construction ---------------------------------------------

    def _uin_np(self, p):
        out = np.asarray(self.uin(p))
        if out.ndim == 1:
            full = np.zeros((len(p), self.d))
            full[:, 0] = out
            return full
        return out

    def _build_operators(self):
        tu, tp = self.tu, self.tp
        n, d = self.n, self.d
        Vs_eldofs = tu.eldofs
        free = self.free_s
        nu = self.nu
        K_loc, M_loc, D_loc, DD_loc = self.K_loc, self.M_loc, self.D_loc, self.DD_loc
        gd = self.grad_div

        def stokesA_raw(u2):  # nu*Laplace + gd*nu*grad-div, unmasked
            y = nu * jax.vmap(
                lambda uc: asm.apply_local_matrices(K_loc, Vs_eldofs, n, uc)
            )(u2)
            if gd:
                ue = u2[:, Vs_eldofs]  # (d, ne, nb)
                loc = jnp.einsum("eiajb,bej->eia", DD_loc, ue)
                y = y + gd * nu * jax.vmap(
                    lambda l: asm.scatter_add(l, Vs_eldofs, n),
                    in_axes=2, out_axes=0,
                )(loc)
            return y

        def mass_raw(u2):
            return jax.vmap(
                lambda uc: asm.apply_local_matrices(M_loc, Vs_eldofs, n, uc)
            )(u2)

        def masked(op_raw):
            def op(u):
                u2 = u.reshape(d, n)
                uf = jnp.where(free[None], u2, 0.0)
                y = op_raw(uf)
                return jnp.where(free[None], y, u2).reshape(-1)

            return op

        self._stokesA_raw = stokesA_raw
        self._mass_raw = mass_raw
        self.A = masked(stokesA_raw)

        dt = self.timestep

        def mstar_raw(u2):
            return mass_raw(u2) + dt * stokesA_raw(u2)

        self.mstar = masked(mstar_raw)

        def B(u):
            u2 = jnp.where(free[None], u.reshape(d, n), 0.0)
            ue = u2[:, Vs_eldofs]
            pe = jnp.einsum("eijc,cej->ei", D_loc, ue)
            return asm.scatter_add(pe, tp.eldofs, self.Q.ndof)

        def B_raw(u):
            ue = u.reshape(d, n)[:, Vs_eldofs]
            pe = jnp.einsum("eijc,cej->ei", D_loc, ue)
            return asm.scatter_add(pe, tp.eldofs, self.Q.ndof)

        def BT(p):
            pe = p[tp.eldofs]
            ue = jnp.einsum("eijc,ei->cej", D_loc, pe)
            y = jax.vmap(lambda l: asm.scatter_add(l, Vs_eldofs, n))(ue)
            return jnp.where(free[None], y, 0.0).reshape(-1)

        self.B, self.B_raw, self.BT = B, B_raw, BT

        # preconditioner diagonals
        diagA = nu * asm.diagonal_of_local(K_loc, Vs_eldofs, n)
        if gd:
            dd_diag = jnp.einsum("eiaia->eia", DD_loc)
            # per-component grad-div diagonal d_a phi_i * d_a phi_i
            diagA_c = jnp.stack(
                [
                    diagA
                    + gd * nu * asm.scatter_add(dd_diag[:, :, c], Vs_eldofs, n)
                    for c in range(d)
                ]
            )
        else:
            diagA_c = jnp.broadcast_to(diagA[None], (d, n))
        diagA_c = jnp.where(free[None], diagA_c, 1.0)
        inv_diagA = 1.0 / diagA_c

        if self.preconditioner == "twolevel":
            # per-component two-level additive Schwarz (the reference's
            # MypreA structure: block smoother + order-1 H1 coarse, :310-391)
            from ..precond.twolevel import two_level_preconditioner

            pres = []
            for c in range(d):
                a_loc_c = nu * (
                    K_loc + (gd * DD_loc[:, :, c, :, c] if gd else 0.0)
                )
                pres.append(
                    two_level_preconditioner(
                        self.V.scalar, a_loc_c, coefficient=nu,
                        smoother="patch", dtype=self.dtype,
                    )
                )

            def preA(u):
                u2 = u.reshape(d, n)
                return jnp.stack([pres[c](u2[c]) for c in range(d)]).reshape(-1)

        else:

            def preA(u):
                return (inv_diagA * u.reshape(d, n)).reshape(-1)

        self.preA = preA

        diagM = asm.diagonal_of_local(M_loc, Vs_eldofs, n)
        diagMstar = diagM[None] + dt * diagA_c
        diagMstar = jnp.where(free[None], diagMstar, 1.0)
        inv_diagMstar = 1.0 / diagMstar

        def preMstar(u):
            return (inv_diagMstar * u.reshape(d, n)).reshape(-1)

        self.preMstar = preMstar

        # Schur preconditioner: viscosity-scaled pressure-mass Jacobi.
        # S = B A^-1 B^T ~ (1/nu) M_p for the viscous block, so the
        # approximate-inverse scale is nu * M_p^-1 (halves BPCG iterations
        # vs the reference's unscaled 'local' jacobi at nu=1e-3).
        diag_Mp = asm.diagonal_of_local(self.Mp_loc, tp.eldofs, self.Q.ndof)
        preM_unit = jacobi(diag_Mp)
        if not self.outflow:
            # enclosed flow (e.g. lid-driven cavity): pressure is defined up
            # to a constant — deflate the constant from the Schur block
            nq = self.Q.ndof

            def demean(p):
                return p - jnp.mean(p)

            B_enc, BT_enc = B, BT
            self.B = lambda u: demean(B_enc(u))
            self.B_raw_inner = B_raw

            def B_raw_demeaned(u):
                return demean(B_raw(u))

            self.B_raw = B_raw_demeaned
            self.BT = lambda p: BT_enc(demean(p))
            self.preM = lambda p: nu * demean(preM_unit(demean(p)))
        else:
            self.preM = lambda p: nu * preM_unit(p)

        # velocity mass (masked) + its Jacobi, for the projection Schur solve
        self.Mv = masked(mass_raw)
        diagMv = jnp.where(free[None], jnp.broadcast_to(diagM[None], (d, n)), 1.0)
        inv_diagMv = 1.0 / diagMv
        self.preMv = lambda u: (inv_diagMv * u.reshape(d, n)).reshape(-1)

        # convection: matrix-free -(u . grad)u . v at quadrature points
        val, grad_ref = tu.val, tu.grad
        jinv, detj, qw = tu.jinv, tu.detj, tu.qw

        def convection(u):
            u2 = u.reshape(d, n)
            ue = u2[:, Vs_eldofs]  # (d, ne, nb)
            uq = jnp.einsum("qi,cei->ceq", val, ue)  # values at quad pts
            gphys = jnp.einsum("eba,qib->eqia", jinv, grad_ref)
            gq = jnp.einsum("eqia,cei->ceqa", gphys, ue)  # grad u at quad pts
            conv_q = jnp.einsum("aeq,ceqa->ceq", uq, gq)  # (u . grad) u
            fe = -jnp.einsum("q,ceq,qi,e->cei", qw, conv_q, val, detj)
            y = jax.vmap(lambda l: asm.scatter_add(l, Vs_eldofs, n))(fe)
            return y.reshape(-1)

        self.convection = convection

    # -- reference API ------------------------------------------------------

    def AddForce(self, force):
        """Accumulate integral force . v into the rhs (reference :422-425).

        ``force``: callable points (n,dim) -> (n,dim)."""
        fq = force(np.asarray(self.tu.qpts).reshape(-1, self.d)).reshape(
            self.tu.qpts.shape[0], self.tu.qpts.shape[1], self.d
        )
        comps = [
            asm.scatter_add(
                asm.linear_form_local(self.tu, jnp.asarray(fq[:, :, c], self.dtype)),
                self.tu.eldofs,
                self.n,
            )
            for c in range(self.d)
        ]
        self.f = self.f + jnp.stack(comps)

    def SolveInitial(self, timesteps=None, iterative: bool = True,
                     GS: bool = True, tol: float = 1e-10,
                     maxsteps: int = 100000):
        """Steady Stokes solve (timesteps=None) or projection time-stepping
        warmup (reference :168-420).  GS selects the stronger smoother in the
        reference's aux-space preconditioner; the current preconditioner is
        Jacobi, so GS only tags the recorded metrics."""
        if timesteps:
            # projection time-stepping warmup without convection (:406-420)
            self.Project()
            for _ in range(timesteps):
                temp = jnp.where(
                    self.free_s[None],
                    -self._stokesA_raw(self.u.reshape(self.d, self.n)),
                    0.0,
                ).reshape(-1)
                temp2, _ = self._project_velocity(self._inv_mstar(temp))
                self.u = self.u + self.timestep * temp2
                self.Project()
            return

        # the ENTIRE solve — rhs transform, Lanczos scaling, CG loop — is one
        # jitted XLA program: per-op dispatch latency would otherwise
        # dominate (SURVEY.md section 3.1's Python->C++ boundary problem,
        # reborn as dispatch overhead)
        key = (tol, maxsteps)
        if getattr(self, "_solve_key", None) != key:
            self._solve_key = key

            @jax.jit
            def solve_initial(f, u_bc_flat):
                u_bc2 = u_bc_flat.reshape(self.d, self.n)
                f_mod = jnp.where(
                    self.free_s[None], f - self._stokesA_raw(u_bc2), 0.0
                ).reshape(-1)
                g_mod = -self.B_raw(u_bc_flat)
                return bramble_pasciak_cg_opt(
                    self.A, self.B, self.BT, self.preA, self.preM,
                    f_mod, g_mod, tol=tol, maxsteps=maxsteps, rel_err=True,
                )

            self._solve_initial_jit = solve_initial

        timer = Timer("stokes-bpcg").Start()
        res = self._solve_initial_jit(self.f, self.u_bc.reshape(-1))
        timer.Stop(res.x)
        self.u = self.u_bc.reshape(-1) + res.x[0]
        self.p = res.x[1]
        self.stokes_bpcg_iterations = int(res.iterations)
        self.stokes_bpcg_time = timer.time
        return res

    def _inv_mstar(self, rhs, precision: float = 1e-4, maxsteps: int = 2000):
        """CG inverse of mstar at the reference's precision 1e-4 (:93)."""
        return cg(
            self.mstar, rhs, pre=self.preMstar, tol=precision,
            maxsteps=maxsteps,
        ).x

    def _mass_chebyshev(self, degree: int = 16):
        """Fixed-degree Chebyshev approximation of Mv^{-1} (linear, SPD)."""
        if not hasattr(self, "_mass_cheb"):
            from ..precond.chebyshev import chebyshev_preconditioner

            self._mass_cheb = chebyshev_preconditioner(
                self.Mv, self.preMv, self.u_bc.reshape(-1), degree=degree,
                lower_fraction=0.02,
            )
        return self._mass_cheb

    def _project_velocity(self, u, tol: float = 1e-8, maxsteps: int = 500):
        """(u - M~^-1 B^T p, p) with (B M~^-1 B^T) p = B u.

        The divergence-free projection of the reference's Project (:440-444)
        as a Schur-complement CG.  The inner mass inverse is a FIXED-degree
        Chebyshev polynomial (a linear fori_loop, no nested CG
        while-inside-while), and the projection is exactly
        divergence-free for ANY SPD inner operator — the outer CG drives
        B u_new -> 0 regardless."""
        Minv = self._mass_chebyshev()

        def S(p):
            return self.B(Minv(self.BT(p)))

        # rhs uses the UNmasked divergence so the projected total velocity
        # (including its Dirichlet part) is discretely divergence-free; the
        # correction itself lives on free dofs only.
        rhs = self.B_raw(u)
        pres = cg(S, rhs, pre=self.preM, tol=tol, maxsteps=maxsteps)
        correction = Minv(self.BT(pres.x))
        return u - correction, pres.x

    def Project(self, vel=None):
        """Divergence-free projection; also extracts the pressure into the
        state like the reference (:441-443).  With no argument, projects the
        velocity state in place; with ``vel``, returns the projected vector."""
        if vel is None:
            self.u, self.p = self._project_velocity(self.u)
            return None
        u_new, self.p = self._project_velocity(vel)
        return u_new

    def make_step_fn(self):
        """Pure jittable time step u -> u_next (the fused DoTimeStep body).

        The whole IMEX step — convection evaluation, inner mstar CG, Schur
        projection CG — is one XLA program with zero host round-trips
        (the BASELINE.json north-star requirement)."""
        free, f, dt, d, n = self.free_s, self.f, self.timestep, self.d, self.n
        convection, stokesA_raw = self.convection, self._stokesA_raw
        inv_mstar, project = self._inv_mstar, self._project_velocity

        def step(u):
            u2 = u.reshape(d, n)
            temp = convection(u).reshape(d, n) + f - stokesA_raw(u2)
            temp = jnp.where(free[None], temp, 0.0).reshape(-1)
            temp2, _ = project(inv_mstar(temp))
            return u + dt * temp2

        return step

    def DoTimeStep(self):
        """One IMEX step (reference :427-438): explicit convection, implicit
        Stokes through mstar at precision 1e-4, then projection."""
        if not hasattr(self, "_jit_step"):
            self._jit_step = jax.jit(self.make_step_fn())
        self.u = self._jit_step(self.u)
