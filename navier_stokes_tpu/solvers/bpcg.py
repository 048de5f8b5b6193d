"""Bramble-Pasciak conjugate gradients for Stokes saddle-point systems.

Two variants, mathematically matching the reference:

* ``bramble_pasciak_cg`` — the block-matrix form of
  /root/reference/bramble_pasciak_cg.py:65-148: transform K=[[A,BT],[B,C]]
  with a scaled A-preconditioner k*preA (k = 1/lambda_min(preA A) + 1e-3 via
  Lanczos) into an SPD-in-a-nonstandard-inner-product system and run CG.

* ``bramble_pasciak_cg_opt`` — the optimized recurrence of
  /root/reference/solvers/bramblepasciak_new.py:24-253: only ONE A-apply, one
  preA-apply, one B, one B^T and one preM per iteration, with the
  ``matA_s = beta*matA_s + z_old - alpha*tmp2`` recurrence amortizing A*s.

Both run as single fused ``lax.while_loop``s on device.  The reference
crosses the Python->C++ boundary ~8x per iteration (SURVEY.md section 3.1);
here an iteration is one XLA program.

Operators are callables on single-block vectors; block vectors are (u, p)
tuples handled with pytree algebra.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..linalg.lanczos import lanczos_eigenvalues
from ..linalg.pytree import taxpy, tdot, tscale, tsub, tzeros_like
from .cg import SolverResult


def _tadd(a, b):
    return jax.tree_util.tree_map(jnp.add, a, b)


def bp_scale_factor(A, preA, example_u, lanczos_iterations: int = 40, key=None,
                    safety: float = 0.2):
    """k = (1+safety)/lambda_min(preA A) + 1e-3 and the condition estimate
    (bramble_pasciak_cg.py:70-74).

    The reference uses the bare ``1/lambda_min + 1e-3`` — safe there because
    NGSolve's EigenValues_Preconditioner iterates to tolerance.  Our
    fixed-iteration Lanczos can OVERestimate lambda_min by a few percent
    (Ritz values converge from above); any overestimate makes the
    Bramble-Pasciak inner-product matrix A - k^{-1}... indefinite and the
    iteration visibly stalls (observed on the 3D MCS skeleton
    preconditioner: stall at 4e-3 with +1e-3, clean convergence with a 10%
    multiplicative margin).  The extra margin costs only a few iterations
    (measured 221 -> 231 between 1.1x and 1.3x), so 1.2x is cheap
    insurance."""
    lams = lanczos_eigenvalues(A, preA, example_u, lanczos_iterations, key)
    lmin, lmax = jnp.min(lams), jnp.max(lams)
    k = (1.0 + safety) / lmin + 1e-3
    return k, lmax / lmin


def bramble_pasciak_cg(
    A, B, BT, preA, preM, f, g, C=None, sol=None,
    tol: float = 1e-12, max_steps: int = 1000,
    scale_k=None, lanczos_iterations: int = 40,
) -> SolverResult:
    """BPCG v1 on K = [[A, BT], [B, C]] (C optional, typically None).

    ``scale_k``: precomputed Bramble-Pasciak scaling; computed via Lanczos
    when None.  Solves for (u, p) with the same iteration/stopping/error
    semantics as the reference: errors[i] = err_i/err_0 recorded at the top
    of each iteration, stop when err < tol * err0.
    """
    if scale_k is None:
        scale_k, _ = bp_scale_factor(A, preA, f, lanczos_iterations)

    preAs = lambda u: tscale(scale_k, preA(u))
    Cop = C if C is not None else (lambda p: tzeros_like(p))

    def K(x):
        u, p = x
        return (_tadd(A(u), BT(p)), _tadd(B(u), Cop(p)))

    def PA_full(x):  # [[k*preA, 0], [0, I]]
        return (preAs(x[0]), x[1])

    def AB(x):  # [[A, 0], [B, 0]]
        return (A(x[0]), B(x[0]))

    def PS_full_B(x):  # [[I,0],[0,preM]] @ [[I,0],[B,-I]]
        return (x[0], preM(tsub(B(x[0]), x[1])))

    rhs = (f, g)
    if sol is None:
        sol = tzeros_like(rhs)

    t2 = tsub(rhs, K(sol))
    apr = PA_full(t2)
    res = tsub(AB(apr), t2)
    t1 = PS_full_B(apr)
    p = t1
    rho = tdot(t1, res)
    dtype = rho.dtype
    err0 = jnp.sqrt(jnp.abs(rho))

    errors = jnp.full(max_steps + 1, jnp.nan, dtype)

    def cond(c):
        sol, res, apr, p, rho, it, errors = c
        err = jnp.sqrt(jnp.abs(rho))
        return (err >= tol * err0) & (it < max_steps)

    def body(c):
        sol, res, apr, p, rho, it, errors = c
        errors = errors.at[it].set(jnp.sqrt(jnp.abs(rho)) / err0)
        t1 = tscale(-1.0, K(p))
        t2 = tscale(-1.0, PA_full(t1))
        t1 = _tadd(t1, AB(t2))
        alpha = rho / tdot(p, t1)
        sol = taxpy(alpha, p, sol)
        res = taxpy(-alpha, t1, res)
        apr = taxpy(-alpha, t2, apr)
        t1 = PS_full_B(apr)
        rho_new = tdot(t1, res)
        beta = rho_new / rho
        p = taxpy(beta, p, t1)
        return (sol, res, apr, p, rho_new, it + 1, errors)

    init = (sol, res, apr, p, rho, jnp.zeros((), jnp.int32), errors)
    sol, res, apr, p, rho, it, errors = jax.lax.while_loop(cond, body, init)
    err = jnp.sqrt(jnp.abs(rho))
    errors = errors.at[it].set(err / err0)  # final entry, as the reference does
    return SolverResult(x=sol, iterations=it, errors=errors, err0=err0,
                        converged=err < tol * err0)


def bramble_pasciak_cg_opt(
    A, B, BT, preA, preM, f, g, sol=None,
    tol: float = 1e-6, maxsteps: int = 100, rel_err: bool = True,
    scale_k=None, lanczos_iterations: int = 40,
    accum_dtype=None,
    resume=None, return_state: bool = False, max_new_iterations=None,
) -> SolverResult:
    """Optimized BPCG (one A/preA/B/BT/preM apply per iteration).

    Mathematically equivalent to
    /root/reference/solvers/bramblepasciak_new.py:24-253 without static
    condensation (harmonic extension degenerates to preA itself when the
    bilinear form is not condensed, bramblepasciak_new.py:19-21).

    ``accum_dtype``: optional wider dtype (jnp.float64) for the two global
    inner products per iteration — the dominant rounding source of f32
    Krylov loops; O(n) extra emulated-f64 work per iteration against the
    O(n * block^2) matvecs.

    Chunked execution (to bound the length of one device execution, e.g.
    to report progress between chunks): pass ``return_state=True`` to also
    get an opaque resume pytree,
    ``max_new_iterations=N`` to bound the iterations of THIS call, and
    ``resume=state`` to continue a previous call EXACTLY (same recurrence
    carries — no restart penalty), with ``scale_k`` required on resume.
    """
    if scale_k is None:
        scale_k, _ = bp_scale_factor(A, preA, f, lanczos_iterations)
    preAs = lambda u: tscale(scale_k, preA(u))
    if accum_dtype is not None:
        def tdot_acc(x, y):
            return tdot(
                jax.tree_util.tree_map(lambda v: v.astype(accum_dtype), x),
                jax.tree_util.tree_map(lambda v: v.astype(accum_dtype), y),
            )
    else:
        tdot_acc = tdot

    vdt0 = jax.tree_util.tree_leaves(f)[0].dtype
    if resume is None:
        # rhs transform: f_new = A preA f - f ; g_new = B preA f - g
        tmp0 = preAs(f)
        f_new = tsub(A(tmp0), f)
        g_new = tsub(B(tmp0), g)
        rhs = (f_new, g_new)

        u = tzeros_like(rhs) if sol is None else sol

        # initial residual d = rhs - K_transformed u  (bramblepasciak_new.py:160-170)
        t0 = _tadd(A(u[0]), BT(u[1]))
        t1 = preAs(t0)
        t2 = A(t1)
        t4 = tsub(t1, u[0])
        t3 = B(t4)
        d = (tsub(rhs[0], tsub(t2, t0)), tsub(rhs[1], t3))

        # preconditioned residual w (bramblepasciak_new.py:172-183)
        pr0 = preAs(f)
        pr1 = preM(tsub(B(pr0), g))
        w = (tsub(pr0, t1), tsub(pr1, preM(t3)))

        wdn = tdot_acc(w, d)
        dtype = wdn.dtype  # accumulation dtype
        vdt = vdt0
        err0 = jnp.sqrt(jnp.abs(wdn))
        errors = jnp.full(maxsteps + 1, jnp.nan, dtype)
        s = w
        threshold = tol * jnp.where(rel_err, err0, 1.0)

        # first half-iteration pulled out of the loop so the recurrence
        # ``matA_s = beta*matA_s + z_old - alpha*tmp2`` has valid carries
        matA_s = A(s[0])
        z0 = matA_s

        state = dict(
            u=u, d=d, w=w, s=s, wdn=wdn, matA_s=matA_s, z0=z0,
            z_old=tzeros_like(z0), tmp2=tzeros_like(z0),
            alpha=jnp.zeros((), vdt), beta=jnp.zeros((), vdt),
            it=jnp.zeros((), jnp.int32), errors=errors,
            done=jnp.zeros((), bool),
        )
    else:
        state = dict(resume)
        err0 = state.pop("err0")
        threshold = tol * jnp.where(rel_err, err0, 1.0)
        vdt = vdt0

    it_start = state["it"]
    if max_new_iterations is None:
        it_stop = maxsteps
    else:
        it_stop = jnp.minimum(it_start + max_new_iterations, maxsteps)

    def cond(st):
        return jnp.logical_not(st["done"]) & (st["it"] < it_stop)

    def body(st):
        first = st["it"] == 0
        matA_s = jax.tree_util.tree_map(
            lambda ms, zo, t2v: jnp.where(
                first, ms, st["beta"] * ms + zo - st["alpha"] * t2v
            ),
            st["matA_s"], st["z_old"], st["tmp2"],
        )
        s = st["s"]
        matB_s1 = BT(s[1])
        t0 = _tadd(matA_s, matB_s1)
        t1 = preAs(t0)
        t2 = A(t1)
        t4 = tsub(t1, s[0])
        t3 = B(t4)
        z_old = st["z0"]
        v = (tsub(t2, t0), t3)

        wd = st["wdn"]
        as_s = tdot_acc(s, v)
        alpha = (wd / as_s).astype(vdt)
        u = taxpy(alpha, s, st["u"])
        d = taxpy(-alpha, v, st["d"])
        w = (
            taxpy(-alpha, t1, st["w"][0]),
            taxpy(-alpha, preM(t3), st["w"][1]),
        )
        wdn = tdot_acc(w, d)
        beta = (wdn / wd).astype(vdt)
        z0 = taxpy(-alpha, t2, st["z0"])
        s = _tadd(tscale(beta, s), w)

        err = jnp.sqrt(jnp.abs(wd))
        errors = st["errors"].at[st["it"]].set(err / err0)
        done = err < threshold
        return dict(
            u=u, d=d, w=w, s=s, wdn=wdn, matA_s=matA_s, z0=z0, z_old=z_old,
            tmp2=t2, alpha=alpha, beta=beta, it=st["it"] + 1, errors=errors,
            done=done,
        )

    st = jax.lax.while_loop(cond, body, state)
    res = SolverResult(
        x=st["u"], iterations=st["it"] - 1, errors=st["errors"], err0=err0,
        converged=st["done"],
    )
    if return_state:
        out_state = dict(st)
        out_state["err0"] = err0
        return res, out_state
    return res
