"""Mixed-precision iterative refinement for saddle-point solves.

The route to the north-star tolerance (relative residual 1e-8,
BASELINE.md) is classic iterative refinement: inner Krylov solves in
float32, which streams half the bytes of float64 through the
bandwidth-bound table applies, and outer residuals and accumulation in
float64 — each pass gains ~5-6 digits, so two to three f32 solves replace
one f64 solve.

The whole refinement loop (outer f64 residuals + inner f32 BPCG
while-loops) is one jitted program.
"""

from __future__ import annotations

import os as _os

import jax
import jax.numpy as jnp

from ..utils.jaxtools import device_tables_enabled
from .bpcg import bramble_pasciak_cg_opt


def mixed_precision_saddle_solve(
    ops64: dict,
    ops32: dict,
    f,
    g,
    tol: float = 1e-8,
    inner_tol: float = 1e-6,
    inner_maxsteps: int = 2000,
    max_refine: int = 6,
    scale_k: float | None = None,
):
    """Solve [[A, B^T], [B, 0]] (x0, x1) = (f, g) to f64 relative residual
    ``tol``.

    ``ops64`` / ``ops32``: dicts with callables A, B, BT, preA, preM acting
    in the respective dtype.  ``scale_k``: Bramble-Pasciak scaling for the
    inner solver; estimated once (in f32) when None.

    Returns (x, rel_residual, refinement_steps, total_inner_iterations).
    """
    if scale_k is None:
        from .bpcg import bp_scale_factor

        scale_k, _ = bp_scale_factor(
            ops32["A"], ops32["preA"], f.astype(jnp.float32)
        )
    scale_k = jnp.asarray(scale_k, jnp.float32)

    A64, B64, BT64 = ops64["A"], ops64["B"], ops64["BT"]
    rhs_norm = jnp.sqrt(jnp.vdot(f, f) + jnp.vdot(g, g))

    def residual(x):
        r0 = f - A64(x[0]) - BT64(x[1])
        r1 = g - B64(x[0])
        return r0, r1

    def rel(r0, r1):
        return jnp.sqrt(jnp.vdot(r0, r0) + jnp.vdot(r1, r1)) / rhs_norm

    def body(carry):
        x, r_old, steps, inner_total, _ = carry
        r0, r1 = residual(x)
        res = bramble_pasciak_cg_opt(
            ops32["A"], ops32["B"], ops32["BT"], ops32["preA"], ops32["preM"],
            r0.astype(jnp.float32), r1.astype(jnp.float32),
            tol=inner_tol, maxsteps=inner_maxsteps, scale_k=scale_k,
        )
        x_new = (
            x[0] + res.x[0].astype(jnp.float64),
            x[1] + res.x[1].astype(jnp.float64),
        )
        r0n, r1n = residual(x_new)
        r_new = rel(r0n, r1n)
        # monotonicity guard: a failed/diverged inner pass (e.g. the f32
        # floor on badly conditioned meshes) must not poison the iterate —
        # reject non-improving updates and stop
        improved = r_new < r_old
        x = jax.tree_util.tree_map(
            lambda new, old: jnp.where(improved, new, old), x_new, x
        )
        r = jnp.where(improved, r_new, r_old)
        return x, r, steps + 1, inner_total + res.iterations, ~improved

    def cond(carry):
        _, r, steps, _, stalled = carry
        return (r > tol) & (steps < max_refine) & jnp.logical_not(stalled)

    x0 = (jnp.zeros_like(f), jnp.zeros_like(g))
    r0, r1 = residual(x0)
    init = (
        x0, rel(r0, r1), jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32), jnp.zeros((), bool),
    )
    x, r, steps, inner_total, _ = jax.lax.while_loop(cond, body, init)
    return x, r, steps, inner_total


def _equilibrated_split_device(A64p, De_fb_np, chunk_bytes: float = 5e8):
    """Jacobi-equilibrated hi/lo f32 split of the face-major condensed
    table, derived ON DEVICE from the model's already-uploaded f64 table.

    The host path makes 4-5 full single-core numpy passes over the
    GB-scale table (equilibrate, permute, two casts) and then uploads both
    f32 products.  Here the only upload is the (ne, nb) scale table
    (~12 MB); the f64 elementwise work runs chunked on device.  Buffer
    donation keeps the peak at one extra f64 chunk + the two f32
    outputs.

    Returns (A_hi, A_lo): f32 device arrays, face-major, with
    hi + lo == D A D to ~2^-48 relative.
    """
    import os as _os2
    import sys as _sys2
    import time as _time2
    from functools import partial

    _t0 = _time2.perf_counter()

    def _plog(msg):
        if _os2.environ.get("NSTPU_SETUP_LOG"):
            print(f"      [split] {msg} {_time2.perf_counter() - _t0:.1f}s",
                  file=_sys2.stderr, flush=True)

    ne, nb, _ = A64p.shape
    De_dev = jnp.asarray(De_fb_np, jnp.float64)
    _plog("De upload")

    @partial(jax.jit, donate_argnums=(0, 1))
    def write(hi_buf, lo_buf, Ac, Dc, i0):
        Asp = Ac * Dc[:, :, None] * Dc[:, None, :]
        # the f32-rounded value, kept in f64 by reduce_precision: XLA's GPU
        # compiler may drop an f64->f32->f64 convert round trip (excess
        # precision is allowed by default), which would make lo zero
        hi64 = jax.lax.reduce_precision(Asp, exponent_bits=8,
                                        mantissa_bits=23)
        hi = hi64.astype(jnp.float32)
        lo = (Asp - hi64).astype(jnp.float32)
        z = jnp.zeros((), i0.dtype)
        return (
            jax.lax.dynamic_update_slice(hi_buf, hi, (i0, z, z)),
            jax.lax.dynamic_update_slice(lo_buf, lo, (i0, z, z)),
        )

    chunk = max(1, int(chunk_bytes / max(1, nb * nb * 8)))
    hi = jnp.zeros((ne, nb, nb), jnp.float32)
    lo = jnp.zeros((ne, nb, nb), jnp.float32)
    A64p = jnp.asarray(A64p, jnp.float64)
    for c0 in range(0, ne, chunk):
        c1 = min(ne, c0 + chunk)
        hi, lo = write(hi, lo, A64p[c0:c1], De_dev[c0:c1],
                       jnp.asarray(c0, jnp.int32))
        _plog(f"chunk {c0}:{c1}")
    jax.block_until_ready(hi)
    _plog("split done")
    return hi, lo


def equilibrated_f32_ops(m, gs: bool = False, split: bool = False,
                         with_ds: bool = False):
    """Jacobi-equilibrated float32 operator bundle for a 3D MCS model.

    The condensed MCS matrix on sliver-heavy meshes spans a dynamic range
    far beyond float32 (measured 1.5e16 on the extruded 3D channel —
    element aspect ratios up to ~400 near the cylinder), so a straight f32
    cast of the operator destroys the Bramble-Pasciak iteration: its
    internal error measure keeps decreasing while the true residual
    diverges.  Symmetric diagonal (Jacobi) equilibration A~ = D A D with
    D = diag(A)^{-1/2} brings the range to O(kappa_local) and restores the
    ~1e-4 f32 true-residual floor.

    Returns (ops32, D): ops32 = dict(A, B, BT, preA, preM) acting on the
    SCALED velocity variables u~ = D^{-1} u (pressure unscaled), and D as
    a float64 jnp vector.  Residual mapping for refinement: r~0 = D r0,
    r~1 = r1; solution mapping dx0 = D dx~0.
    """
    import sys as _sys
    import time as _time

    import numpy as np

    from ..models.auxspace3d import build_skeleton_preconditioner_3d
    from ..ops import assembly as asm

    _t0 = _time.perf_counter()

    def _plog(msg):
        if _os.environ.get("NSTPU_SETUP_LOG"):
            print(f"    [ops] {msg} {_time.perf_counter() - _t0:.1f}s",
                  file=_sys.stderr, flush=True)

    A_loc = m.A_cond_np
    eldofs = np.asarray(m.Xv.element_dofs)
    d = np.zeros(m.n)
    # reads only the DIAGONAL of the host table (a strided view, ~nb/ne-th
    # of the bytes)
    np.add.at(d, eldofs.ravel(), np.einsum("eii->ei", A_loc).ravel())
    # host free mask: no device->host copy of m.free
    free = np.asarray(m.Xv.free_mask)
    D = np.ones(m.n)
    D[free] = 1.0 / np.sqrt(np.maximum(np.abs(d[free]), 1e-300))
    De = D[eldofs]

    f32 = jnp.float32
    free_j = jnp.asarray(free)
    n, nQ = m.n, m.Q.ndof
    ops_ds = None

    # DEVICE-DERIVED operator tables: equilibrate and hi/lo-split the
    # model's ALREADY-UPLOADED f64 face-major table on device instead of
    # making 4-5 single-core host passes over the GB-scale numpy table and
    # uploading the products.  Same gate as auxspace3d (the skeleton Schur
    # is derived on device from the same split, see _build_skeleton_fast).
    dev_split = (
        getattr(m, "fb", None) is not None
        and getattr(m, "_A_cond", None) is not None
        # the lo part of the split is real only off an f64 master table
        and jnp.dtype(m._A_cond.dtype) == jnp.dtype(jnp.float64)
        and device_tables_enabled()
    )
    A_s = None
    if not dev_split:
        A_s = A_loc * De[:, :, None] * De[:, None, :]
        _plog("host equilibration")

    if getattr(m, "fb", None) is not None:
        # scatter-free face-block applies (ops/faceblock.py); the split
        # (compensated) variant shares ONE gather/scatter round trip across
        # the hi/lo matvecs
        lay = m.fb
        if dev_split:
            A_hi_np, A_lo_np = _equilibrated_split_device(
                m._A_cond, np.ascontiguousarray(De[:, lay.perm]))
            _plog("device equilibrated split")
        else:
            A_sp = lay.permute_blocks(A_s)
            _plog("A permute")
            A_hi_np = A_sp.astype(np.float32)
            A_lo_np = (A_sp - A_hi_np.astype(np.float64)).astype(np.float32)
            _plog("A split tables built")
        mats_np = [A_hi_np] + ([A_lo_np] if split else [])
        _A32 = lay.elem_apply_multi([(jnp.asarray(A), None) for A in mats_np])

        def A32(u):
            uf = jnp.where(free_j, u, 0.0)
            return jnp.where(free_j, _A32(uf), u)

        # host copy of B: no device->host copy of the device table
        B_np = getattr(m, "_B_host", None)
        if B_np is None:
            B_np = np.asarray(m._B_loc, np.float64)
        B_sp = (np.asarray(B_np, np.float64) * De[:, None, :])[
            :, :, lay.perm
        ]
        B_hi_np = B_sp.astype(np.float32)
        B_hi = jnp.asarray(B_hi_np)
        B_lo = jnp.asarray(
            (B_sp - B_hi_np.astype(np.float64)).astype(np.float32))
        mats_B = [B_hi]
        if split:
            mats_B.append(B_lo)
        _B32, _BT32 = lay.rect_apply_multi(mats_B, m.Q.element_dofs, nQ)
        _plog("A/B applies built")

        def B32(u):
            return _B32(jnp.where(free_j, u, 0.0))

        def BT32(p):
            return jnp.where(free_j, _BT32(p), 0.0)

        if with_ds:
            # true-f64 operators on the SAME equilibrated system — the
            # phase-2 polish path.  A plain 3x-f32 double-single apply
            # floors ~1e-6 under the condensed operator's row
            # cancellation; the recombined f64 tables hold ~2^-48.
            _A_ds = lay.elem_apply_comp(A_hi_np, A_lo_np)
            _B_ds, _BT_ds = lay.rect_apply_comp(
                B_sp.astype(np.float32),
                (B_sp - B_sp.astype(np.float32).astype(np.float64)
                 ).astype(np.float32),
                m.Q.element_dofs, nQ,
            )

            def A_ds(u):
                uf = jnp.where(free_j, u, 0.0)
                return jnp.where(free_j, _A_ds(uf), u)

            def B_ds(u):
                return _B_ds(jnp.where(free_j, u, 0.0))

            def BT_ds(p):
                return jnp.where(free_j, _BT_ds(p), 0.0)

            ops_ds = dict(A=A_ds, B=B_ds, BT=BT_ds)
            _plog("f64 phase-2 applies built")

    else:
        assert not with_ds, "double-single ops need the face-block layout"
        B_s = np.asarray(m._B_loc, np.float64) * De[:, None, :]
        eldofs_j = jnp.asarray(eldofs)
        eldofs_p = jnp.asarray(m.Q.element_dofs)
        A_sj = jnp.asarray(A_s, f32)
        B_sj = jnp.asarray(B_s, f32)

        if split:
            # compensated (split-matrix) matvec: A ~ hi + lo with
            # hi = f32(A), lo = f32(A - hi).  Two f32 GEMM passes represent
            # the OPERATOR to ~f32^2 accuracy, removing the
            # e_f32 * kappa(A32) representation error that floors plain-f32
            # iterative refinement (~1e-4 observed on the 3D channel).
            A_lo = jnp.asarray(A_s - np.asarray(A_sj, np.float64), f32)

            def A32(u):
                uf = jnp.where(free_j, u, 0.0)
                y = asm.apply_local_matrices(A_sj, eldofs_j, n, uf)
                y = y + asm.apply_local_matrices(A_lo, eldofs_j, n, uf)
                return jnp.where(free_j, y, u)

            B_lo = jnp.asarray(B_s - np.asarray(B_sj, np.float64), f32)

            def B32(u):
                ue = jnp.where(free_j, u, 0.0)[eldofs_j]
                pe = jnp.einsum("epi,ei->ep", B_sj, ue) + jnp.einsum(
                    "epi,ei->ep", B_lo, ue
                )
                return asm.scatter_add(pe, eldofs_p, nQ)

            def BT32(p):
                pe = p[eldofs_p]
                ue = jnp.einsum("epi,ep->ei", B_sj, pe) + jnp.einsum(
                    "epi,ep->ei", B_lo, pe
                )
                return jnp.where(
                    free_j, asm.scatter_add(ue, eldofs_j, n), 0.0
                )

        else:

            def A32(u):
                uf = jnp.where(free_j, u, 0.0)
                y = asm.apply_local_matrices(A_sj, eldofs_j, n, uf)
                return jnp.where(free_j, y, u)

            def B32(u):
                ue = jnp.where(free_j, u, 0.0)[eldofs_j]
                pe = jnp.einsum("epi,ei->ep", B_sj, ue)
                return asm.scatter_add(pe, eldofs_p, nQ)

            def BT32(p):
                pe = p[eldofs_p]
                ue = jnp.einsum("epi,ep->ei", B_sj, pe)
                return jnp.where(
                    free_j, asm.scatter_add(ue, eldofs_j, n), 0.0
                )

    # NSTPU_SMOOTHER_BF16 stores smoother tables in bfloat16 (f32
    # arithmetic) — comma-separated tokens select table GROUPS:
    #   "ext"    harmonic-extension + interior tables (applied once per
    #            preA; measured iteration-count-neutral — bench default)
    #   "panels" GS residual row panels (the dominant sweep stream,
    #            3 full-S equivalents per direction)
    #   "inv"    edge-star inverse tables inside the GS color solves
    #   "sweep"  the full skeleton S apply (coarse residual + damping)
    #   "1"      everything (legacy; measured ~2x the Krylov iterations
    #            on the 3D channel BEFORE the groups were separable)
    bf = _os.environ.get("NSTPU_SMOOTHER_BF16", "")
    toks = {t for t in bf.replace(" ", "").split(",") if t} - {"0"}
    if "1" in toks or bf == "1":
        toks |= {"ext", "panels", "inv", "sweep"}
    b16 = jnp.bfloat16

    def _pick(tok):
        return b16 if tok in toks else f32

    _plog("pre-skeleton")
    # device split: the preconditioner's Schur derivation runs on device
    # from the hi table (the lo part is a ~2^-24-relative correction — far
    # below the f32 storage rounding of the derived tables)
    preA32 = build_skeleton_preconditioner_3d(
        m.Xv, A_hi_np if dev_split else A_s, m._dirich, f32,
        coarse_coefficient=m.nu, gs=gs,
        dof_scale=D, store_dtype=_pick("sweep"),
        ext_store_dtype=_pick("ext"), panel_store_dtype=_pick("panels"),
        inv_store_dtype=_pick("inv"),
    )
    _plog("skeleton preconditioner built")
    diag_Mp32 = jnp.asarray(m._diag_Mp, f32)
    nu32 = jnp.asarray(m.nu, f32)
    preM32 = lambda p: nu32 * p / diag_Mp32

    ops32 = dict(A=A32, B=B32, BT=BT32, preA=preA32, preM=preM32)
    if with_ds:
        return ops32, jnp.asarray(D), ops_ds
    return ops32, jnp.asarray(D)


def mixed_precision_saddle_solve_scaled(
    ops64: dict,
    ops32: dict,
    D,
    f,
    g,
    tol: float = 1e-8,
    inner_tol: float = 1e-4,
    inner_maxsteps: int = 4000,
    max_refine: int = 8,
    scale_k: float | None = None,
):
    """``mixed_precision_saddle_solve`` for a Jacobi-equilibrated f32 inner
    system (see ``equilibrated_f32_ops``): inner rhs (D r0, r1), inner
    solution mapped back by D."""
    if scale_k is None:
        from .bpcg import bp_scale_factor

        scale_k, _ = bp_scale_factor(
            ops32["A"], ops32["preA"], (D * f).astype(jnp.float32)
        )
    scale_k = jnp.asarray(scale_k, jnp.float32)

    A64, B64, BT64 = ops64["A"], ops64["B"], ops64["BT"]
    rhs_norm = jnp.sqrt(jnp.vdot(f, f) + jnp.vdot(g, g))

    def residual(x):
        r0 = f - A64(x[0]) - BT64(x[1])
        r1 = g - B64(x[0])
        return r0, r1

    def rel(r0, r1):
        return jnp.sqrt(jnp.vdot(r0, r0) + jnp.vdot(r1, r1)) / rhs_norm

    def body(carry):
        x, r_old, steps, inner_total, _ = carry
        r0, r1 = residual(x)
        res = bramble_pasciak_cg_opt(
            ops32["A"], ops32["B"], ops32["BT"], ops32["preA"], ops32["preM"],
            (D * r0).astype(jnp.float32), r1.astype(jnp.float32),
            tol=inner_tol, maxsteps=inner_maxsteps, scale_k=scale_k,
        )
        x_new = (
            x[0] + D * res.x[0].astype(jnp.float64),
            x[1] + res.x[1].astype(jnp.float64),
        )
        r0n, r1n = residual(x_new)
        r_new = rel(r0n, r1n)
        improved = r_new < r_old
        x = jax.tree_util.tree_map(
            lambda new, old: jnp.where(improved, new, old), x_new, x
        )
        r = jnp.where(improved, r_new, r_old)
        return x, r, steps + 1, inner_total + res.iterations, ~improved

    def cond(carry):
        _, r, steps, _, stalled = carry
        return (r > tol) & (steps < max_refine) & jnp.logical_not(stalled)

    x0 = (jnp.zeros_like(f), jnp.zeros_like(g))
    r0, r1 = residual(x0)
    init = (
        x0, rel(r0, r1), jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32), jnp.zeros((), bool),
    )
    x, r, steps, inner_total, _ = jax.lax.while_loop(cond, body, init)
    return x, r, steps, inner_total


def mixed_precision_minres_refinement(
    ops64: dict,
    ops32: dict,
    D,
    f,
    g,
    tol: float = 1e-8,
    inner_maxsteps: int = 800,
    inner_tol: float = 1e-5,
    max_refine: int = 8,
    abs_test: bool = True,
):
    """Refinement with float32 MINRES inner solves on the equilibrated
    saddle system.

    ``abs_test=False`` drops the inner MINRES's absolute stopping test
    (reference dual-test semantics): on the shrinking per-pass rhs the
    absolute test fires early and floors the driver near ~4e-7, so deep-
    tolerance callers (the sharded production solve) disable it; the
    default keeps it, which stops inner passes as soon as the ABSOLUTE
    preconditioned residual clears the target — measurably fewer inner
    iterations on moderate tolerances (the bench-guard economy).

    The Bramble-Pasciak transform computes (A preA - I)-type differences;
    with an effective preconditioner those cancel catastrophically in
    float32 (measured: internal BPCG error 1e-4 while the true residual
    DIVERGES on the 3D channel).  Preconditioned MINRES on the block system
    [[A, B^T], [B, 0]] with the block-diagonal preconditioner
    [[preA, 0], [0, preM]] has no such cancellation: the f32 true-residual
    floor per solve is ~1e-3 and stable (no drift), so three to four
    refinement passes reach 1e-8.
    """
    from .minres import minres

    A64, B64, BT64 = ops64["A"], ops64["B"], ops64["BT"]
    rhs_norm = jnp.sqrt(jnp.vdot(f, f) + jnp.vdot(g, g))

    def K32(x):
        u, p = x
        return (ops32["A"](u) + ops32["BT"](p), ops32["B"](u))

    def pre32(x):
        return (ops32["preA"](x[0]), ops32["preM"](x[1]))

    def residual(x):
        r0 = f - A64(x[0]) - BT64(x[1])
        r1 = g - B64(x[0])
        return r0, r1

    def rel(r0, r1):
        return jnp.sqrt(jnp.vdot(r0, r0) + jnp.vdot(r1, r1)) / rhs_norm

    def body(carry):
        x, r_old, steps, inner_total, _ = carry
        r0, r1 = residual(x)
        res = minres(
            K32, ((D * r0).astype(jnp.float32), r1.astype(jnp.float32)),
            pre=pre32, tol=inner_tol, maxsteps=inner_maxsteps,
            abs_test=abs_test,
        )
        x_new = (
            x[0] + D * res.x[0].astype(jnp.float64),
            x[1] + res.x[1].astype(jnp.float64),
        )
        r0n, r1n = residual(x_new)
        r_new = rel(r0n, r1n)
        improved = r_new < r_old
        x = jax.tree_util.tree_map(
            lambda new, old: jnp.where(improved, new, old), x_new, x
        )
        r = jnp.where(improved, r_new, r_old)
        return x, r, steps + 1, inner_total + res.iterations, ~improved

    def cond(carry):
        _, r, steps, _, stalled = carry
        return (r > tol) & (steps < max_refine) & jnp.logical_not(stalled)

    x0 = (jnp.zeros_like(f), jnp.zeros_like(g))
    r0, r1 = residual(x0)
    init = (
        x0, rel(r0, r1), jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32), jnp.zeros((), bool),
    )
    x, r, steps, inner_total, _ = jax.lax.while_loop(cond, body, init)
    return x, r, steps, inner_total


def mixed_precision_minres_refinement_2phase(
    ops64: dict,
    ops32: dict,
    D,
    f,
    g,
    tol: float = 1e-8,
    inner_maxsteps: int = 800,
    inner_tol: float = 1e-5,
    max_refine: int = 8,
    p2_inner_tol: float = 1e-4,
    p2_inner_maxsteps: int = 600,
    max_p2: int = 6,
    abs_test: bool = False,
):
    """``mixed_precision_minres_refinement`` plus the bench's phase-2
    endgame (bench.py full_solve): once the f32 passes stall near their
    ~4e-7 true-residual floor, continue with MINRES refinement passes on
    the EQUILIBRATED correction system (D A D) dz = D r using the true
    f64 operators from ``ops64`` and f32 casts of the phase-1
    preconditioner.  Posed on the residual, every quantity scales with
    ||r||, so the f32 preconditioner noise stays RELATIVE and each pass
    contracts the true residual to the 1e-8 target (the sharded dryrun
    certifies the production tolerance, not an f32-floor prefix).
    ``abs_test`` is the phase-1 inner MINRES's absolute stopping test
    (see :func:`mixed_precision_minres_refinement`).

    The bench's phase 2 applies the same f64 operators through the
    recombined equilibrated tables (ops/faceblock.elem_apply_comp).

    Returns (x, rel_residual, (p1_passes, p2_passes), total_inner).
    """
    from .minres import minres

    A64, B64, BT64 = ops64["A"], ops64["B"], ops64["BT"]
    rhs_norm = jnp.sqrt(jnp.vdot(f, f) + jnp.vdot(g, g))
    preA32, preM32 = ops32["preA"], ops32["preM"]

    def K32(x):
        u, p = x
        return (ops32["A"](u) + ops32["BT"](p), ops32["B"](u))

    def pre32(x):
        return (preA32(x[0]), preM32(x[1]))

    def residual(x):
        r0 = f - A64(x[0]) - BT64(x[1])
        r1 = g - B64(x[0])
        return r0, r1

    def rel(r0, r1):
        return jnp.sqrt(jnp.vdot(r0, r0) + jnp.vdot(r1, r1)) / rhs_norm

    def body1(carry):
        x, r_old, steps, inner_total, _ = carry
        r0, r1 = residual(x)
        res = minres(
            K32, ((D * r0).astype(jnp.float32), r1.astype(jnp.float32)),
            pre=pre32, tol=inner_tol, maxsteps=inner_maxsteps,
            abs_test=abs_test,
        )
        x_new = (
            x[0] + D * res.x[0].astype(jnp.float64),
            x[1] + res.x[1].astype(jnp.float64),
        )
        r0n, r1n = residual(x_new)
        r_new = rel(r0n, r1n)
        improved = r_new < r_old
        x = jax.tree_util.tree_map(
            lambda new, old: jnp.where(improved, new, old), x_new, x
        )
        r = jnp.where(improved, r_new, r_old)
        return x, r, steps + 1, inner_total + res.iterations, ~improved

    def cond1(carry):
        _, r, steps, _, stalled = carry
        return (r > tol) & (steps < max_refine) & jnp.logical_not(stalled)

    x0 = (jnp.zeros_like(f), jnp.zeros_like(g))
    r0, r1 = residual(x0)
    init = (
        x0, rel(r0, r1), jnp.zeros((), jnp.int32),
        jnp.zeros((), jnp.int32), jnp.zeros((), bool),
    )
    x, r, steps1, inner_total, _ = jax.lax.while_loop(cond1, body1, init)

    # ---- phase 2: true-f64 equilibrated correction passes ---------------
    def K64eq(z):
        u, p = z
        return (D * A64(D * u) + D * BT64(p), B64(D * u))

    def pre64(z):
        return (
            preA32(z[0].astype(jnp.float32)).astype(jnp.float64),
            preM32(z[1].astype(jnp.float32)).astype(jnp.float64),
        )

    def body2(carry):
        x, r_old, steps, inner_total, _ = carry
        r0, r1 = residual(x)
        res = minres(
            K64eq, (D * r0, r1), pre=pre64,
            tol=p2_inner_tol, maxsteps=p2_inner_maxsteps,
            abs_test=False,
        )
        x_new = (x[0] + D * res.x[0], x[1] + res.x[1])
        r0n, r1n = residual(x_new)
        r_new = rel(r0n, r1n)
        improved = r_new < 0.9 * r_old
        x = jax.tree_util.tree_map(
            lambda new, old: jnp.where(improved, new, old), x_new, x
        )
        r = jnp.where(improved, r_new, r_old)
        return x, r, steps + 1, inner_total + res.iterations, ~improved

    def cond2(carry):
        _, r, steps, _, stalled = carry
        return (r > tol) & (steps < max_p2) & jnp.logical_not(stalled)

    init2 = (x, r, jnp.zeros((), jnp.int32), inner_total,
             jnp.zeros((), bool))
    x, r, steps2, inner_total, _ = jax.lax.while_loop(cond2, body2, init2)
    return x, r, (steps1, steps2), inner_total


def solve_initial_refined(
    model64,
    model32,
    tol: float = 1e-8,
    inner_tol: float = 1e-4,
    inner_maxsteps: int = 2000,
    max_refine: int = 8,
):
    """Mixed-precision SolveInitial for a NavierStokes model pair.

    ``model64`` / ``model32`` are the same model built in float64/float32
    (flat-vector interface: NavierStokesMCS / NavierStokesHDG3D).  The
    f32 Bramble-Pasciak floor for the condensed MCS operator is ~1e-5, so
    ``inner_tol`` defaults to 1e-4 (~4 digits per refinement pass).
    Updates model64's (u, p) state and returns (rel_residual, passes,
    total_inner_iterations).
    """
    m64, m32 = model64, model32
    ops64 = dict(A=m64.A, B=m64.B, BT=m64.BT)
    ops32 = dict(A=m32.A, B=m32.B, BT=m32.BT, preA=m32.preA, preM=m32.preM)
    f_mod = jnp.where(m64.free, m64.f - m64.A_raw(m64.u_bc), 0.0)
    g_mod = -m64.B_raw(m64.u_bc)
    x, r, steps, inner = jax.jit(
        lambda: mixed_precision_saddle_solve(
            ops64, ops32, f_mod, g_mod, tol=tol, inner_tol=inner_tol,
            inner_maxsteps=inner_maxsteps, max_refine=max_refine,
        )
    )()
    m64.u = m64.u_bc + x[0]
    m64.p = x[1]
    m64.stokes_bpcg_iterations = int(inner)
    return float(r), int(steps), int(inner)
