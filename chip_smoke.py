"""Smoke test of the flagship path on the GPU.

    python chip_smoke.py              # one GPU: phases (a)-(e)
    python chip_smoke.py --devices 4  # four GPUs: the face-sharded solve

Phases on one GPU, each through the functions bench.py uses:

  (a) the device: JAX's default device must be a GPU; prints its kind
      and nvidia-smi's name and power limit.  No CPU fallback.
  (b) table-apply parity at bench widths: every batched table product of
      the solve (the split f32 element operator, the f64 phase-2 apply,
      the skeleton, extension, GS row-panel and edge-star inverse tables)
      against a float64 numpy product of the same table.  TF32 products
      (~1e-3) fail the 1e-5 bound.
  (c) the main path: bench.measure — the initial Stokes solve at
      maxh=0.09 (curved) to a true-f64 relative residual <= 1e-8, cold and
      warm, with the setup split into host assembly, upload, device table
      build, trace and compile, the inner iteration count (340-450), and
      device memory.
  (d) the time step: bench.measure_transient from the Stokes solution,
      >= 3 warm f32 steps; the velocity stays finite and the projected
      velocity's divergence is at the projection tolerance.
  (e) the last line: {"ok": true, "device": {...}}.

With ``--devices 4`` only the four-GPU path runs, with what it is compared
with: sharded_fast_flagship_solve at maxh=0.09 over a 1-D mesh of the four
GPUs against the single-device two-phase solve of the same system (same
abs_test), and the sharded ensemble step (sharded_batch_step) against the
unsharded step.

Any failed check raises, so the process exits non-zero without the ok
line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import bench  # noqa: E402  (the repo's bench module, beside this file)

F32_TOL = 1e-5   # normwise, f32 / bf16-stored tables vs f64 numpy
F64_TOL = 1e-12  # normwise, f64 applies vs f64 numpy
PROJECT_TOL = 1e-5  # relative tolerance of the transient's projection CG
MSTAR_TOL = 1e-4  # relative precision of its M* CG (make_step_fn default)
INNER_RANGE = (340, 450)


def say(*a):
    print(*a, flush=True)


def check(ok: bool, msg: str):
    if not ok:
        raise AssertionError(msg)


def normwise(got, want) -> float:
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# --------------------------------------------------------------------------
# (b) parity
# --------------------------------------------------------------------------


def phase_parity(mesh):
    """Every table product of the solve at bench widths vs f64 numpy, with
    the device time and stream rate of one apply.  Returns the seconds of
    each first call (compile and one apply)."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from navier_stokes_tpu.fem.hdiv3d import HDiv3D
    from navier_stokes_tpu.models.stokes_hybrid3d import (
        HybridVelocitySpace3D,
        VectorFacet3D,
    )
    from navier_stokes_tpu.ops.faceblock import (
        FaceBlockLayout,
        _edge_star_faces,
    )
    from navier_stokes_tpu.ops.table_apply import make_table_apply
    from navier_stokes_tpu.solvers.refinement import (
        _equilibrated_split_device,
    )
    from navier_stokes_tpu.utils.jaxtools import hoisted_jit

    V = HDiv3D(mesh, 2, dirichlet="inlet|wall|cyl")
    F = VectorFacet3D(mesh, 1, dirichlet="inlet|wall|cyl|outlet")
    Xv = HybridVelocitySpace3D(V, F)
    lay = FaceBlockLayout(Xv)
    ne, nb, nfb, n_skel = lay.ne, lay.nb, lay.nfb, lay.n_skel
    n_int = nb - n_skel
    fsz_max = max(len(f) for f in _edge_star_faces(mesh))
    bmax = fsz_max * nfb
    rng = np.random.default_rng(0)
    ed = np.asarray(Xv.element_dofs)[:, lay.perm]  # face-major columns

    def assembled(T64, u):
        y = np.zeros(Xv.ndof)
        np.add.at(y, ed, np.einsum("eij,ej->ei", T64, u[ed]))
        return y

    compile_s = {}
    reps = 50

    def timed(name, fn, x):
        """Output of ``fn(x)``; records the seconds of its first call
        (compile and one apply) and the device seconds of one apply
        (``reps`` chained applies in one program).  hoisted_jit keeps the
        tables runtime buffers, as the solve does."""
        t0 = time.perf_counter()
        out = jax.block_until_ready(hoisted_jit(fn, x)(x))
        compile_s[name] = time.perf_counter() - t0

        def loop(x):
            def body(i, acc):
                y = fn(x * (1 + i * 1e-7).astype(x.dtype))
                return acc + jnp.sum(y).astype(acc.dtype)

            return jax.lax.fori_loop(0, reps, body, jnp.zeros((), x.dtype))

        loop = hoisted_jit(loop, x)
        jax.block_until_ready(loop(x))
        t0 = time.perf_counter()
        jax.block_until_ready(loop(x))
        return out, (time.perf_counter() - t0) / reps

    def nbytes(*arrays):
        return sum(int(np.prod(a.shape)) * jnp.dtype(a.dtype).itemsize
                   for a in arrays)

    # split f32 element operator (phase 1's A) and its f64 recombination
    # (phase 2's A), through the face-block apply the solve uses
    A64 = rng.standard_normal((ne, nb, nb))
    A_hi = A64.astype(np.float32)
    A_lo = (A64 - A_hi.astype(np.float64)).astype(np.float32)
    u = rng.standard_normal(Xv.ndof)
    split = lay.elem_apply_multi([(jnp.asarray(A_hi), None),
                                  (jnp.asarray(A_lo), None)])
    want = assembled(A_hi.astype(np.float64) + A_lo.astype(np.float64), u)
    u32 = jnp.asarray(u, jnp.float32)
    y, t = timed("elem_f32_split", split, u32)
    results = [("element table split f32", (ne, nb, nb), "f32",
                normwise(y, want), F32_TOL, t,
                nbytes(A_hi, A_lo) + 2 * nbytes(u32))]
    y, t = timed("elem_f64", lay.elem_apply_comp(A_hi, A_lo), jnp.asarray(u))
    results.append(("element table f64 (phase 2)", (ne, nb, nb), "f64",
                    normwise(y, want), F64_TOL, t,
                    nbytes(A64) + 2 * Xv.ndof * 8))
    # the device-side equilibrated hi/lo split: hi + lo must hold D A D to
    # f64 accuracy (a compiler that drops the lo part leaves ~3e-8)
    D = rng.uniform(0.1, 10.0, (ne, nb))
    hi, lo = _equilibrated_split_device(jnp.asarray(A64), D)
    want = A64 * D[:, :, None] * D[:, None, :]
    results.append(("equilibrated hi/lo split", (ne, nb, nb), "f64",
                    normwise(np.asarray(hi, np.float64)
                             + np.asarray(lo, np.float64), want),
                    F64_TOL, None, None))
    del hi, lo

    # preconditioner tables through make_table_apply: (name, shape,
    # storage, soa_io).  Widths as the skeleton preconditioner builds them:
    # S (ne, 4nfb, 4nfb); extension (ne, n_int, 4nfb) and interior solve
    # (ne, n_int, n_int) in bf16; GS row panels (nsel, nfb, 2*4nfb) in f32
    # and merged edge-star inverses (nblk, fsz_max*nfb, fsz_max*nfb) in
    # bf16, at one color's row and block counts.  Each bf16 table is also
    # timed stored in f32: a bf16 apply that is not faster than the f32
    # one streams an f32 copy of its table.
    nsel = lay.nface // 4
    nblk = mesh.nedge // 16
    tables = [
        ("skeleton S", (ne, n_skel, n_skel), "f32", False),
        ("extension", (ne, n_int, n_skel), "bf16", False),
        ("extension", (ne, n_int, n_skel), "f32", False),
        ("interior solve", (ne, n_int, n_int), "bf16", False),
        ("interior solve", (ne, n_int, n_int), "f32", False),
        ("GS row panels", (nsel, nfb, 2 * n_skel), "f32", True),
        ("edge-star inverses", (nblk, bmax, bmax), "bf16", True),
        ("edge-star inverses", (nblk, bmax, bmax), "f32", True),
        # every color's blocks in one table: a stream long enough that the
        # bf16/f32 comparison is not bound by per-apply latency
        ("edge-star inverses, all", (mesh.nedge, bmax, bmax), "bf16", True),
        ("edge-star inverses, all", (mesh.nedge, bmax, bmax), "f32", True),
    ]
    for name, shape, storage, soa in tables:
        T = rng.standard_normal(shape).astype(np.float32)
        sdt = jnp.bfloat16 if storage == "bf16" else jnp.float32
        # reference: the STORED table (bf16-rounded where stored so) in f64
        T64 = (T.astype(ml_dtypes.bfloat16) if storage == "bf16" else T
               ).astype(np.float64)
        fn = make_table_apply(T, store_dtype=sdt, soa_io=soa)
        if soa:
            x = rng.standard_normal((shape[2], shape[0])).astype(np.float32)
            want = np.einsum("bmk,kb->mb", T64, x.astype(np.float64))
        else:
            x = rng.standard_normal((shape[0], shape[2])).astype(np.float32)
            want = np.einsum("bmk,bk->bm", T64, x.astype(np.float64))
        y, t = timed(f"{name} {storage}", fn, jnp.asarray(x))
        stream = int(np.prod(shape)) * jnp.dtype(sdt).itemsize \
            + 4 * (x.size + want.size)
        results.append((name, shape, storage, normwise(y, want), F32_TOL, t,
                        stream))
    for name, shape, storage, err, tol, t, stream in results:
        rate = ("" if t is None else f"; apply {t * 1e3:.4f} ms, "
                f"{stream / 1e6:.1f} MB, {stream / t / 1e9:.1f} GB/s")
        say(f"[b] parity {name:28s} {str(shape):16s} {storage:4s} "
            f"rel err {err:.3e} (bound {tol:.0e}){rate}")
    for name, shape, storage, err, tol, *_ in results:
        check(err <= tol, f"parity failed: {name} {storage} {err:.3e} > "
              f"{tol:.0e}")
    say("[b] parity compile s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in compile_s.items()))
    return compile_s


# --------------------------------------------------------------------------
# (c) main path, (d) time steps
# --------------------------------------------------------------------------


def phase_solve(dev, mesh, cache, geo):
    res = bench.measure(dev, mesh, cache, geometry=geo)
    st = res["setup"]
    say("[c] setup s: " + ", ".join(
        f"{k} {st[k]:.2f}" for k in
        ("host_assembly", "upload", "device_tables", "trace", "compile")))
    say(f"[c] solve: cold {res['cold_s']:.3f} s, warm {res['warm_s']:.3f} s")
    say(f"[c] inner iterations: warm {res['inner']}, cold "
        f"{res['inner_cold']} (expected {INNER_RANGE[0]}-{INNER_RANGE[1]})")
    say(f"[c] true f64 relative residual: {res['rel_true']:.3e} "
        f"(the refinement loop's own: {res['rel']:.3e})")
    mem = res["memory"]
    say("[c] device memory: " + ", ".join(
        f"{k} {v / 1e9:.2f} GB" for k, v in mem.items()))
    check(res["rel_true"] <= bench.TOL,
          f"true f64 residual {res['rel_true']:.3e} > {bench.TOL}")
    check(INNER_RANGE[0] <= res["inner"] <= INNER_RANGE[1],
          f"inner iterations {res['inner']} outside {INNER_RANGE}")
    return res


def phase_steps(dev, mesh, cache, geo, res):
    import jax
    import jax.numpy as jnp

    from navier_stokes_tpu.utils.jaxtools import hoisted_jit

    m64 = res["model"]
    u0 = m64.u_bc + res["x"][0]  # start from the Stokes solution
    tr = bench.measure_transient(dev, mesh, cache, geometry=geo, u0=u0)
    n, t = tr["n_steps"], tr["seconds"]
    say(f"[d] {n} warm steps in {t:.3f} s: {n / t:.4f} steps/s "
        f"(one step {tr['step_s']:.4f} s; model build {tr['build_s']:.2f} s, "
        f"compile {max(tr['first_call_s'] - tr['step_s'], 0.0):.2f} s)")
    check(n >= 3, f"only {n} steps")
    u = tr["u"]
    check(bool(jnp.all(jnp.isfinite(u))), "velocity not finite")
    m32 = tr["model"]

    # the projection of the step (same operators and tolerance) applied
    # to the step's own pre-projection velocity at the final state; the
    # divergence is measured in the norm the projection CG stops on (its
    # preconditioner's), relative to the unprojected velocity's
    pre = m32._pre_proj_twolevel()

    def divergence(u):
        temp = jnp.where(m32.free, m32.convection(u) + m32.f - m32.A_raw(u),
                         0.0)
        v = m32._inv_mstar(temp, precision=MSTAR_TOL)
        up, _ = m32._project_velocity(v, tol=PROJECT_TOL)
        r, b = m32.B(up), m32.B(v)
        return jnp.sqrt(jnp.vdot(r, pre(r)) / jnp.vdot(b, pre(b)))

    with jax.default_device(dev):
        div_rel = float(hoisted_jit(divergence, u)(u))
    say(f"[d] divergence of the projected velocity: {div_rel:.3e} of the "
        f"unprojected one (projection tol {PROJECT_TOL:.0e})")
    check(div_rel <= 10 * PROJECT_TOL,
          f"projected divergence {div_rel:.3e} above 10x the tolerance")


# --------------------------------------------------------------------------
# four GPUs
# --------------------------------------------------------------------------


def phase_sharded(n_dev: int, mesh, geo):
    import jax
    import jax.numpy as jnp

    from navier_stokes_tpu.parallel.faceshard import (
        sharded_fast_flagship_solve,
    )
    from navier_stokes_tpu.parallel.sharding import device_mesh
    from navier_stokes_tpu.solvers.refinement import (
        equilibrated_f32_ops,
        mixed_precision_minres_refinement_2phase,
    )
    from navier_stokes_tpu.utils.jaxtools import hoisted_jit

    check(len(jax.devices()) >= n_dev,
          f"need {n_dev} devices, have {len(jax.devices())}")
    dmesh = device_mesh(n_dev)
    kw = dict(tol=bench.TOL, inner_tol=5e-7, inner_maxsteps=800,
              abs_test=False)
    t0 = time.perf_counter()
    ns = bench.build(mesh, jnp.float64, geometry=geo)
    say(f"[s] model build {time.perf_counter() - t0:.1f} s")

    def true_rel(xu, xp):
        f = jnp.where(ns.free, ns.f - ns.A_raw(ns.u_bc), 0.0)
        g = -ns.B_raw(ns.u_bc)
        r0 = f - ns.A(jnp.asarray(xu)) - ns.BT(jnp.asarray(xp))
        r1 = g - ns.B(jnp.asarray(xu))
        return float(jnp.sqrt(jnp.vdot(r0, r0) + jnp.vdot(r1, r1))
                     / jnp.sqrt(jnp.vdot(f, f) + jnp.vdot(g, g)))

    t0 = time.perf_counter()
    (xu, xp), rel_sh, passes_sh, inner_sh, plan = \
        sharded_fast_flagship_solve(ns, dmesh, gs=True, **kw)
    t_sh = time.perf_counter() - t0
    rel_sh_true = true_rel(xu, xp)
    n_halo = sum(len(h) for h in plan.halo_faces)
    say(f"[s] sharded over {n_dev} devices: rel {rel_sh:.3e} (true f64 "
        f"{rel_sh_true:.3e}), inner {inner_sh}, passes {passes_sh}, "
        f"{t_sh:.1f} s incl. setup+compile, halo "
        f"{n_halo / ns.mesh.nface / n_dev:.1%} of faces per shard")

    t0 = time.perf_counter()
    ops32, D = equilibrated_f32_ops(ns, gs=True, split=True)
    ops64 = dict(A=ns.A, B=ns.B, BT=ns.BT)
    f_mod = jnp.where(ns.free, ns.f - ns.A_raw(ns.u_bc), 0.0)
    g_mod = -ns.B_raw(ns.u_bc)
    x1, r1, passes1, inner1 = hoisted_jit(
        lambda f, g: mixed_precision_minres_refinement_2phase(
            ops64, ops32, D, f, g, max_refine=8, **kw), f_mod, g_mod,
    )(f_mod, g_mod)
    t_1 = time.perf_counter() - t0
    inner1 = int(inner1)
    rel1_true = true_rel(x1[0], x1[1])
    say(f"[s] single device: rel {float(r1):.3e} (true f64 {rel1_true:.3e}), "
        f"inner {inner1}, passes {tuple(int(p) for p in passes1)}, "
        f"{t_1:.1f} s incl. setup+compile")
    check(rel_sh_true <= bench.TOL, f"sharded residual {rel_sh_true:.3e}")
    check(rel1_true <= bench.TOL, f"single-device residual {rel1_true:.3e}")
    check(abs(inner_sh - inner1) <= 0.1 * inner1,
          f"inner counts differ by more than 10%: {inner_sh} vs {inner1}")
    phase_ensemble(dmesh)


def phase_ensemble(dmesh):
    """Each device advances its own member of a batch of f32 states
    (sharded_batch_step); compared with the step applied member by member
    on one device."""
    import jax
    import jax.numpy as jnp

    from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
    from navier_stokes_tpu.parallel.sharding import sharded_batch_step
    from navier_stokes_tpu.utils.jaxtools import hoisted_jit

    n_dev = dmesh.size
    m32 = bench.build(channel_with_cylinder_mesh_3d(0.35), jnp.float32)
    step = m32.make_step_fn(project_tol=PROJECT_TOL)
    rng = np.random.default_rng(1)
    batch = jnp.stack([
        m32.u * (1.0 + 0.01 * k) + jnp.asarray(
            1e-3 * rng.standard_normal(m32.n), jnp.float32) * m32.free
        for k in range(n_dev)])
    out = jax.block_until_ready(sharded_batch_step(step, dmesh)(batch))
    step1 = hoisted_jit(step, batch[0])
    ref = jnp.stack([step1(b) for b in batch])
    err = normwise(out, np.asarray(ref, np.float64))
    say(f"[s] sharded ensemble step ({n_dev} members, "
        f"{out.sharding}) vs unsharded: rel diff {err:.3e}")
    check(out.shape == batch.shape and bool(jnp.all(jnp.isfinite(out))),
          "ensemble step shape or finiteness")
    # the step's M* CG stops at relative precision MSTAR_TOL: the batched
    # and the single-member programs sum in other orders, so their CG
    # iterates part within that tolerance (the CPU gives them bitwise)
    check(err <= 10 * MSTAR_TOL, f"ensemble step differs: {err:.3e} > "
          f"{10 * MSTAR_TOL:.0e}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the four-GPU sharded path")
    args = ap.parse_args(argv)

    cache_dir = bench.configure()
    import jax

    dev = bench.require_gpu()
    card = bench.gpu_name_and_power_limit()
    say(f"[a] JAX device: {dev.platform} {dev.device_kind} x "
        f"{len(jax.devices())}; jax {jax.__version__}")
    say(f"[a] nvidia-smi: {card}")
    say(f"[a] compile cache: {cache_dir}")

    from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d

    t0 = time.perf_counter()
    mesh = channel_with_cylinder_mesh_3d(bench.MAXH)
    geo = bench.make_geometry(mesh)
    say(f"[a] mesh maxh={bench.MAXH}: {mesh.ne} tets, curved geometry "
        f"{time.perf_counter() - t0:.1f} s")
    if args.devices == 4:
        phase_sharded(4, mesh, geo)
    else:
        phase_parity(mesh)
        cache: dict = {}
        res = phase_solve(dev, mesh, cache, geo)
        phase_steps(dev, mesh, cache, geo, res)
    say(f"[e] total {time.perf_counter() - bench.T_START:.1f} s")
    print(json.dumps({"ok": True, "device": bench.device_info(dev)}),
          flush=True)


if __name__ == "__main__":
    main()
