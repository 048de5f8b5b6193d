"""Benchmark: 3D MCS Navier-Stokes initial Stokes solve to f64 rel residual
1e-8, then warm transient steps, on the GPU that JAX finds.

The flagship model: NavierStokesMCS on the reference's 3D
channel-with-cylinder geometry (the reference's
templates/NavierStokesSIMPLE_test_3D.py:8-25) with the
order-3 curved cylinder, BDM_2 H(div) x tangential facet x H(curl,div)
stress with batched static condensation.  The solve:

* phase 1 — float32 MINRES refinement passes on the Jacobi-equilibrated,
  split (hi+lo) f32 system with the skeleton/edge-star aux-space
  preconditioner (multi-color GS row-panel sweep); every apply is a
  scatter-free face-block table stream (ops/faceblock.py).
* phase 2 — MINRES refinement passes on the equilibrated correction
  system with true-f64 operators (the split tables recombined in f64)
  and f32 casts of the phase-1 preconditioner.  (A plain 3x-f32
  double-single apply floors near 1e-6 under the condensed operator's row
  cancellation.)
* transient — DoTimeStep throughput (steps/sec, warm), the reference's
  SIMPLE time loop (NavierStokesSIMPLE_iterative.py:427-438 via
  templates/NavierStokesSIMPLE_test_3D.py:28-31): IMEX steps of one jitted
  program in float32 (explicit upwind convection, diagonal-PCG M* solve,
  Chebyshev-inner divergence projection at relative tolerance 1e-5),
  built from the shared host assembly via ``assembly_cache``.

The measurement needs a GPU: without one it exits non-zero and prints no
result.  ``vs_baseline`` divides a CPU wall time — the same jitted program
on the JAX-CPU backend, measured in this process by
``BENCH_WRITE_BASELINE=1 python bench.py`` and kept in BASELINE_CPU.json —
by the device wall time.

Prints exactly ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "steps_per_sec": N, "steps_vs_baseline": N, "device": {...}, ...}
value = inner Krylov iterations/sec of the warm solve.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

MAXH = float(os.environ.get("BENCH_MAXH", "0.09"))
# 0.09 -> 243k velocity dofs + 31k pressure
TOL = 1e-8
H = 0.41
GS = True  # multi-color GS skeleton sweep (vs the additive smoother)

# Wall-clock budget for the WHOLE bench process: every phase after the
# main device solve checks ``remaining()`` and is skipped (with the JSON
# still printed) rather than running a caller's clock out.
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "540"))
T_START = time.perf_counter()


def remaining():
    return BUDGET_S - (time.perf_counter() - T_START)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def configure() -> str:
    """Process-wide settings of the bench path; call before any build.
    Returns the compile-cache directory."""
    import jax

    from navier_stokes_tpu.utils.compile_cache import enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    # bf16-stored smoother table groups (f32 arithmetic): "ext" (harmonic
    # extension + interior) and "inv" (edge-star inverse tables) are
    # ITERATION-NEUTRAL (354 inner its with both, identical to f32) and
    # together halve ~3 GB of the preconditioner's table stream; "panels"
    # costs +30% iterations and full-table bf16 ~2x (ARCHITECTURE.md).
    os.environ.setdefault("NSTPU_SMOOTHER_BF16", "ext,inv")
    # stronger multiplicative coarse correction (SPD limit is 2.0; the
    # power iteration leaves ~25% margin): 484->458 inner its at maxh=0.09,
    # monotone across scales (ARCHITECTURE.md).
    os.environ.setdefault("NSTPU_COARSE_TARGET", "1.6")
    return enable_compile_cache()


def require_gpu():
    """JAX's default device, which must be a GPU: exit non-zero otherwise
    (no CPU number may be reported under a device name)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {dev} (platform "
            f"{dev.platform!r}); this measurement runs only on a GPU")
    return dev


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def device_info(dev) -> dict:
    import jax

    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def memory(dev) -> dict:
    """Device memory in use and its peak, in bytes ({} where the backend
    keeps no statistics)."""
    st = dev.memory_stats() or {}
    return {k: int(st[k]) for k in ("bytes_in_use", "peak_bytes_in_use")
            if k in st}


def wait_all():
    """Block until every live device array is computed, so a phase's
    wall time includes the device work it enqueued."""
    import jax

    for a in jax.live_arrays():
        a.block_until_ready()


def uin(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = 16 * p[:, 1] * (H - p[:, 1]) * p[:, 2] * (H - p[:, 2]) / H**4
    return out


def make_geometry(mesh):
    """Order-3 curved cylinder, the reference's mesh.Curve(3)
    (the reference's templates/NavierStokesSIMPLE_test_3D.py:16).  A failed
    snap raises: the workload is the curved geometry."""
    from navier_stokes_tpu.mesh.curved import curve_to_cylinder_3d

    geo = curve_to_cylinder_3d(mesh, "cyl", (0.5, 0.2), 0.05, order=3)
    log(f"curved cylinder: {len(geo.curved_elements)} curved tets")
    return geo


def build(mesh, dtype, cache=None, geometry=None):
    from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS

    return NavierStokesMCS(
        mesh, nu=0.001, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=uin, timestep=2e-3, order=2, dtype=dtype,
        preconditioner="faceblock", assembly_cache=cache,
        geometry=geometry,
    )


def measure_transient(device, mesh, cache, n_steps=None, geometry=None,
                      u0=None):
    """DoTimeStep throughput in float32 at relative projection tolerance
    1e-5 — the SIMPLE time loop of the reference
    (NavierStokesSIMPLE_iterative.py:427-438).  ``cache`` shares the host
    assembly/condensation with the f64 initial-solve model; ``u0`` (f64
    state, e.g. the Stokes solution) is the start, else the boundary
    interpolant.  Returns a dict: n_steps, seconds (warm), first_call_s
    (trace + compile + one step), step_s (one warm step), model, step,
    u (final state)."""
    import jax
    import jax.numpy as jnp

    from navier_stokes_tpu.utils.jaxtools import hoisted_jit

    with jax.default_device(device):
        t0 = time.perf_counter()
        m32 = build(mesh, jnp.float32, cache=cache, geometry=geometry)
        u = m32.u if u0 is None else jnp.asarray(u0, jnp.float32)
        # hoisted_jit: the step closes over GB-scale tables (convection
        # traces, element blocks) — they stay runtime buffers, not
        # constants of the compiled module
        step = hoisted_jit(m32.make_step_fn(project_tol=1e-5), u)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        u = step(u)
        jax.block_until_ready(u)
        first_call_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        u = step(u)
        jax.block_until_ready(u)
        step_s = time.perf_counter() - t0
        if n_steps is None:
            # aim for ~10 s of measurement
            n_steps = max(3, min(200, int(10.0 / max(step_s, 1e-3))))
        t0 = time.perf_counter()
        for _ in range(n_steps):
            u = step(u)
        jax.block_until_ready(u)
        t = time.perf_counter() - t0
        if not bool(jnp.all(jnp.isfinite(u))):
            raise FloatingPointError("transient blew up")
        log(f"{device.platform} transient: build {t_build:.1f}s, first "
            f"call {first_call_s:.1f}s, {n_steps} steps in {t:.2f}s "
            f"({n_steps / t:.3f} steps/s)")
    return dict(n_steps=n_steps, seconds=t, first_call_s=first_call_s,
                step_s=step_s, build_s=t_build, model=m32, step=step, u=u)


def measure(device, mesh, cache=None, geometry=None):
    """Build the flagship model and solve its initial Stokes problem to
    the true-f64 relative residual TOL, cold then warm.

    Returns a dict: inner (warm inner iterations), warm_s, cold_s,
    rel_true (true-f64 relative residual of the cold solve), rel (the
    refinement loop's own residual), setup (seconds: host_assembly, upload,
    device_tables, trace, compile), memory, x (warm solution), model."""
    import jax
    import jax.numpy as jnp

    from navier_stokes_tpu.solvers import equilibrated_f32_ops
    from navier_stokes_tpu.solvers.minres import minres
    from navier_stokes_tpu.utils.jaxtools import hoisted_jit

    setup = {}
    with jax.default_device(device):
        t0 = time.perf_counter()
        m64 = build(mesh, jnp.float64, cache=cache, geometry=geometry)
        wait_all()
        t_model = time.perf_counter() - t0
        setup["upload"] = m64.upload_seconds
        setup["host_assembly"] = t_model - setup["upload"]
        log(f"  [setup] model build {t_model:.1f}s "
            f"(upload {setup['upload']:.1f}s)")

        # Jacobi-equilibrated SPLIT f32 inner system + the f64 phase-2
        # operators on the same equilibrated tables
        t0 = time.perf_counter()
        ops32, D, ops_ds = equilibrated_f32_ops(m64, gs=GS, split=True,
                                                with_ds=True)
        f_mod = jnp.where(m64.free, m64.f - m64.A_raw(m64.u_bc), 0.0)
        g_mod = -m64.B_raw(m64.u_bc)
        rhs_norm = float(
            jnp.sqrt(jnp.vdot(f_mod, f_mod) + jnp.vdot(g_mod, g_mod)))
        wait_all()
        setup["device_tables"] = time.perf_counter() - t0
        log(f"  [setup] equilibrated ops {setup['device_tables']:.1f}s "
            f"ndof={m64.n}+{m64.Q.ndof}")

        def K32(x):
            u, p = x
            return (ops32["A"](u) + ops32["BT"](p), ops32["B"](u))

        def pre32(x):
            return (ops32["preA"](x[0]), ops32["preM"](x[1]))

        z32 = jnp.zeros_like(f_mod, jnp.float32)
        zp32 = jnp.zeros_like(g_mod, jnp.float32)
        t0 = time.perf_counter()
        minres32 = hoisted_jit(
            lambda r0s, r1s, tl: minres(
                K32, (r0s, r1s), pre=pre32, tol=tl, maxsteps=2000,
                abs_test=False,
            ),
            z32, zp32, jnp.float32(5e-7),
        )
        residual64 = hoisted_jit(
            lambda u0, u1: (
                f_mod - m64.A(u0) - m64.BT(u1), g_mod - m64.B(u0)
            ),
            f_mod, g_mod,
        )
        # per-pass residuals through the f64 equilibrated operators:
        # A = D^-1 A~ D^-1 etc., so conjugate them by D.  residual64 (the
        # model's own f64 operator) stays the one-time verification.
        Dinv = 1.0 / D
        residual_pass = hoisted_jit(
            lambda u0, u1: (
                f_mod - Dinv * ops_ds["A"](Dinv * u0)
                - Dinv * ops_ds["BT"](u1),
                g_mod - ops_ds["B"](Dinv * u0),
            ),
            f_mod, g_mod,
        )
        # phase 2: MINRES on the EQUILIBRATED correction system
        # (D A D) dz~ = D r with the f64 operators and the f32 skeleton
        # preconditioner (plain casts — the system is already scaled).
        # Posed on the residual, every quantity scales with ||r||, so the
        # f32 preconditioner noise is RELATIVE — each outer pass contracts
        # the true residual by its tolerance.
        preA32s = ops32["preA"]
        preM32s = ops32["preM"]

        def K_ds(x):
            u, p = x
            return (ops_ds["A"](u) + ops_ds["BT"](p), ops_ds["B"](u))

        def pre_ds(x):
            return (
                preA32s(x[0].astype(jnp.float32)).astype(jnp.float64),
                preM32s(x[1].astype(jnp.float32)).astype(jnp.float64),
            )

        minres_p2 = hoisted_jit(
            lambda r0, r1, tl: minres(
                K_ds, (r0, r1), pre=pre_ds, tol=tl, maxsteps=1000,
                abs_test=False,
            ),
            f_mod, g_mod, jnp.float64(1e-4),
        )
        setup["trace"] = time.perf_counter() - t0
        log(f"  [setup] trace {setup['trace']:.1f}s")

        def true_rel(r0, r1):
            return float(
                jnp.sqrt(jnp.vdot(r0, r0) + jnp.vdot(r1, r1))
            ) / rhs_norm

        def full_solve():
            x0 = jnp.zeros_like(f_mod)
            x1 = jnp.zeros_like(g_mod)
            total_inner = 0
            rel = 1.0
            # phase 1: f32 MINRES refinement passes
            t_solve0 = time.perf_counter()
            for _pass in range(8):
                if _pass == 0:
                    r0, r1 = f_mod, g_mod  # x == 0: the residual IS the rhs
                else:
                    r0, r1 = residual_pass(x0, x1)
                new_rel = true_rel(r0, r1)
                log(f"  p1 pass {_pass}: rel={new_rel:.3e} "
                    f"inner={total_inner} "
                    f"t={time.perf_counter() - t_solve0:.2f}s")
                if new_rel <= TOL or (_pass > 0 and new_rel > 0.7 * rel):
                    rel = min(rel, new_rel)
                    break
                rel = new_rel
                # adaptive pass tolerance: the inner f32 preconditioned-
                # norm recurrence runs ~100x ahead of the true f64
                # contraction, so when the REMAINING contraction (TOL/rel)
                # is small, loosen the pass target instead of driving a
                # full 5e-7 pass ~1e4x past it.
                tol_pass = jnp.float32(
                    min(1e-3, max(5e-7, (TOL / rel) / 256.0)))
                res = minres32((D * r0).astype(jnp.float32),
                               r1.astype(jnp.float32), tol_pass)
                dx0, dx1 = res.x
                total_inner += int(res.iterations)
                x0 = x0 + D * dx0.astype(jnp.float64)
                x1 = x1 + dx1.astype(jnp.float64)
            # phase 2: f64 MINRES refinement passes on the equilibrated
            # correction system
            _outer = 0
            while _outer < 6 and rel > TOL:
                r0, r1 = residual_pass(x0, x1)
                # its f64 recurrence tracks the true residual much closer
                # than phase 1's: a 16x safety margin instead of 256x
                tol_p2 = jnp.float64(min(1e-3, max(1e-4, (TOL / rel) / 16.0)))
                res = minres_p2(D * r0, r1, tol_p2)
                dx0, dx1 = res.x
                total_inner += int(res.iterations)
                x0n = x0 + D * dx0
                x1n = x1 + dx1
                r0n, r1n = residual_pass(x0n, x1n)
                new_rel = true_rel(r0n, r1n)
                log(f"  p2 outer {_outer}: rel={new_rel:.3e} "
                    f"inner={total_inner} "
                    f"t={time.perf_counter() - t_solve0:.2f}s")
                if new_rel >= 0.9 * rel:
                    # stalled at the noise floor — keep the best iterate
                    break
                x0, x1, rel = x0n, x1n, new_rel
                _outer += 1
            return (x0, x1), rel, total_inner

        t_c = time.perf_counter()
        x, rel, inner_cold = full_solve()  # compile + warmup
        jax.block_until_ready(x)
        t_cold = time.perf_counter() - t_c
        # one-time verification against the model's own f64 operator
        r0v, r1v = residual64(x[0], x[1])
        rel_true = true_rel(r0v, r1v)
        log(f"{device.platform} cold {t_cold:.2f}s: rel={rel:.2e} "
            f"(true f64 {rel_true:.2e}) inner={inner_cold}")
        t_w = time.perf_counter()
        x, rel, inner = full_solve()
        jax.block_until_ready(x)
        t = time.perf_counter() - t_w
        log(f"{device.platform} warm: {t:.3f}s rel={rel:.2e} inner={inner}")
        setup["compile"] = max(t_cold - t, 0.0)
    return dict(inner=int(inner), inner_cold=int(inner_cold), warm_s=t,
                cold_s=t_cold, rel_true=rel_true, rel=rel, setup=setup,
                memory=memory(device), x=x, model=m64)


BASELINE_ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "BASELINE_CPU.json")


def _baseline_config():
    return {
        "metric": "mcs3d_initial_stokes_to_residual_1e-8",
        "maxh": MAXH,
        "tol": TOL,
        "geom": f"{MAXH}_curved",
        "gs": int(GS),
    }


def load_baseline():
    """Measured CPU baseline, kept as a repo artifact and keyed on the
    bench config — a config mismatch discards it."""
    try:
        with open(BASELINE_ARTIFACT) as fh:
            art = json.load(fh)
    except FileNotFoundError:
        return None
    if art.get("config") == _baseline_config():
        return art
    log("baseline artifact config mismatch — ignoring",
        art.get("config"), _baseline_config())
    return None


def write_baseline(mesh, cache, geo):
    """Measure the CPU baseline (the same jitted program on the JAX-CPU
    backend, in this process) and keep it as the repo artifact."""
    import datetime
    import platform as _plat

    import jax

    cpu = jax.devices("cpu")[0]
    res = measure(cpu, mesh, cache, geometry=geo)
    art = {
        "config": _baseline_config(),
        "solve_wall_s": round(res["warm_s"], 3),
        "solve_inner": res["inner"],
        "provenance": (
            "same jitted program on the jax-CPU backend (warm wall, compile "
            "excluded); measured by `BENCH_WRITE_BASELINE=1 python bench.py`"
        ),
        "measured_utc": datetime.datetime.now(datetime.timezone.utc)
        .isoformat(timespec="seconds"),
        "host": _plat.node() or "unknown",
        "cpu_count": os.cpu_count(),
    }
    if not os.environ.get("BENCH_NO_TRANSIENT"):
        tr = measure_transient(cpu, mesh, cache, n_steps=3, geometry=geo)
        art["transient_steps_per_sec"] = float(
            f"{tr['n_steps'] / tr['seconds']:.4g}")
        art["transient_n_steps"] = int(tr["n_steps"])
    with open(BASELINE_ARTIFACT, "w") as fh:
        json.dump(art, fh, indent=1)
        fh.write("\n")
    log(f"baseline artifact written: {BASELINE_ARTIFACT}")
    return art


def main():
    configure()
    from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d

    if os.environ.get("BENCH_WRITE_BASELINE"):
        mesh = channel_with_cylinder_mesh_3d(MAXH)
        write_baseline(mesh, {}, make_geometry(mesh))
        return

    dev = require_gpu()
    card = gpu_name_and_power_limit()
    mesh = channel_with_cylinder_mesh_3d(MAXH)
    log(f"benchmark device: {dev} ({card}), maxh={MAXH} ({mesh.ne} tets), "
        f"tol={TOL}")
    cache: dict = {}  # host assembly shared across both model builds
    geo = make_geometry(mesh)
    res = measure(dev, mesh, cache, geometry=geo)
    if res["rel_true"] > 1.01 * TOL:
        raise SystemExit(f"did not reach {TOL}: true f64 residual "
                         f"{res['rel_true']}")
    t_main = res["warm_s"]

    steps_per_sec = None
    if not os.environ.get("BENCH_NO_TRANSIENT"):
        if remaining() > 150:
            tr = measure_transient(dev, mesh, cache, geometry=geo)
            steps_per_sec = tr["n_steps"] / tr["seconds"]
        else:
            log(f"transient skipped: {remaining():.0f}s left of "
                f"{BUDGET_S:.0f}s budget")

    vs_baseline = None
    steps_vs_baseline = None
    if not os.environ.get("BENCH_NO_CPU"):
        art = load_baseline()
        if art is None and remaining() > 420:
            art = write_baseline(mesh, cache, geo)
        if art is not None:
            vs_baseline = art["solve_wall_s"] / t_main
            if steps_per_sec is not None and art.get(
                    "transient_steps_per_sec"):
                steps_vs_baseline = (
                    steps_per_sec / art["transient_steps_per_sec"])

    out = {
        "metric": "mcs3d_initial_stokes_to_residual_1e-8",
        "value": res["inner"] / t_main,
        "unit": "inner Krylov iterations/sec (warm solve)",
        "solve_wall_s": t_main,
        "inner_iterations": res["inner"],
        "rel_residual_f64": res["rel_true"],
        "setup_s": res["setup"],
        "memory_bytes": res["memory"],
        "maxh": MAXH,
        "vs_baseline": vs_baseline,
        "device": device_info(dev),
        "gpu": card,
    }
    if steps_per_sec is not None:
        out["steps_per_sec"] = steps_per_sec
        out["steps_vs_baseline"] = steps_vs_baseline
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
