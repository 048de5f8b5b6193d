"""Time the flagship setup with the solver's tables derived on the device
and on the host.

    python scripts/setup_probe.py

Builds the bench model (bench.py: maxh=0.09, curved) once, then derives
the equilibrated split operator and the skeleton preconditioner tables
(``equilibrated_f32_ops``) four times, alternating ``NSTPU_DEVICE_TABLES=1``
(on the device, the default on a GPU) and ``=0`` (host numpy, then
upload) in the order 1, 0, 0, 1.  Prints one line per run with its seconds
and the device memory in use.
Needs a GPU, like bench.py.
"""

import gc
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def main():
    bench.configure()
    import jax.numpy as jnp

    from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
    from navier_stokes_tpu.solvers import equilibrated_f32_ops

    dev = bench.require_gpu()
    print(f"device: {dev.device_kind}; {bench.gpu_name_and_power_limit()}",
          flush=True)
    mesh = channel_with_cylinder_mesh_3d(bench.MAXH)
    geo = bench.make_geometry(mesh)
    t0 = time.perf_counter()
    m64 = bench.build(mesh, jnp.float64, geometry=geo)
    bench.wait_all()
    print(f"model build {time.perf_counter() - t0:.2f} s (upload "
          f"{m64.upload_seconds:.2f} s)", flush=True)
    for mode in ("1", "0", "0", "1"):
        os.environ["NSTPU_DEVICE_TABLES"] = mode
        t0 = time.perf_counter()
        ops = equilibrated_f32_ops(m64, gs=bench.GS, split=True, with_ds=True)
        bench.wait_all()
        t = time.perf_counter() - t0
        mem = bench.memory(dev)
        print(f"NSTPU_DEVICE_TABLES={mode}: equilibrated ops {t:.2f} s; "
              + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in mem.items()),
              flush=True)
        del ops
        gc.collect()


if __name__ == "__main__":
    main()
