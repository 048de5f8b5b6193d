"""Navier-Stokes initial-Stokes-solve parameter sweep — the
templates/run_navier_stokes_parameter_sweep.py equivalent.

Sweeps mesh size x order x GS and records the BPCG iteration count and
iteration time of the initial steady Stokes solve into data.csv with the
reference schema: mesh_size, order, iterations, time, gauss_seidel_enabled
(run_navier_stokes_parameter_sweep.py:44-70).  One NavierStokes object is
reused across both GS settings per (h, p), like the reference (:53-56).
"""

import sys

sys.path.insert(0, ".")

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np

from navier_stokes_tpu.mesh import channel_with_cylinder_mesh
from navier_stokes_tpu.models.navier_stokes import NavierStokes
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
from navier_stokes_tpu.utils.csvio import write_rows


def uin(p):
    out = np.zeros((len(p), 2))
    out[:, 0] = 1.5 * 4 * p[:, 1] * (0.41 - p[:, 1]) / 0.41**2
    return out


def solve(mesh_size: float, order: int, gauss_seidel: bool,
          ns_cache: dict, mcs: bool = True) -> tuple[int, float]:
    """One NavierStokes object is reused across both GS settings per (h, p)
    like the reference (run_navier_stokes_parameter_sweep.py:53-56).  The
    MCS model is the reference-faithful discretization; --taylor-hood
    switches to the H1 pair."""
    key = (mesh_size, order)
    if key not in ns_cache:
        mesh = channel_with_cylinder_mesh(mesh_size)
        ns_cache.clear()  # keep at most one model alive (memory)
        cls = NavierStokesMCS if mcs else NavierStokes
        ns_cache[key] = cls(
            mesh, nu=0.001, inflow="inlet", outflow="outlet",
            wall="wall|cyl", uin=uin, timestep=1e-3, order=order,
        )
    ns = ns_cache[key]
    ns.SolveInitial(iterative=True, GS=gauss_seidel, tol=1e-10)
    return ns.stokes_bpcg_iterations, ns.stokes_bpcg_time


if __name__ == "__main__":
    # reference grids: h = 2^-5..2^0, order 7..2 (:44-46); default here is a
    # wall-clock-bounded subset, override via argv: run_ns_sweep.py full
    full = "full" in sys.argv[1:]
    mcs = "--taylor-hood" not in sys.argv[1:]
    # full grid = the reference's h = 2^-5..1 x order 7..2
    # (run_navier_stokes_parameter_sweep.py:44-45), cheapest configs first
    # so a wall-clock-bounded run still covers most of the grid (the CSV is
    # rewritten after every config)
    mesh_sizes = [2.0**-e for e in ([0, 1, 2, 3, 4, 5] if full else [3, 2, 1])]
    orders = list(range(2, 8)) if full else ([3, 2] if mcs else [4, 3, 2])
    data_file = "data.csv"

    rows = []
    cache: dict = {}
    for mesh_size in mesh_sizes:
        for order in orders:
            for gauss_seidel in [True, False]:
                print(f"h={mesh_size} p={order} GS={gauss_seidel}")
                iterations, time = solve(mesh_size, order, gauss_seidel, cache, mcs)
                rows.append({
                    "mesh_size": mesh_size,
                    "order": order,
                    "iterations": iterations,
                    "time": time,
                    "gauss_seidel_enabled": gauss_seidel,
                })
                write_rows(data_file, rows)
    print("wrote", data_file)
