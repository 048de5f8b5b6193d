"""Audit the per-apply HBM stream of the skeleton GS preconditioner.

Builds the flagship operators at a given maxh on CPU and prints every
device table's size plus how many times each is streamed per preA apply —
the per-iteration bandwidth cost model of the solve (the preconditioner
stream, not the A-apply, dominates the phase-1 iteration).

Run: python scripts/audit_tables.py [maxh]
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MAXH = float(sys.argv[1]) if len(sys.argv) > 1 else 0.3


def main():
    import bench
    from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
    from navier_stokes_tpu.ops.faceblock import FaceBlockLayout

    mesh = channel_with_cylinder_mesh_3d(MAXH)
    geo = bench.make_geometry(mesh)
    cache: dict = {}
    m = bench.build(mesh, jnp.float64, cache=cache, geometry=geo)

    lay = FaceBlockLayout(m.Xv)
    ne, nfb, nface = lay.ne, lay.nfb, lay.nface
    n_skel, n_int = lay.n_skel, lay.n_int
    nedge = mesh.nedge
    print(f"maxh={MAXH}: ne={ne} nface={nface} nedge={nedge} "
          f"nfb={nfb} n_skel={n_skel} n_int={n_int} ndof={m.n}")

    S_f32 = ne * n_skel * n_skel * 4
    MB = 1.0 / 2**20

    # edge-star sizes -> inverse table bytes
    from navier_stokes_tpu.ops.faceblock import _edge_star_faces
    ef = _edge_star_faces(mesh)
    sizes = np.array([len(f) for f in ef])
    inv_bytes = int(np.sum((sizes * nfb) ** 2) * 4)
    panel_bytes = 3 * nface * nfb * 2 * n_skel * 4  # per direction
    ext_bytes = ne * n_int * n_skel * 2  # bf16 ext (default)
    inner_bytes = ne * n_int * n_int * 2
    A_bytes = 2 * ne * (4 * nfb + n_int) ** 2 * 4  # hi+lo split... full elem
    # actually A is the full condensed block (n_skel+n_int)^2? use lay dims
    nb_full = n_skel + n_int
    A_bytes = 2 * ne * nb_full * nb_full * 4

    rows = [
        ("A32 hi+lo tables (1 stream/apply)", A_bytes, 1),
        ("S element blocks f32 (coarse residual, 1/apply)", S_f32, 1),
        ("GS row panels (3 S-equiv x 2 directions)", panel_bytes, 2),
        ("edge-star inverses (1/direction)", inv_bytes, 2),
        ("ext+extT tables bf16 (1 each/apply)", ext_bytes, 2),
        ("interior-inverse table bf16 (1/apply)", inner_bytes, 1),
    ]
    tot = 0.0
    print(f"\n{'table':52s} {'size MB':>9s} {'x':>2s} {'MB/apply':>9s}")
    for name, b, k in rows:
        print(f"{name:52s} {b*MB:9.1f} {k:2d} {b*k*MB:9.1f}")
        tot += b * k * MB
    print(f"{'TOTAL preA+A stream per phase-1 iteration':52s} "
          f"{'':9s} {'':2s} {tot:9.1f}")
    print(f"\nedge-star size histogram: "
          f"{dict(zip(*map(list, np.unique(sizes, return_counts=True))))}")
    # H100 SXM memory bandwidth, 3.35 TB/s (NVIDIA's data sheet)
    print(f"at 3350 GB/s (H100 data sheet): "
          f"{tot / MB / 3.35e12 * 1e3:.3f} ms/it")


if __name__ == "__main__":
    main()
