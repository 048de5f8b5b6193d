"""navier_stokes_tpu — an accelerator-native incompressible-flow simulation
engine in JAX.

A ground-up rebuild of the capabilities of ``matschiner/navier-stokes-solver``
(an NGSolve CPU code) for one accelerator, and for several under
``jax.sharding``:

* all mesh / basis / dof-map work happens once on the host and is frozen into
  static arrays (the replacement for the NGSolve/Netgen C++ layer),
* all numerics are pure jitted JAX functions over fixed-shape pytrees,
* every Krylov iteration loop is a single ``lax.while_loop`` with zero host
  round-trips (the reference crosses the Python<->C++ boundary ~8x per CG
  iteration, see /root/reference/bramble_pasciak_cg.py:110-143),
* element-local work (assembly, block inverses, static condensation) is
  batched dense einsum,
* parameter sweeps are ``vmap`` axes and large meshes shard over a
  ``jax.sharding.Mesh``.

Package layout (mirrors SURVEY.md section 7):
  mesh/          host-side mesh generators + connectivity tables
  fem/           reference elements, quadrature, function spaces, dof maps
  ops/           assembly kernels and matrix-free operator applies
  linalg/        linear-operator algebra, block operators, Lanczos
  solvers/       CG, MINRES, Bramble-Pasciak CG (v1 + optimized v2)
  precond/       Jacobi, block-Jacobi, Chebyshev, multigrid
  timestepping/  Gauss-collocation IRK, orthonormalization, exponential integrator
  models/        Heat, Stokes (discretization catalog), NavierStokes
  parallel/      sharding / partitioned execution over device meshes
  utils/         timers, CSV schemas, profiling hooks, compile cache
"""

import jax

# Every f32 product runs at full f32 precision.  On a GPU, XLA's default
# lets f32 dots run in TF32 (~10 mantissa bits): the split hi+lo f32
# operator of the refinement solve (solvers/refinement.py) then loses the
# f64-level accuracy it exists to carry, and the Krylov counts climb.  One
# setting here covers every einsum the package traces; each dot_general
# then carries Precision.HIGHEST (tests/test_precision.py checks it).
jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
