"""Multi-chip execution: element-sharded operators + batch-sharded sweeps.

The reference has no distributed execution at all (SURVEY.md section 2c); its
only parallelism is NGSolve's shared-memory TaskManager.  The device-mesh
growth path is:

* **spatial (model) parallelism** — shard the element axis of the batched
  matrix-free operators over a device mesh; each shard computes its partial
  scatter-add and a ``psum`` over the mesh reduces to the replicated global
  vector (classic non-overlapping FEM domain decomposition, collectives over
  ICI);
* **sweep (data) parallelism** — vmap the solver over a parameter batch
  (viscosity / time step / forcing) and shard the batch axis; replaces the
  reference's serial sweep loops (run.py:229-259).

Both paths are plain jit + NamedSharding: XLA GSPMD inserts the collectives.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def device_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def pad_elements(a_local: jnp.ndarray, eldofs: jnp.ndarray, n_shards: int):
    """Pad the element axis to a multiple of n_shards.

    Padding elements carry zero local matrices and scatter into dof 0, so
    they contribute nothing."""
    ne = a_local.shape[0]
    pad = (-ne) % n_shards
    if pad:
        a_local = jnp.concatenate(
            [a_local, jnp.zeros((pad,) + a_local.shape[1:], a_local.dtype)]
        )
        eldofs = jnp.concatenate(
            [eldofs, jnp.zeros((pad,) + eldofs.shape[1:], eldofs.dtype)]
        )
    return a_local, eldofs


def sharded_local_operator(
    a_local: jnp.ndarray,
    eldofs: jnp.ndarray,
    ndof: int,
    mesh: Mesh,
    axis: str = "shard",
):
    """Element-sharded matrix-free apply: u (replicated) -> A u (replicated).

    The element tables are laid out with NamedSharding over the element axis;
    each device computes its partial scatter-add and psum reduces over ICI.
    """
    n_shards = mesh.shape[axis]
    a_local, eldofs = pad_elements(a_local, eldofs, n_shards)
    esharding = NamedSharding(mesh, P(axis))
    a_local = jax.device_put(a_local, esharding)
    eldofs = jax.device_put(eldofs, esharding)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P()),
        out_specs=P(),
    )
    def apply_shard(a_shard, ed_shard, u):
        ue = u[ed_shard]
        ye = jnp.einsum("eij,ej->ei", a_shard, ue)
        y_partial = jnp.zeros(ndof, ye.dtype).at[ed_shard].add(ye)
        return jax.lax.psum(y_partial, axis)

    return lambda u: apply_shard(a_local, eldofs, u)


def sharded_batch_step(step_fn, mesh: Mesh, axis: str = "shard"):
    """vmap ``step_fn`` over a leading batch axis sharded across the mesh.

    The batched replacement for the reference's serial parameter sweeps:
    each device advances its own ensemble member(s).  The step's tables
    are hoisted to runtime arguments at the first call (``hoisted_jit``):
    as constants of the compiled program they would be folded and
    embedded at compile time."""
    from ..utils.jaxtools import hoisted_jit

    batched = jax.vmap(step_fn)
    sharding = NamedSharding(mesh, P(axis))

    def run(batch_u):
        batch_u = jax.lax.with_sharding_constraint(batch_u, sharding)
        return batched(batch_u)

    compiled = {}

    def call(batch_u):
        if "run" not in compiled:
            compiled["run"] = hoisted_jit(run, batch_u,
                                          out_shardings=sharding)
        return compiled["run"](batch_u)

    return call
