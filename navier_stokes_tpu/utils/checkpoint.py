"""Checkpoint / resume of solver state.

The reference has no persistence beyond result CSVs (SURVEY.md section 5);
state lives in in-memory GridFunctions.  Long transients on a device warrant
snapshots: this stores the (velocity, pressure, time, step) state as npz —
enough to resume DoTimeStep loops bit-for-bit (the state is a plain pytree
of arrays; no RNG or optimizer state exists in this problem class).
"""

from __future__ import annotations

import numpy as np


def save_state(path: str, model, time: float = 0.0, step: int = 0) -> None:
    """Snapshot a NavierStokes model's evolving state."""
    np.savez(
        path,
        u=np.asarray(model.u),
        p=np.asarray(model.p),
        time=time,
        step=step,
        nu=model.nu,
        timestep=model.timestep,
        order=model.order,
        ndof_v=model.V.ndof,
        ndof_q=model.Q.ndof,
    )


def load_state(path: str, model) -> tuple[float, int]:
    """Restore (u, p) into a compatible model; returns (time, step)."""
    import jax.numpy as jnp

    data = np.load(path)
    if int(data["ndof_v"]) != model.V.ndof or int(data["ndof_q"]) != model.Q.ndof:
        raise ValueError(
            "checkpoint incompatible with model: "
            f"V {int(data['ndof_v'])} vs {model.V.ndof}, "
            f"Q {int(data['ndof_q'])} vs {model.Q.ndof}"
        )
    model.u = jnp.asarray(data["u"], model.dtype)
    model.p = jnp.asarray(data["p"], model.dtype)
    return float(data["time"]), int(data["step"])
