"""JAX plumbing: closure hoisting and the device-table gate."""

from __future__ import annotations

import os

import jax


def hoisted_jit(fn, *example_args, out_shardings=None):
    """``jax.jit`` with closure constants hoisted to runtime arguments.

    Jitting a closure over multi-hundred-MB device arrays (assembled
    element matrices, block inverses) embeds them as CONSTANTS in the
    compiled module: XLA warns about captured constants, the module and
    its compile time grow with the tables, and a step traced with its
    tables as constants ran far slower per call than the same step with
    them as buffers (models/navier_stokes_mcs.py make_step_fn).
    ``jax.make_jaxpr`` exposes every captured array as
    ``ClosedJaxpr.consts``; re-evaluating the jaxpr with the consts passed
    as ARGUMENTS keeps them as runtime device buffers.

    Returns a callable with the same signature as ``fn``; the consts are
    bound once at build time.  ``out_shardings`` (a prefix of ``fn``'s
    output tree) is passed to ``jax.jit``.
    """
    closed, out_shape = jax.make_jaxpr(fn, return_shape=True)(*example_args)
    treedef = jax.tree_util.tree_structure(out_shape)
    jaxpr = closed.jaxpr
    consts = closed.consts

    def run(consts, *args):
        flat_args = []
        for a in args:
            flat_args.extend(jax.tree_util.tree_leaves(a))
        out = jax.core.eval_jaxpr(jaxpr, consts, *flat_args)
        return jax.tree_util.tree_unflatten(treedef, out)

    run = jax.jit(run, out_shardings=out_shardings)
    return lambda *args: run(consts, *args)


def device_tables_enabled() -> bool:
    """Whether setup derives the preconditioner tables on the device
    (equilibrated split, interior Schur complement, edge-star inverses,
    GS row panels) instead of in host numpy.

    On by default wherever the default device is an accelerator; the CPU
    keeps the host f64 derivation.  ``NSTPU_DEVICE_TABLES=force`` turns it
    on everywhere (the CPU parity tests), ``0`` off."""
    mode = os.environ.get("NSTPU_DEVICE_TABLES", "1")
    if mode == "force":
        return True
    # the device new arrays land on (honours ``with jax.default_device``)
    dev = jax.config.jax_default_device or jax.devices()[0]
    return mode != "0" and dev.platform != "cpu"
