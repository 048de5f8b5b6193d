"""JAX plumbing (utils/jaxtools.py): closure hoisting and the gate of the
device-side table derivation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from navier_stokes_tpu.utils.jaxtools import device_tables_enabled, hoisted_jit


def test_hoisted_jit_matches_the_closure():
    table = jnp.asarray(np.random.default_rng(0).standard_normal((64, 64)))

    def fn(x, scale):
        return {"y": table @ x * scale, "n": jnp.sum(x)}

    x = jnp.arange(64.0)
    got = hoisted_jit(fn, x, 2.0)(x, 3.0)
    want = fn(x, 3.0)
    np.testing.assert_allclose(np.asarray(got["y"]), np.asarray(want["y"]),
                               rtol=1e-14)
    assert float(got["n"]) == float(want["n"])


def test_hoisted_jit_out_shardings():
    """Explicit output shardings (a prefix of the output tree) are kept,
    not read back from the executable."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("shard",))
    row = NamedSharding(mesh, P("shard"))
    rep = NamedSharding(mesh, P())
    table = jnp.ones(8)
    x = jax.device_put(jnp.arange(8.0), row)
    y, s = hoisted_jit(lambda v: (v * table, jnp.sum(v)), x,
                       out_shardings=(row, rep))(x)
    assert y.sharding.is_equivalent_to(row, 1)
    assert s.sharding.is_equivalent_to(rep, 0)
    assert float(s) == 28.0


@pytest.mark.parametrize("mode,want", [("force", True), ("0", False),
                                       ("1", False), (None, False)])
def test_device_tables_gate_on_the_cpu(monkeypatch, mode, want):
    """On by default only where the default device is an accelerator;
    ``force`` turns it on anywhere (the CPU parity tests), ``0`` off."""
    if mode is None:
        monkeypatch.delenv("NSTPU_DEVICE_TABLES", raising=False)
    else:
        monkeypatch.setenv("NSTPU_DEVICE_TABLES", mode)
    assert device_tables_enabled() is want
