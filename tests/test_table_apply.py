"""The batched table apply (ops/table_apply.py) against numpy.

Every hot stream of the flagship solve goes through ``make_table_apply``:
the element operator, the harmonic extension and interior solve, the
skeleton operator, the GS row panels (transposed vectors) and the merged
edge-star inverses.  The stored table is the reference: a bf16-stored
table is compared with its bf16-rounded values in f64, so the bound is
the f32 arithmetic's, not the storage rounding's.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

from navier_stokes_tpu.ops.table_apply import make_table_apply

NBLK = 37  # deliberately odd

SHAPES = [(14, 14), (6, 14), (14, 9)]  # square, wide, tall (m, k)


def _stored(A, store_dtype):
    if store_dtype == "bf16":
        return A.astype(ml_dtypes.bfloat16).astype(np.float64)
    return A.astype(np.float64)


@pytest.mark.parametrize("soa_io", [False, True], ids=["aos", "soa"])
@pytest.mark.parametrize("store_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,k", SHAPES)
def test_table_apply_matches_numpy(m, k, store_dtype, soa_io):
    rng = np.random.default_rng(m * 100 + k)
    A = rng.standard_normal((NBLK, m, k)).astype(np.float32)
    sdt = jnp.bfloat16 if store_dtype == "bf16" else jnp.float32
    fn = make_table_apply(A, store_dtype=sdt, soa_io=soa_io)
    T64 = _stored(A, store_dtype)
    if soa_io:
        x = rng.standard_normal((k, NBLK)).astype(np.float32)
        want = np.einsum("bmk,kb->mb", T64, x.astype(np.float64))
        shape = (m, NBLK)
    else:
        x = rng.standard_normal((NBLK, k)).astype(np.float32)
        want = np.einsum("bmk,bk->bm", T64, x.astype(np.float64))
        shape = (NBLK, m)
    got = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    assert got.shape == shape and got.dtype == np.float32
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err < 1e-6, err


def test_table_apply_f64_storage_keeps_f64():
    """An f64-stored table applied to an f64 vector stays f64 end to end
    (the aux-space coarse transfer of the f64 model); the cast is made
    straight from the source dtype, with no f32 detour."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((NBLK, 9, 12))
    x = rng.standard_normal((NBLK, 12))
    fn = make_table_apply(A, store_dtype=jnp.float64)
    got = np.asarray(fn(jnp.asarray(x)))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, np.einsum("bmk,bk->bm", A, x),
                               rtol=1e-13, atol=1e-13)


def test_table_apply_device_table_is_cast_once():
    """A device-array table (the device-derived preconditioner tables) is
    cast to the storage dtype at build time, like a host table."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((NBLK, 6, 6)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((NBLK, 6)).astype(np.float32))
    host = make_table_apply(A, store_dtype=jnp.bfloat16)
    dev = make_table_apply(jnp.asarray(A), store_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(np.asarray(host(x)), np.asarray(dev(x)))
    jaxpr = jax.make_jaxpr(dev)(x)
    (tab,) = jaxpr.consts
    assert tab.dtype == jnp.bfloat16
