"""Every f32 product of the solve and the time step runs at full f32.

On a GPU, XLA may run an f32 dot in TF32 (about 10 mantissa bits) unless
the dot asks for HIGHEST precision.  The split hi+lo f32 operator of the
refinement solve then loses the f64-level accuracy it exists to carry.
The package sets the default matmul precision once, at import
(navier_stokes_tpu/__init__.py); this guard reads the traced programs and
so catches TF32 without a GPU.
"""

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.mesh import channel_with_cylinder_mesh_3d
from navier_stokes_tpu.models.navier_stokes_mcs import NavierStokesMCS
from navier_stokes_tpu.solvers.refinement import equilibrated_f32_ops

H = 0.41
HIGHEST = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)


def _uin(p):
    out = np.zeros((len(p), 3))
    out[:, 0] = 16 * p[:, 1] * (H - p[:, 1]) * p[:, 2] * (H - p[:, 2]) / H**4
    return out


def _model(mesh, dtype):
    return NavierStokesMCS(
        mesh, nu=1e-3, inflow="inlet", outflow="outlet", wall="wall|cyl",
        uin=_uin, timestep=2e-3, order=2, dtype=dtype,
        preconditioner="faceblock",
    )


def _subjaxprs(params):
    for v in params.values():
        for item in (v if isinstance(v, (list, tuple)) else (v,)):
            if isinstance(item, jax.extend.core.ClosedJaxpr):
                yield item.jaxpr
            elif isinstance(item, jax.extend.core.Jaxpr):
                yield item


def _dots(jaxpr):
    """(operand dtypes, precision) of every dot_general, sub-programs
    (loops, branches, nested jits) included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield ([str(v.aval.dtype) for v in eqn.invars],
                   eqn.params["precision"])
        for sub in _subjaxprs(eqn.params):
            yield from _dots(sub)


@pytest.fixture(scope="module")
def programs():
    """name -> (fn, example args) for the f32 operators of the phase-1
    solve and the f32 transient step."""
    mesh = channel_with_cylinder_mesh_3d(0.6)
    m64 = _model(mesh, jnp.float64)
    ops32, _ = equilibrated_f32_ops(m64, gs=True, split=True)
    u = jnp.zeros(m64.n, jnp.float32)
    p = jnp.zeros(m64.Q.ndof, jnp.float32)
    progs = {
        "A": (ops32["A"], u), "B": (ops32["B"], u), "BT": (ops32["BT"], p),
        "preA": (ops32["preA"], u), "preM": (ops32["preM"], p),
    }
    m32 = _model(mesh, jnp.float32)
    progs["step"] = (m32.make_step_fn(project_tol=1e-5), m32.u)
    return progs


@pytest.mark.parametrize("name", ["A", "B", "BT", "preA", "preM", "step"])
def test_f32_dots_run_at_highest_precision(programs, name):
    fn, x = programs[name]
    dots = list(_dots(jax.make_jaxpr(fn)(x).jaxpr))
    f32 = [(dt, prec) for dt, prec in dots if "float32" in dt]
    if name != "preM":  # preM is a diagonal scaling: no products
        assert f32, f"no f32 dot_general traced in {name}"
    low = [(dt, prec) for dt, prec in f32 if prec != HIGHEST]
    assert not low, f"{name}: f32 dots below HIGHEST precision: {low[:3]}"
