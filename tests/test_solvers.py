"""Krylov solvers validated against dense numpy solves (SURVEY.md section 4:
'each Krylov solver on small SPD/saddle dense systems vs numpy.linalg')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navier_stokes_tpu.linalg import lanczos_eigenvalues
from navier_stokes_tpu.solvers import bpcg
from navier_stokes_tpu.solvers import (
    bramble_pasciak_cg,
    bramble_pasciak_cg_opt,
    cg,
    minres,
)


@pytest.fixture(scope="module")
def spd_system():
    rng = np.random.default_rng(1)
    n = 60
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    b = rng.standard_normal(n)
    return A, b, np.linalg.solve(A, b)


@pytest.fixture(scope="module")
def saddle_system():
    rng = np.random.default_rng(2)
    nu, m = 50, 20
    Q = rng.standard_normal((nu, nu))
    A = Q @ Q.T + nu * np.eye(nu)
    B = rng.standard_normal((m, nu))
    K = np.block([[A, B.T], [B, np.zeros((m, m))]])
    f, g = rng.standard_normal(nu), rng.standard_normal(m)
    sol = np.linalg.solve(K, np.concatenate([f, g]))
    return A, B, f, g, sol


def test_cg(spd_system):
    A, b, xref = spd_system
    r = cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), tol=1e-12, maxsteps=500)
    assert bool(r.converged)
    assert np.abs(np.asarray(r.x) - xref).max() < 1e-8
    errs = np.asarray(r.errors)
    assert errs[0] == 1.0
    assert np.isnan(errs[int(r.iterations) + 1])  # history masked past convergence


def test_pcg_jacobi(spd_system):
    A, b, xref = spd_system
    pre = lambda x: x / jnp.asarray(np.diag(A))
    r = cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), pre=pre, tol=1e-12,
           maxsteps=500)
    assert np.abs(np.asarray(r.x) - xref).max() < 1e-8


def test_lanczos_extreme_eigenvalues(spd_system):
    A, b, _ = spd_system
    d = np.diag(A)
    pre = lambda x: x / jnp.asarray(d)
    lams = np.asarray(
        lanczos_eigenvalues(lambda x: jnp.asarray(A) @ x, pre, jnp.asarray(b), 50)
    )
    s = 1 / np.sqrt(d)
    exact = np.linalg.eigvalsh(s[:, None] * A * s[None, :])
    assert abs(lams.max() - exact.max()) / exact.max() < 1e-6
    assert abs(lams.min() - exact.min()) / exact.min() < 0.05


def test_minres_indefinite():
    rng = np.random.default_rng(3)
    n = 60
    D = np.diag(np.concatenate([np.linspace(1, 10, 40), -np.linspace(1, 5, 20)]))
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    S = U @ D @ U.T
    b = rng.standard_normal(n)
    xs = np.linalg.solve(S, b)
    r = minres(lambda x: jnp.asarray(S) @ x, jnp.asarray(b), tol=1e-12, maxsteps=500)
    assert np.abs(np.asarray(r.x) - xs).max() < 1e-7


def test_minres_traced_tolerance():
    """tol may be a traced jit argument (the bench's adaptive last-pass
    tolerance passes it through hoisted_jit): looser traced tol stops
    earlier, same-value traced tol matches the python-float run."""
    rng = np.random.default_rng(5)
    n = 60
    D = np.diag(np.concatenate([np.linspace(1, 10, 40), -np.linspace(1, 5, 20)]))
    U, _ = np.linalg.qr(rng.standard_normal((n, n)))
    S = U @ D @ U.T
    b = rng.standard_normal(n)
    mat = lambda x: jnp.asarray(S) @ x

    run = jax.jit(lambda tl: minres(mat, jnp.asarray(b), tol=tl, maxsteps=500))
    r_ref = minres(mat, jnp.asarray(b), tol=1e-10, maxsteps=500)
    r_same = run(jnp.asarray(1e-10))
    assert int(r_same.iterations) == int(r_ref.iterations)
    np.testing.assert_array_equal(np.asarray(r_same.x), np.asarray(r_ref.x))
    r_loose = run(jnp.asarray(1e-3))
    assert bool(r_loose.converged)
    assert int(r_loose.iterations) < int(r_ref.iterations)


def _saddle_ops(A, B):
    Afn = lambda x: jnp.asarray(A) @ x
    Bfn = lambda x: jnp.asarray(B) @ x
    BTfn = lambda x: jnp.asarray(B.T) @ x
    preA = lambda x: x / jnp.asarray(np.diag(A))
    Md = B @ np.linalg.inv(A) @ B.T
    preM = lambda x: x / jnp.asarray(np.diag(Md))
    return Afn, Bfn, BTfn, preA, preM


def test_bpcg_v1(saddle_system):
    A, B, f, g, sol = saddle_system
    nu = len(f)
    Afn, Bfn, BTfn, preA, preM = _saddle_ops(A, B)
    r = bramble_pasciak_cg(Afn, Bfn, BTfn, preA, preM, jnp.asarray(f),
                           jnp.asarray(g), tol=1e-12, max_steps=2000)
    assert bool(r.converged)
    err = max(
        np.abs(np.asarray(r.x[0]) - sol[:nu]).max(),
        np.abs(np.asarray(r.x[1]) - sol[nu:]).max(),
    )
    assert err < 1e-7


def test_bpcg_v2_matches_v1(saddle_system):
    A, B, f, g, sol = saddle_system
    nu = len(f)
    Afn, Bfn, BTfn, preA, preM = _saddle_ops(A, B)
    r1 = bramble_pasciak_cg(Afn, Bfn, BTfn, preA, preM, jnp.asarray(f),
                            jnp.asarray(g), tol=1e-12, max_steps=2000)
    r2 = bramble_pasciak_cg_opt(Afn, Bfn, BTfn, preA, preM, jnp.asarray(f),
                                jnp.asarray(g), tol=1e-12, maxsteps=2000)
    err = max(
        np.abs(np.asarray(r2.x[0]) - sol[:nu]).max(),
        np.abs(np.asarray(r2.x[1]) - sol[nu:]).max(),
    )
    assert err < 1e-7
    # the optimized recurrence is the same Krylov process
    assert abs(int(r1.iterations) - int(r2.iterations)) <= 2


def test_block_minres_saddle(saddle_system):
    A, B, f, g, sol = saddle_system
    nu = len(f)
    Afn, Bfn, BTfn, preA, preM = _saddle_ops(A, B)
    mat = lambda x: (Afn(x[0]) + BTfn(x[1]), Bfn(x[0]))
    pre = lambda x: (preA(x[0]), preM(x[1]))
    r = minres(mat, (jnp.asarray(f), jnp.asarray(g)), pre=pre, tol=1e-12,
               maxsteps=2000)
    err = max(
        np.abs(np.asarray(r.x[0]) - sol[:nu]).max(),
        np.abs(np.asarray(r.x[1]) - sol[nu:]).max(),
    )
    assert err < 1e-6


def test_deterministic_histories(spd_system):
    """Pure-JAX determinism: same input -> bitwise-equal error histories."""
    A, b, _ = spd_system
    r1 = cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), tol=1e-10, maxsteps=200)
    r2 = cg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b), tol=1e-10, maxsteps=200)
    e1, e2 = np.asarray(r1.errors), np.asarray(r2.errors)
    assert np.array_equal(e1[~np.isnan(e1)], e2[~np.isnan(e2)])


def test_bpcg_opt_chunked_resume_is_exact():
    """Chunked execution with resume state reproduces the one-shot solve
    bitwise, so a caller can bound the length of one device execution
    without a restart penalty."""
    rng = np.random.default_rng(0)
    n, m = 60, 20
    Q = rng.standard_normal((n, n))
    Amat = Q @ Q.T + n * np.eye(n)
    Bmat = rng.standard_normal((m, n))
    Aj, Bj = jnp.asarray(Amat), jnp.asarray(Bmat)
    A = lambda u: Aj @ u
    B = lambda u: Bj @ u
    BT = lambda p: Bj.T @ p
    d = jnp.asarray(1.0 / np.diag(Amat))
    preA = lambda u: d * u
    preM = lambda p: p
    f = jnp.asarray(rng.standard_normal(n))
    g = jnp.asarray(rng.standard_normal(m))
    k, _ = bpcg.bp_scale_factor(A, preA, f)
    one = bpcg.bramble_pasciak_cg_opt(
        A, B, BT, preA, preM, f, g, tol=1e-10, maxsteps=500, scale_k=float(k)
    )
    res, st = bpcg.bramble_pasciak_cg_opt(
        A, B, BT, preA, preM, f, g, tol=1e-10, maxsteps=500,
        scale_k=float(k), return_state=True, max_new_iterations=15,
    )
    while not bool(res.converged):
        res, st = bpcg.bramble_pasciak_cg_opt(
            A, B, BT, preA, preM, f, g, tol=1e-10, maxsteps=500,
            scale_k=float(k), resume=st, return_state=True,
            max_new_iterations=15,
        )
    assert int(res.iterations) == int(one.iterations)
    assert float(jnp.abs(res.x[0] - one.x[0]).max()) == 0.0
