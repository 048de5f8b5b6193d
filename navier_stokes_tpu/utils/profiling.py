"""Profiling hooks: the TaskManager(pajetrace=...) equivalent.

The reference captures Paje traces via NGSolve's TaskManager gated on a -p
flag (run.py:218-219,239).  The JAX equivalent is jax.profiler.trace; scopes
can be annotated with jax.named_scope inside jitted code.
"""

from __future__ import annotations

import contextlib
import os

# default trace directory: inside the checkout (listed in .gitignore)
DEFAULT_LOGDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "profiles")


@contextlib.contextmanager
def maybe_profile(enabled: bool, logdir: str = DEFAULT_LOGDIR):
    """Capture a jax.profiler trace when enabled, else no-op."""
    if not enabled:
        yield
        return
    import jax

    os.makedirs(logdir, exist_ok=True)
    with jax.profiler.trace(logdir):
        yield
    print(f"profile trace written to {logdir}")
