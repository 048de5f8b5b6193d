"""Loader for the native C++ setup kernels (meshkit), with numpy fallback.

Compiles navier_stokes_tpu/native/meshkit.cpp on first use with g++ and
binds it through ctypes — the native runtime layer of the framework (the
role NGSolve's C++ core plays for the reference, SURVEY.md section 2b),
while JAX/XLA remains the device compute path.  The library is built into
``native/_build/`` (listed in ``.gitignore``) under a name keyed on the
SHA-256 of the source, so an edited source or a fresh checkout always
rebuilds and a stale binary is never loaded.  Every entry point degrades
gracefully to numpy/scipy when the toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import warnings

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE_DIR, "meshkit.cpp")
BUILD_DIR = os.path.join(_NATIVE_DIR, "_build")

_LIB = None
_TRIED = False


def library_path() -> str:
    """Path of the shared library built from the current source."""
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"meshkit_{digest}.so")


def _build(so: str) -> None:
    """Compile to a temporary file in BUILD_DIR, then rename it into place:
    concurrent first uses (test workers) never load a half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
            check=True, capture_output=True,
        )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        lib.build_edges.restype = ctypes.c_int64
        lib.build_edges.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.rcm_ordering.restype = None
        lib.rcm_ordering.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p
        ]
        lib.extract_blocks.restype = None
        lib.extract_blocks.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _LIB = lib
    except Exception as e:  # pragma: no cover - toolchain-dependent
        warnings.warn(f"meshkit native kernels unavailable ({e}); numpy fallback")
        _LIB = None
    return _LIB


def available() -> bool:
    return _lib() is not None


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def build_edges(elements: np.ndarray, local_edges) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(edges (nedge,2), element_edges (ne,nle), flips (ne,nle)).

    Native hash-map path; edge ids are first-seen order (opaque)."""
    lib = _lib()
    elements = np.ascontiguousarray(elements, dtype=np.int32)
    le = np.ascontiguousarray(np.asarray(local_edges, dtype=np.int32))
    ne, npe = elements.shape
    nle = len(le)
    element_edges = np.empty((ne, nle), dtype=np.int32)
    flips = np.empty((ne, nle), dtype=np.uint8)
    edges_buf = np.empty((ne * nle, 2), dtype=np.int32)
    if lib is None:
        raise RuntimeError("native meshkit not available")
    nedge = lib.build_edges(
        ne, npe, _ptr(elements), nle, _ptr(le),
        _ptr(element_edges), _ptr(flips), _ptr(edges_buf),
    )
    return edges_buf[:nedge].copy(), element_edges, flips.astype(bool)


def rcm_ordering(adj_csr) -> np.ndarray:
    """Reverse Cuthill-McKee permutation of a scipy CSR adjacency matrix."""
    lib = _lib()
    n = adj_csr.shape[0]
    if lib is None:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        return np.asarray(reverse_cuthill_mckee(adj_csr.tocsr()), dtype=np.int32)
    indptr = np.ascontiguousarray(adj_csr.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(adj_csr.indices, dtype=np.int32)
    perm = np.empty(n, dtype=np.int32)
    lib.rcm_ordering(n, _ptr(indptr), _ptr(indices), _ptr(perm))
    return perm


def extract_blocks_csr(A_csr, blocks_padded: np.ndarray) -> np.ndarray:
    """(nblocks, bmax, bmax) dense sub-blocks of CSR matrix A; padding
    rows/cols are identity.  ``blocks_padded``: (nblocks, bmax) int32,
    -1-padded."""
    lib = _lib()
    nblocks, bmax = blocks_padded.shape
    out = np.tile(np.eye(bmax), (nblocks, 1, 1))
    if lib is None:
        A = A_csr.tocsc()
        for i in range(nblocks):
            b = blocks_padded[i]
            b = b[b >= 0]
            out[i, : len(b), : len(b)] = A[b][:, b].toarray()
        return out
    A = A_csr.tocsr()
    indptr = np.ascontiguousarray(A.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(A.indices, dtype=np.int32)
    data = np.ascontiguousarray(A.data, dtype=np.float64)
    blocks = np.ascontiguousarray(blocks_padded, dtype=np.int32)
    lib.extract_blocks(
        A.shape[0], _ptr(indptr), _ptr(indices), _ptr(data),
        nblocks, bmax, _ptr(blocks), _ptr(out),
    )
    return out
