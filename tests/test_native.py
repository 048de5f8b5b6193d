"""Native C++ meshkit kernels vs numpy/scipy references."""

import os

import numpy as np
import pytest
import scipy.sparse as sp

from navier_stokes_tpu.fem.reference import TRI_EDGES
from navier_stokes_tpu.mesh import unit_square_mesh
from navier_stokes_tpu.utils import native


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


def test_build_edges_matches_mesh():
    mesh = unit_square_mesh(0.2)
    edges, element_edges, flips = native.build_edges(mesh.elements, TRI_EDGES)
    assert len(edges) == mesh.nedge
    # same edge SET (ids are permuted first-seen vs sorted-unique)
    a = {tuple(e) for e in edges.tolist()}
    b = {tuple(e) for e in mesh.edges.tolist()}
    assert a == b
    # per-element consistency: native edge id maps to the same vertex pair
    for e in range(mesh.ne):
        for le in range(3):
            nat = tuple(edges[element_edges[e, le]])
            ref = tuple(mesh.edges[mesh.element_edges[e, le]])
            assert nat == ref
            assert bool(flips[e, le]) == bool(mesh.element_edge_flip[e, le])


def test_rcm_recovers_bandwidth_of_shuffled_graph():
    mesh = unit_square_mesh(0.1)
    rng = np.random.default_rng(0)
    shuffle = rng.permutation(mesh.nv).astype(np.int32)
    e0, e1 = shuffle[mesh.edges[:, 0]], shuffle[mesh.edges[:, 1]]
    rows = np.concatenate([e0, e1])
    cols = np.concatenate([e1, e0])
    A = sp.coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(mesh.nv, mesh.nv)
    ).tocsr()
    perm = native.rcm_ordering(A)
    assert sorted(perm.tolist()) == list(range(mesh.nv))
    inv = np.empty_like(perm)
    inv[perm] = np.arange(mesh.nv, dtype=np.int32)
    bw_shuffled = np.abs(e0.astype(int) - e1.astype(int)).max()
    bw_after = np.abs(inv[e0].astype(int) - inv[e1].astype(int)).max()
    # shuffled grid has O(n) bandwidth; RCM restores O(sqrt(n))
    assert bw_after < bw_shuffled / 3
    assert bw_after <= 3 * (round(mesh.nv**0.5) + 2)


def test_extract_blocks_matches_scipy():
    rng = np.random.default_rng(0)
    n = 60
    dense = rng.standard_normal((n, n))
    dense[np.abs(dense) < 1.2] = 0.0  # sparsify
    A = sp.csr_matrix(dense)
    blocks = -np.ones((5, 7), dtype=np.int32)
    for i in range(5):
        sz = rng.integers(2, 8)
        blocks[i, :sz] = rng.choice(n, size=sz, replace=False)
    out = native.extract_blocks_csr(A, blocks)
    for i in range(5):
        b = blocks[i][blocks[i] >= 0]
        expect = dense[np.ix_(b, b)]
        assert np.abs(out[i, : len(b), : len(b)] - expect).max() < 1e-14
        # padding stays identity
        for j in range(len(b), 7):
            assert out[i, j, j] == 1.0
            assert np.abs(out[i, j, : j]).max() == 0.0


def test_library_is_keyed_on_source_content(monkeypatch, tmp_path):
    """The built library's name follows the source's content: an edit
    gives a new name (a rebuild), a touch alone does not."""
    src = tmp_path / "meshkit.cpp"
    with open(native._SRC) as fh:
        src.write_text(fh.read())
    monkeypatch.setattr(native, "_SRC", str(src))
    first = native.library_path()
    os.utime(src, (1, 1))
    assert native.library_path() == first
    src.write_text(src.read_text() + "\n// edited\n")
    second = native.library_path()
    assert second != first
    assert os.path.dirname(second) == native.BUILD_DIR
