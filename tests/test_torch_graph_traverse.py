"""The card's one-launch HNSW traversal, modelled on the CPU.

The CUDA traversal kernel (``graph_traverse_kernel`` in
``src/repro_torch/kernels/csrc/graph_beam.cu``) runs a whole search for one
query a block: the entry seed, the descent through the upper layers, the
layer-0 beam with an expanded flag a beam slot and one "seen" bit a node.
``graph_beam.ref.graph_traverse_ref`` is that order of work in plain
PyTorch, one query at a time, with the hop's arithmetic. These tests hold
it against the port's batched loop of plain hops
(``search.hnsw.search_batched`` on the CPU) and the reference's
``search_batched(impl="jit")``: ids and evals equal, and each row's
layer-0 hops equal to the loop's hops for that row alone (the batch's hops
are their maximum). Scores: bit-equal to the port's loop (the same hop
arithmetic); within ``rtol=1e-5, atol=1e-4`` of the reference's (XLA sums
in another order), bit-equal on integer corpora.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402

from repro.search import hnsw as jax_hnsw  # noqa: E402
from repro_torch.kernels.graph_beam.ref import (  # noqa: E402
    graph_traverse_ref, pairwise_sum)
from repro_torch.search import hnsw  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-4


def _traverse(g, q, k, ef, alive=None):
    """The per-query model, shaped as search_batched's answer, plus each
    row's hops."""
    vecs, vsq, nbrs0, upper = g.pack().device_arrays(g.vecs,
                                                     torch.device("cpu"))
    qt = torch.as_tensor(q)
    ef = max(ef, k)
    bv, bi, evals, hops = graph_traverse_ref(
        qt, vecs, vsq, pairwise_sum(qt * qt), nbrs0, upper, g.entry, ef,
        None if alive is None else torch.as_tensor(alive))
    scores = torch.where(bi[:, :k] >= 0, bv[:, :k],
                         torch.tensor(float("-inf")))
    return scores, bi[:, :k], evals, hops


def _check(g, ref_g, q, k, ef, alive=None, integer=False):
    got = _traverse(g, q, k, ef, alive)
    loop = hnsw.search_batched(g, q, k, ef_search=ef, device="cpu",
                               alive=alive)
    for a, b in zip(got[:3], loop[:3]):
        assert torch.equal(a, b)
    assert int(got[3].max()) == loop[3]
    for r in range(q.shape[0]):              # each row's own hops
        alone = hnsw.search_batched(g, q[r:r + 1], k, ef_search=ef,
                                    device="cpu", alive=alive)
        assert int(got[3][r]) == alone[3]
        assert torch.equal(alone[1][0], got[1][r])
    want = jax_hnsw.search_batched(ref_g, q, k, ef_search=ef, impl="jit",
                                   alive=alive)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert int(got[3].max()) == want[3]
    if integer:
        np.testing.assert_array_equal(got[0].numpy(), want[0])
    else:
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=RTOL,
                                   atol=ATOL)


@pytest.fixture(scope="module")
def graphs():
    """(reference graph, port graph, queries) over 400 clustered points,
    M = 6."""
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 8)) * 3
    x = (centers[rng.integers(0, 4, 400)]
         + rng.normal(size=(400, 8))).astype(np.float32)
    q = (x[rng.integers(0, 400, 6)]
         + 0.05 * rng.normal(size=(6, 8))).astype(np.float32)
    return (jax_hnsw.build(x, M=6, ef_construction=30, seed=2),
            hnsw.build(x, M=6, ef_construction=30, seed=2), q)


@pytest.mark.parametrize("ef", [1, 10, 64, 4096])
def test_traversal_model_equals_loop_and_reference(graphs, ef):
    ref_g, g, q = graphs
    assert g.max_level >= 1
    _check(g, ref_g, q, min(10, ef), ef)


def test_traversal_model_tombstones(graphs):
    ref_g, g, q = graphs
    alive = np.random.default_rng(1).random(g.ntotal) > 0.3
    alive[g.entry] = True
    _check(g, ref_g, q, 10, 40, alive=alive)
    got = _traverse(g, q, 10, 40, alive)
    assert not np.isin(got[1].numpy(), np.flatnonzero(~alive)).any()


def test_traversal_model_one_query(graphs):
    ref_g, g, q = graphs
    _check(g, ref_g, q[2:3], 10, 40)


def test_traversal_model_integer_corpus_bit_equal():
    rng = np.random.default_rng(21)
    x = rng.integers(-3, 4, (300, 6)).astype(np.float32)
    q = rng.integers(-3, 4, (5, 6)).astype(np.float32)
    _check(hnsw.build(x, M=4, ef_construction=20, seed=1),
           jax_hnsw.build(x, M=4, ef_construction=20, seed=1), q, 8, 16,
           integer=True)


def test_traversal_model_stranded_entry():
    """The graph of ROADMAP C7 (tests/test_graph.py fuzz seed 11: n=10,
    M=2, ef_construction=4): the entry has no layer-0 link, the descent
    leaves it through the upper layers."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((10, 8)).astype(np.float32)
    g = hnsw.build(x, M=2, ef_construction=4, seed=11)
    assert np.all(g.links0[g.entry] < 0)
    _check(g, jax_hnsw.build(x, M=2, ef_construction=4, seed=11), x[:4], 5,
           8)
    _check(g, jax_hnsw.build(x, M=2, ef_construction=4, seed=11), x[:4], 10,
           4096)
