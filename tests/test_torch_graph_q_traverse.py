"""The card's one-launch quantized HNSW traversal, modelled on the CPU.

On the card a search of a graph that carries an SQ8 or PQ code payload is
one launch of the traversal kernel of
``src/repro_torch/kernels/csrc/graph_traverse.cuh`` with the code payload
of ``csrc/graph_beam_q.cu``: the entry seed, the descent through the upper
layers, the layer-0 beam with an expanded flag a beam slot and one "seen"
bit a node, every step scored as one ``graph_beam_q`` hop.
``graph_beam_q.ref.graph_traverse_q_ref`` is that order of work in plain
PyTorch, one query at a time. These tests hold it against the port's
batched loop of plain quantized hops (``search.hnsw.search_batched`` on the
CPU: ids and scores bit-equal, evals equal, each row's layer-0 hops equal
to the loop's hops for that row alone) and against the reference's
``search_batched(impl="jit")`` on the same codec graph (ids and evals
equal; scores within ``rtol=1e-5, atol=1e-4``, as the port sums the hop
operands in a fixed pairwise tree where XLA takes its own order, and
bit-equal on integer payloads, where every sum is exact).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
torch.set_float32_matmul_precision("highest")

import jax  # noqa: E402

from repro.search import hnsw as jax_hnsw  # noqa: E402
from repro_torch.kernels.graph_beam.ref import pairwise_sum  # noqa: E402
from repro_torch.kernels.graph_beam_q.ref import (  # noqa: E402
    graph_traverse_q_ref)
from repro_torch.search import hnsw  # noqa: E402
# the codec fixtures and helpers of the quantized graph's parity tests
from test_torch_graph_q import (  # noqa: E402,F401
    _attach, _port_codec_of, corpus, queries)

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def graphs(corpus):
    """(reference graph, port graph) of test_torch_graph_q's first case
    (seed 0, M = 8)."""
    return (jax_hnsw.build(corpus, M=8, ef_construction=30, seed=0),
            hnsw.build(corpus, M=8, ef_construction=30, seed=0))


def _traverse(g, q, k, ef, alive=None):
    """The per-query model on the graph's codec, shaped as search_batched's
    answer, plus each row's hops."""
    cdx, cpu = g.codec, torch.device("cpu")
    _, _, nbrs0, upper = g.pack().device_arrays(g.vecs, cpu)
    codes, node_bias = cdx.device_arrays(cpu)[:2]
    qt = torch.as_tensor(q)
    q_op, q_bias = cdx.query_operands(qt, pairwise_sum(qt * qt))
    bv, bi, evals, hops = graph_traverse_q_ref(
        q_op, q_bias, codes, node_bias, nbrs0, upper, g.entry, max(ef, k),
        cdx.kind, cdx.ksub,
        alive=None if alive is None else torch.as_tensor(alive))
    scores = torch.where(bi[:, :k] >= 0, bv[:, :k],
                         torch.tensor(float("-inf")))
    return scores, bi[:, :k], evals, hops


def _check(g, ref_g, q, k, ef, alive=None, integer=False, rows=(0, -1)):
    got = _traverse(g, q, k, ef, alive)
    loop = hnsw.search_batched(g, q, k, ef_search=ef, device="cpu",
                               alive=alive)
    for a, b in zip(got[:3], loop[:3]):
        assert torch.equal(a, b)
    assert int(got[3].max()) == loop[3]
    for r in rows:                           # a row's own hops
        r = r % q.shape[0]
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


@pytest.mark.parametrize("kind,ef", [("sq8", 10), ("pq", 48),
                                     ("sq8", 96)])
def test_quantized_traversal_model_equals_loop_and_reference(
        graphs, kind, ef, corpus, queries):
    ref, port = _attach(graphs, kind, corpus)
    _check(port, ref, queries, min(10, ef), ef)


@pytest.mark.parametrize("kind", ["sq8", "pq"])
def test_quantized_traversal_model_tombstones(graphs, kind, corpus, queries):
    ref, port = _attach(graphs, kind, corpus)
    alive = np.random.default_rng(2).random(ref.ntotal) > 0.3
    alive[ref.entry] = True
    _check(port, ref, queries, 10, 32, alive=alive)
    got = _traverse(port, queries, 10, 32, alive)
    assert not np.isin(got[1].numpy(), np.flatnonzero(~alive)).any()


@pytest.mark.parametrize("kind", ["sq8", "pq"])
def test_quantized_traversal_model_one_query(graphs, kind, corpus, queries):
    ref, port = _attach(graphs, kind, corpus)
    _check(port, ref, queries[7:8], 10, 40, rows=(0,))


@pytest.mark.parametrize("kind", ["sq8", "pq"])
def test_quantized_traversal_model_integer_payload_bit_equal(kind):
    """An SQ8 codec of step 1 (every dim spans 0..255) on integer queries,
    or an integer PQ codebook: every operand and score is exact, so the
    model equals the reference's jitted traversal bit for bit."""
    rng = np.random.default_rng(21)
    x = rng.integers(0, 256, (300, 8)).astype(np.float32)
    x[0], x[1] = 0.0, 255.0
    q = rng.integers(0, 256, (9, 8)).astype(np.float32)
    ref = jax_hnsw.build(x, M=4, ef_construction=20, seed=1)
    port = hnsw.build(x, M=4, ef_construction=20, seed=1)
    if kind == "sq8":
        codec = jax_hnsw.make_graph_codes(x, "sq8")
        assert (codec.step == 1.0).all()
    else:
        cb = rng.integers(0, 256, (4, 16, 2)).astype(np.float32)
        codes = rng.integers(0, 16, (300, 4)).astype(np.uint8)
        codec = jax_hnsw.GraphCodes(kind="pq", codes=codes,
                                    node_bias=np.zeros(300, np.float32),
                                    codebooks=cb)
    ref.codec = codec
    port.codec = _port_codec_of(codec)
    _check(port, ref, q, 8, 16, integer=True)


@pytest.mark.parametrize("kind", ["sq8", "pq"])
def test_quantized_traversal_model_stranded_entry(kind):
    """The graph of ROADMAP C7 (tests/test_graph.py fuzz seed 11: n=10,
    M=2, ef_construction=4): the entry has no layer-0 link, the descent
    leaves it through the upper layers, scored on the codes."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((10, 8)).astype(np.float32)
    ref = jax_hnsw.build(x, M=2, ef_construction=4, seed=11)
    port = hnsw.build(x, M=2, ef_construction=4, seed=11)
    assert np.all(port.links0[port.entry] < 0)
    ref.codec = jax_hnsw.make_graph_codes(x, kind, m=4, iters=5, seed=0)
    port.codec = _port_codec_of(ref.codec)
    for k, ef in ((5, 8), (10, 4096)):
        _check(port, ref, x[:4], k, ef, rows=(0, 1, 2, 3))
